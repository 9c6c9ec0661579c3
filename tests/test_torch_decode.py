"""Serving in the port against the JAX reference, on the CPU at tp 1: the
ring KV cache, attention over absolute positions, prefill plus cached
decode equal to the forward pass, the port's decode against the
reference's on the same weights, and the reference's serve-window fault.

Tolerances (measured here on the reduced configs, bf16 weights):

* ``attention_at`` against ``blockwise_attention`` (512-key online
  softmax) on bf16 outputs up to 0.2: 2^-10 = 9.8e-4 at most, one bf16
  ulp there (the online form rounds each block's probabilities to bf16
  before its rescale); ATTN_ATOL is twice that;
* the port's decode against its own forward: 0.0 on llama2-400m and
  gemma2 (whose decode soft-caps its bf16 logits op by op, as XLA does),
  0.0078 (one bf16 ulp) on one reduced mamba2 logit, where the single
  SSD step and the chunked scan add in other orders; the reference's own
  tests allow 3e-2 and 5e-2, kept here;
* the port against the reference on the same weights and tokens, logits
  of order 4: 0.148 (zamba2) and 0.105 (mamba2) at most, whose mixers
  amplify bf16 rounding, 0.012-0.078 on the others; XREF_ATOL is 0.2.
  The two packages' matmuls and bf16 roundings differ, not the caches:
  each package's decode equals its own forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core.flatparam import MeshTopo as JTopo
from repro.core.flatparam import ServeStore as JStore
from repro.core.flatparam import init_serve_params_local, serve_param_specs
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import build_model as jbuild_model
from repro.models import common as JC
from repro.models import transformer as JTF
from repro_torch import interop
from repro_torch.configs.base import ArchConfig, get_arch, reduced
from repro_torch.core import flatparam as FP
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as C
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TF
from test_torch_tp_train import ROUTE_TIE, _route_margin

ATTN_ATOL = 2e-3
XREF_ATOL = 0.2
SWA_ATOL, ARCH_ATOL = 3e-2, 5e-2   # tests/test_decode_consistency.py's
XREF_ARCHS = ("llama2-400m", "h2o-danube-1.8b", "gemma2-27b",
              "deepseek-v3-moe", "mamba2-2.7b", "zamba2-2.7b",
              "whisper-small")
B, N = 2, 4   # rows, decode steps


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

CACHE_CASES = {  # window, the lengths appended in turn
    "sq_lt_w": (8, [5, 1, 1, 1, 1]),
    "sq_eq_w": (8, [8, 1]),
    "sq_gt_w": (8, [13, 1]),
    "wrap_single": (6, [4] + [1] * 9),
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_kvcache_append_is_the_references(case):
    """k, v and pos bit for bit after every append, wraps included."""
    W, lens = CACHE_CASES[case]
    rng = np.random.default_rng(0)
    ref = JC.KVCache.create(2, W, 3, 4)
    port = C.KVCache.create(2, W, 3, 4, "cpu")
    start = 0
    for n in lens:
        k = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
        v = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
        ref = ref.append(jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), jnp.int32(start))
        port.append(_bf16(k), _bf16(v), start)
        start += n
        np.testing.assert_array_equal(_np(port.k),
                                      np.asarray(ref.k, np.float32))
        np.testing.assert_array_equal(_np(port.v),
                                      np.asarray(ref.v, np.float32))
        np.testing.assert_array_equal(port.pos.numpy(), np.asarray(ref.pos))
    assert start > W  # every case wraps the ring by its end


# ---------------------------------------------------------------------------
# attention over absolute positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq", [1, 7])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, None),
                                            (None, 5.0), (300, 5.0)])
def test_attention_at_is_blockwise_attention(sq, window, softcap):
    """Against the reference's 512-key online softmax over 1,024 slots, a
    quarter of them empty (-1), the positions a ring's (not sorted)."""
    rng = np.random.default_rng(1)
    Sk, H, hd = 1024, 4, 16
    q, k, v = (rng.standard_normal((2, s, H, hd)).astype(np.float32)
               for s in (sq, Sk, Sk))
    k_pos = rng.permutation(Sk) + 200
    k_pos[rng.random(Sk) < 0.25] = -1
    q_pos = np.arange(1000, 1000 + sq)
    want = JC.blockwise_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(q_pos, jnp.int32),
        jnp.asarray(k_pos, jnp.int32), window=window, softcap=softcap)
    got = C.attention_at(_bf16(q), _bf16(k), _bf16(v),
                         torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                         window=window, softcap=softcap)
    # outputs are bf16: compare within ATTN_ATOL plus one bf16 ulp
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ATTN_ATOL)
    m, l, acc = C.attention_at(_bf16(q), _bf16(k), _bf16(v),
                               torch.from_numpy(q_pos),
                               torch.from_numpy(k_pos), window=window,
                               softcap=softcap, return_stats=True)
    out = (acc / l[..., None]).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), _np(got), rtol=2**-8, atol=1e-6)


# ---------------------------------------------------------------------------
# the port alone: prefill + decode equal the forward pass
# ---------------------------------------------------------------------------

CP_CFG = ArchConfig(
    name="cp-test", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=128, source="test")
SWA_CFG = dataclasses.replace(CP_CFG, name="swa-test", n_kv_heads=2,
                              attn_kind="swa", window=8)


def _port_consistency(cfg, S: int, window: int):
    """Forward over S + 1 tokens against prefill of S then one decode
    step (the reference test's ``_consistency``, port alone at tp 1):
    (forward's last logits, the decode's), f32."""
    groups = tsteps.model_groups(cfg, 1)
    params = FP.init_serve_params(groups, 1, 0, torch.device("cpu"), 0)
    store = FP.ServeStore(groups, params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, S + 1)))
    model = tsteps.build_model(cfg, 1)
    with torch.inference_mode():
        full, _ = model.forward(store, tokens, remat=False)
        state = TF.init_decode_state(cfg, 1, 2, window, "cpu")
        model.prefill(store, tokens[:, :S], state)
        dec, _ = model.decode_step(store, state, tokens[:, S:])
    return _np(full[:, -1]), _np(dec[:, 0])


def test_swa_ring_cache_decode_matches_forward():
    a, b = _port_consistency(SWA_CFG, S=20, window=21)  # ring of 8 wrapped
    np.testing.assert_allclose(a, b, atol=SWA_ATOL)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "gemma2-27b"])
def test_arch_decode_matches_forward(arch):
    a, b = _port_consistency(reduced(get_arch(arch)), S=12, window=13)
    np.testing.assert_allclose(a, b, atol=ARCH_ATOL)


# ---------------------------------------------------------------------------
# the port against the reference, on the reference's serving weights
# ---------------------------------------------------------------------------

def _ref_params(jcfg, seed: int = 0):
    mesh = make_local_mesh(dp=1, tp=1)
    topo = JTopo.from_mesh(mesh)
    groups = jbuild_model(jcfg, 1).groups()
    pspecs = serve_param_specs(groups, topo)
    init = jax.jit(jax.shard_map(
        lambda k: init_serve_params_local(groups, k, topo), mesh=mesh,
        in_specs=(P(),), out_specs=pspecs, check_vma=False))
    return mesh, topo, groups, pspecs, init(jax.random.PRNGKey(seed))


def reference_serve(arch: str, S: int, window: int, n: int = N):
    """The reference at tp 1 on reduced ``arch``: its serving weights
    (numpy), the inputs, its forward logits over the S + n tokens (an
    encoder-decoder: its decoder over n tokens after the encoder), its
    prefill logits (all S positions; an encoder-decoder: none) and its n
    teacher-forced decode steps' logits, all f32 numpy."""
    jcfg = jreduced(jget_arch(arch))
    mesh, topo, groups, pspecs, params = _ref_params(jcfg)
    model = jbuild_model(jcfg, 1)
    rng = np.random.default_rng(2)
    if jcfg.enc_dec:
        inputs = {"frames": rng.standard_normal(
            (B, S, jcfg.d_model)).astype(np.float32),
                  "tokens": np.concatenate([np.zeros((B, 1), np.int64),
                                            rng.integers(0, jcfg.vocab,
                                                         (B, n - 1))], 1)}
    else:
        inputs = {"tokens": rng.integers(0, jcfg.vocab, (B, S + n))}

    def body(params, frames, tokens):
        store = JStore(groups, params, topo)
        outs = []
        if jcfg.enc_dec:
            memory = model.encode(store, frames.astype(jnp.bfloat16),
                                  remat=False)
            full = model.decode_seq(store, memory, tokens, remat=False)
            st = model.init_decode_state(memory, B, window)
            pre = full[:, :0]
            steps = range(n)
        else:
            full, _, _ = model.forward(store, tokens, remat=False)
            st = JTF.init_decode_state(jcfg, 1, B, window)
            pre, _, st = model.forward(store, tokens[:, :S], caches=st,
                                       remat=False)
            steps = range(S, S + n)
        for i in steps:
            lg, st = model.decode_step(store, st, tokens[:, i:i + 1])
            outs.append(lg[:, 0])
        return full, pre, jnp.stack(outs, 1)

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(pspecs, P(), P()),
                               out_specs=(P(),) * 3, check_vma=False))
    frames = jnp.asarray(inputs.get("frames", np.zeros(1, np.float32)))
    out = fn(params, frames, jnp.asarray(inputs["tokens"], jnp.int32))
    return (jax.tree.map(np.asarray, params), inputs,
            [np.asarray(a, np.float32) for a in out])


def port_serve(arch: str, params, inputs, S: int, window: int, n: int = N,
               routes: list | None = None):
    """The port on the same weights and inputs: (forward, prefill, decode)
    logits as :func:`reference_serve` returns them.  ``routes`` collects
    each decode step's router logits (MoE)."""
    cfg = reduced(get_arch(arch))
    groups = tsteps.model_groups(cfg, 1)
    store = FP.ServeStore(groups, interop.serve_from_reference(
        params, groups=groups))
    tokens = torch.from_numpy(inputs["tokens"])
    outs = []
    with tmesh.dp_group(torch.device("cpu")), torch.inference_mode():
        model = tsteps.build_model(cfg, 1, model_group=tmesh.model_group(1))
        if cfg.enc_dec:
            memory = model.encode(store, _bf16(inputs["frames"]),
                                  remat=False)
            full = model.decode_seq(store, memory, tokens, remat=False)
            st = model.init_decode_state(memory, B, window)
            pre = full[:, :0]
            steps = range(n)
        else:
            full, _ = model.forward(store, tokens, remat=False)
            st = TF.init_decode_state(cfg, 1, B, window, "cpu")
            pre, st = model.prefill(store, tokens[:, :S], st)
            steps = range(S, S + n)
        for i in steps:
            if routes is not None:
                routes.append([])
            lg, st = model.decode_step(store, st, tokens[:, i:i + 1])
            outs.append(lg[:, 0])
    return [_np(a) for a in (full, pre, torch.stack(outs, 1))]


XREF_CASES = {arch: (64 if arch == "h2o-danube-1.8b" else 12)
              for arch in XREF_ARCHS}   # prompt: h2o-danube's wraps 64


@pytest.fixture
def recording_routes(monkeypatch):
    """Each port ``moe.route`` call's router logits, in the list of the
    decode step it ran in."""
    steps: list = []
    route = TMOE.route

    def recording(x2d, w, *a):
        if steps:
            steps[-1].append((x2d.float() @ w.float()).numpy())
        return route(x2d, w, *a)

    monkeypatch.setattr(TMOE, "route", recording)
    return steps


@pytest.mark.parametrize("arch", XREF_ARCHS)
def test_decode_is_the_references(arch, recording_routes):
    """Prefill plus N teacher-forced decode steps on the reference's
    weights and tokens, the cache sized to the whole generation: the
    prefill's and every step's logits within XREF_ATOL of the reference's.
    On the MoE a decode row may leave it only from a step where the port
    routes one of that row's tokens by a near tie (a routing margin under
    ROUTE_TIE, tests/test_torch_tp_train.py), as 1-ulp bf16 differences
    can send it to other experts."""
    S = XREF_CASES[arch]
    W = S + N if arch != "whisper-small" else N
    params, inputs, (rf, rp, rd) = reference_serve(arch, S, W)
    pf, pp, pd = port_serve(arch, params, inputs, S, W,
                            routes=recording_routes)
    np.testing.assert_allclose(pf, rf, atol=XREF_ATOL)
    np.testing.assert_allclose(pp, rp, atol=XREF_ATOL)
    gap = np.abs(pd - rd).max(-1)                          # (B, N)
    if arch == "deepseek-v3-moe":
        cfg = reduced(get_arch(arch))
        tie = np.zeros((B, N), bool)
        for i, calls in enumerate(recording_routes):
            for lg in calls:
                tie[:, i:] |= (_route_margin(lg, cfg) < ROUTE_TIE)[:, None]
        assert not tie[:, 0].all(), "every row ties from step 0"
        assert (gap[~tie] <= XREF_ATOL).all(), (gap, tie)
    else:
        assert (gap <= XREF_ATOL).all(), gap
    if arch == "h2o-danube-1.8b":
        assert S + N > reduced(get_arch(arch)).window  # the ring wrapped


# whisper's serving encoder over 1,100 frames: 512-key blocks, the last of
# 76; the reference's blocks there are 4 keys (its halving rule)
WHISPER_LONG_FRAMES = 1100
# the multi-block encoder against the one-block one, bf16 memory of order
# 5: at most 1/64 of its largest |value|, two bf16 ulps there (measured:
# 0.0469 of 4.78, 46% of the values differ; each block rounds its
# probabilities to bf16 against another running max)
ENC_BLOCKS_RTOL = 1 / 64


def test_whisper_long_encoder_is_the_references():
    """Reduced whisper-small served on 1,100 frames (the encoder's
    self-attention in three blocks, the last ragged): its memory within
    XREF_ATOL of the reference's ``EncDecLM.encode``, the prefill (the
    start token's step) and the next decode steps, teacher-forced, within
    XREF_ATOL of the reference's ``decode_step``, as is the decoder over
    them; and the encoder in one block (what training takes) within
    ENC_BLOCKS_RTOL of the multi-block one."""
    S = WHISPER_LONG_FRAMES
    params, inputs, (rf, _, rd) = reference_serve("whisper-small", S, N)
    pf, _, pd = port_serve("whisper-small", params, inputs, S, N)
    np.testing.assert_allclose(pf, rf, rtol=0, atol=XREF_ATOL)
    np.testing.assert_allclose(pd, rd, rtol=0, atol=XREF_ATOL)

    jcfg = jreduced(jget_arch("whisper-small"))
    mesh, topo, jgroups, pspecs, _ = _ref_params(jcfg)
    jmodel = jbuild_model(jcfg, 1)
    encode = jax.jit(jax.shard_map(
        lambda p, f: jmodel.encode(JStore(jgroups, p, topo),
                                   f.astype(jnp.bfloat16), remat=False),
        mesh=mesh, in_specs=(pspecs, P()), out_specs=P(), check_vma=False))
    want = np.asarray(encode(params, jnp.asarray(inputs["frames"])),
                      np.float32)
    cfg = reduced(get_arch("whisper-small"))
    groups = tsteps.model_groups(cfg, 1)
    store = FP.ServeStore(groups, interop.serve_from_reference(
        params, groups=groups))
    frames = _bf16(inputs["frames"])
    with tmesh.dp_group(torch.device("cpu")), torch.inference_mode():
        model = tsteps.build_model(cfg, 1, model_group=tmesh.model_group(1))
        got = model.encode(store, frames, remat=False)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(C, "PREFILL_BLOCK_K", S)
            one = model.encode(store, frames, remat=False)
    assert -(-S // C.PREFILL_BLOCK_K) == 3 and S % C.PREFILL_BLOCK_K
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=XREF_ATOL)
    gap = (got.float() - one.float()).abs().max()
    assert 0 < gap <= ENC_BLOCKS_RTOL * one.float().abs().max(), gap


# ---------------------------------------------------------------------------
# the reference's serve-window fault, and the port's window
# ---------------------------------------------------------------------------

def test_reference_serve_window_fault(tmp_path):
    """The reference's serve sizes the cache to the prompt: reduced
    llama2-400m, prompt 12, 4 decode steps; at window 12 its decode leaves
    its own forward by more than 1 from the first step on (1.42 at the
    first step here), as the ring overwrites position 0 before the first
    decoded token attends.  At window 16 both packages' decodes equal
    their forwards; the port's serving steps and CLI size the cache to
    the whole generation."""
    arch, S = "llama2-400m", 12
    params, inputs, (rf, _, rd) = reference_serve(arch, S, window=S)
    gap = np.abs(rd - rf[:, S:S + N]).max(axis=(0, 2))
    assert (gap > 1.0).all(), gap
    params, inputs, (rf, _, rd) = reference_serve(arch, S, window=S + N)
    np.testing.assert_array_equal(rd, rf[:, S:S + N])
    pf, _, pd = port_serve(arch, params, inputs, S, window=S + N)
    np.testing.assert_array_equal(pd, pf[:, S:S + N])

    cfg = reduced(get_arch(arch))
    assert tsteps.serve_window(cfg, S, N) == S + N
    wh = reduced(get_arch("whisper-small"))
    assert tsteps.serve_window(wh, 1500, N) == N + 1
    assert tsteps.serve_window(wh, 1500, 999) == wh.dec_len
    res = serve.main(["--arch", arch, "--reduced", "--prompt-len", str(S),
                      "--decode-steps", str(N), "--batch", str(B),
                      "--device", "cpu"], keep=True)
    assert res["window"] == S + N
    assert [c.window for c in res["state"].kv] == [S + N] * cfg.n_layers
    assert len(res["tokens"][0]) == N + 1
