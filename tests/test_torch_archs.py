"""The attention-decoder configs of the pool and the features they need,
module by module against the JAX reference (CPU, f32 unless a test says
bf16; inputs from a seeded numpy generator).

Configs: the seven the port adds (mixtral-8x7b, qwen3-moe-30b-a3b,
gemma2-27b, minicpm-2b, h2o-danube-1.8b, command-r-35b, chameleon-34b),
full and reduced, field for field and declaration for declaration at tp 1
and 2.  Features: sliding-window and soft-capped attention, qk-norm with
``head_dim * n_heads != d_model``, the GELU / GeGLU MLPs and the MoE's
activation, the parallel block, the embedding / residual / logit scales
and both soft caps (bit for bit), the final soft cap in the loss, and
local/global alternation over 4 layers.

Tolerances: rtol 1e-5 (atol 1e-5) on f32 blocks, as in
tests/test_torch_train.py; the scales and the soft caps' forward exactly,
since each is a few elementwise ops with the reference's rounding (the
soft cap's gradient too, where XLA fuses a multiply-add).  Activations are
compared in f32 only: in bf16 XLA rounds each op of GELU (1 + tanh(.) is
exactly 0 below about -3), torch the result once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.all_archs import ASSIGNED as JASSIGNED
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.launch.mesh import make_local_mesh
from repro.models import common as JC
from repro.models import moe as JMOE
from repro.models import transformer as JTF
from repro_torch.configs.all_archs import ASSIGNED
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import common as TC
from repro_torch.models import transformer as TTF

NEW_ARCHS = ["mixtral-8x7b", "qwen3-moe-30b-a3b", "gemma2-27b", "minicpm-2b",
             "h2o-danube-1.8b", "command-r-35b", "chameleon-34b"]
RTOL = ATOL = 1e-5


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(arch, **changes):
    """(reference, port) reduced configs of ``arch`` with ``changes``."""
    return (dataclasses.replace(jreduced(jget_arch(arch)), **changes),
            dataclasses.replace(reduced(get_arch(arch)), **changes))


def _decl(groups):
    return [(g.name, g.n_layers, [dataclasses.asdict(i) for i in g.infos])
            for g in groups]


def _block_params(jcfg, rng):
    """Random f32 weights of one layer of ``jcfg``'s block group (norms at
    1 + noise, so a swapped norm shows)."""
    infos = [i for g in JTF.build_groups(jcfg, 1) if g.name == "block"
             for i in g.infos]
    return {i.name: _f32(rng, *i.shape, scale=i.fan_scale())
            if i.init == "normal" else 1.0 + _f32(rng, *i.shape, scale=0.1)
            for i in infos}


def _shard_map1(body, n_out=1):
    mesh = make_local_mesh(dp=1, tp=1)
    out = P() if n_out == 1 else (P(),) * n_out
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                                 out_specs=out, check_vma=False))


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# configs and declarations
# ---------------------------------------------------------------------------

def test_registry_mirrors_reference():
    """ASSIGNED is the reference's list in its order; get_arch returns
    every config of it, of the reference's family, and the model accepts
    each one (check_supported)."""
    assert ASSIGNED == JASSIGNED
    assert set(NEW_ARCHS) <= set(ASSIGNED)
    for name in ASSIGNED:
        assert get_arch(name).family == jget_arch(name).family
        TTF.check_supported(get_arch(name))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_and_groups_mirror_reference(arch, tp):
    """Fields (with ``source``) and ``build_groups`` (names, shapes,
    ``tp_dim``, ``loco``, ``decay``, init) equal the reference's, full
    and reduced."""
    for j, t in ((jget_arch(arch), get_arch(arch)),
                 (jreduced(jget_arch(arch)), reduced(get_arch(arch)))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        TTF.check_supported(t)
        assert _decl(TTF.build_groups(t, tp)) == _decl(JTF.build_groups(j, tp))
    full = TTF.build_groups(get_arch(arch), tp)
    names = {i.name for g in full for i in g.infos}
    cfg = get_arch(arch)
    assert ("head" in names) != cfg.tied_embeddings
    assert ({"qnorm", "knorm"} <= names) == cfg.qk_norm
    assert ("w3" in names) == (cfg.mlp != "gelu")


def test_full_width_sizes():
    """The full-width parameter counts and per-layer LoCo lengths of the two
    MoEs chip_smoke.py trains (paths k and l)."""
    def sizes(arch, layers):
        groups = TTF.build_groups(
            dataclasses.replace(get_arch(arch), n_layers=layers), 1)
        total = sum(int(np.prod(i.shape)) * (g.n_layers or 1)
                    for g in groups for i in g.infos)
        loco = sorted({int(np.prod(i.shape)) for g in groups
                       for i in g.infos if i.loco})
        return total, loco

    assert sizes("qwen3-moe-30b-a3b", 2) == (1_868_573_184, [
        262_144, 1_048_576, 8_388_608, 201_326_592, 311_164_928])
    assert sizes("mixtral-8x7b", 1) == (1_713_418_240, [
        4_194_304, 16_777_216, 131_072_000, 469_762_048])


# ---------------------------------------------------------------------------
# attention: windows, soft caps, qk-norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,window,cap", [
    (128, 16, None), (128, None, 50.0), (128, 16, 50.0), (128, 64, None),
    (32, 64, None)], ids=lambda v: str(v))
def test_attention_window_and_softcap(seq, window, cap):
    rng = np.random.default_rng(seq + (window or 0))
    q, k, v = (_f32(rng, 2, seq, 4, 64, scale=2.0) for _ in range(3))
    pos = jnp.arange(seq, dtype=jnp.int32)
    want = np.asarray(jax.jit(lambda q, k, v: JC.blockwise_attention(
        q, k, v, pos, pos, causal=True,
        window=None if window is None else jnp.int32(window),
        softcap=cap))(q, k, v))
    got = TC.attention(*map(torch.from_numpy, (q, k, v)),
                       window=window, softcap=cap).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    full = TC.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    cuts = window is not None and window < seq
    # a window that cuts (or a cap) changes the result; at seq 32 a
    # 64-token window does not cut
    assert (not np.allclose(got, full, rtol=1e-3)) == (cuts or cap is not None)


@pytest.mark.parametrize("cap", [50.0, 30.0])
def test_soft_cap_is_the_reference_bit_for_bit(cap):
    """``cap * tanh(x / cap)``: XLA's division by a constant (a multiply by
    its f32 reciprocal) and its f32 tanh, and the gradient, bit for
    bit."""
    rng = np.random.default_rng(int(cap))
    x = np.concatenate([_f32(rng, 200_000, scale=s)
                        for s in (1e-3, 1.0, 30.0, 300.0, 3000.0)])
    x[:4] = [0.0, -0.0, 1e-30, -4e-4]
    fn = jax.jit(lambda a: cap * jnp.tanh(a / cap))
    np.testing.assert_array_equal(
        TC.soft_cap(torch.from_numpy(x), cap).numpy(), np.asarray(fn(x)))
    g = _f32(rng, x.size)
    want = np.asarray(jax.jit(lambda a, g: jax.vjp(fn, a)[1](g)[0])(x, g))
    t = torch.from_numpy(x).requires_grad_()
    TC.soft_cap(t, cap).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), want)


def test_qkv_qk_norm_with_wide_heads():
    """qk-norm (RMSNorm over head_dim, before RoPE) with head_dim * n_heads
    (4 x 128) != d_model (256), as at full width (qwen3: 32 x 128 on
    2048; reduced() sets head_dim = d // heads, so it is set here)."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", head_dim=128, n_kv_heads=2)
    assert tcfg.hd * tcfg.n_heads != tcfg.d_model
    rng = np.random.default_rng(5)
    p = _block_params(jcfg, rng)
    assert p["qnorm"].shape == p["knorm"].shape == (128,)
    x = _f32(rng, 2, 32, tcfg.d_model)
    pos = np.arange(32)
    jlay, tlay = JTF.head_layout(jcfg, 1), TTF.head_layout(tcfg, 1)
    want = JTF._qkv(_j(p), jnp.asarray(x), jlay, jcfg, jnp.asarray(pos))
    got = TTF._qkv(_t(p), torch.from_numpy(x), tlay, tcfg,
                   torch.from_numpy(pos))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    off = TTF._qkv(_t(p), torch.from_numpy(x), tlay,
                   dataclasses.replace(tcfg, qk_norm=False),
                   torch.from_numpy(pos))
    assert not np.allclose(off[0].numpy(), np.asarray(want[0]), rtol=1e-3)

    def body(p, x):
        a, _ = JTF.attention_block(p, x, jcfg, jlay, 0, jnp.arange(32), None)
        return a

    np.testing.assert_allclose(
        TTF.attention_block(_t(p), torch.from_numpy(x), tcfg, tlay,
                            torch.arange(32)).numpy(),
        np.asarray(_shard_map1(body)(_j(p), jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,kv,tp", [(4, 2, 1), (4, 1, 1), (32, 8, 1),
                                          (32, 4, 2), (4, 1, 2), (6, 2, 4)])
def test_expand_kv_is_the_gather(heads, kv, tp):
    """GQA's kv expansion from ``kv_runs`` (expand and cat) is the
    reference's gather ``take(k, kv_map, axis=2)`` on every model rank,
    kv sharded or replicated (tp > kv), and its gradient is the gather's
    transpose (integer-valued, so every order of the sums is exact)."""
    jlay = JC.HeadLayout.make(heads, kv, 16, tp)
    for rank in range(tp):
        lay = TC.HeadLayout.make(heads, kv, 16, tp)
        kv_map = lay.kv_map("cpu", rank)
        assert lay.kv_runs(rank) == tuple(torch.bincount(
            kv_map, minlength=lay.kvl).tolist())
        want_map = np.asarray(jax.jit(jax.shard_map(
            lambda: jlay.kv_map()[None], mesh=make_local_mesh(dp=1, tp=tp),
            in_specs=(), out_specs=P("model"), check_vma=False))())[rank]
        np.testing.assert_array_equal(kv_map.numpy(), want_map)
        rng = np.random.default_rng(rank)
        k = torch.from_numpy(rng.integers(-8, 8, (2, 5, lay.kvl, 16))
                             .astype(np.float32)).requires_grad_()
        g = torch.from_numpy(rng.integers(-8, 8, (2, 5, lay.hl, 16))
                             .astype(np.float32))
        out = TC.expand_kv(k, lay.kv_runs(rank))
        assert torch.equal(out, torch.index_select(k, 2, kv_map))
        out.backward(g)
        assert torch.equal(k.grad, torch.zeros_like(k).index_add(
            2, kv_map, g))


# ---------------------------------------------------------------------------
# MLPs and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_activation_matches_reference(kind):
    rng = np.random.default_rng(7)
    a, b = _f32(rng, 4096, scale=3.0), _f32(rng, 4096)
    jb = None if kind == "gelu" else jnp.asarray(b)
    tb = None if kind == "gelu" else torch.from_numpy(b)
    want = np.asarray(JMOE._activation(kind, jnp.asarray(a), jb))
    np.testing.assert_allclose(TC.activation(kind, torch.from_numpy(a),
                                             tb).numpy(), want,
                               rtol=RTOL, atol=1e-6)
    if kind != "swiglu":  # JAX's GELU is the tanh form, not erf
        erf = torch.nn.functional.gelu(torch.from_numpy(a)).numpy()
        assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(a)))).max() \
            > 1e-4


@pytest.mark.parametrize("arch", ["gemma2-27b", "minicpm-2b"])
def test_mlp_block_matches_reference(arch):
    """geglu (gemma2) and, with mlp="gelu" (no w3), the plain GELU MLP."""
    for mlp in ("geglu", "gelu") if arch == "gemma2-27b" else ("swiglu",):
        jcfg, tcfg = _cfgs(arch, mlp=mlp)
        rng = np.random.default_rng(8)
        p = _block_params(jcfg, rng)
        assert ("w3" in p) == (mlp != "gelu")
        x = _f32(rng, 2, 32, tcfg.d_model)

        def body(p, x):
            return JTF.mlp_block(p, x, jcfg)

        np.testing.assert_allclose(
            TTF.mlp_block(_t(p), torch.from_numpy(x), tcfg).numpy(),
            np.asarray(_shard_map1(body)(_j(p), jnp.asarray(x))),
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["command-r-35b", "minicpm-2b",
                                  "h2o-danube-1.8b", "chameleon-34b"])
def test_dense_block_matches_reference(arch):
    """command-r's parallel block (LayerNorm, one residual add of a + m),
    minicpm's scaled residuals, h2o-danube's window at seq 128 and
    chameleon (vlm, qk-norm) run as dense."""
    jcfg, tcfg = _cfgs(arch, window=16)
    rng = np.random.default_rng(9)
    p = _block_params(jcfg, rng)
    seq = 128
    x = _f32(rng, 2, seq, tcfg.d_model)
    lay, tlay = JTF.head_layout(jcfg, 1), TTF.head_layout(tcfg, 1)

    def body(p, x):
        y, _, _ = JTF.dense_block(p, x, jcfg, lay, 0, jnp.arange(seq), None)
        return y

    got = TTF.dense_block(_t(p), torch.from_numpy(x), tcfg, tlay,
                          torch.arange(seq)).numpy()
    np.testing.assert_allclose(got, np.asarray(_shard_map1(body)(
        _j(p), jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    if arch == "command-r-35b":
        seq_form = TTF.dense_block(_t(p), torch.from_numpy(x),
                                   dataclasses.replace(tcfg,
                                                       parallel_block=False),
                                   tlay, torch.arange(seq)).numpy()
        assert not np.allclose(got, seq_form, rtol=1e-3)


def test_local_global_alternation_over_4_layers():
    """gemma2's even layers see a 16-token window, its odd ones the whole
    128: four layers in a row, each given its global index, against the
    reference's; the windows per layer are the reference's."""
    jcfg, tcfg = _cfgs("gemma2-27b", window=16, n_layers=4)
    for cfg in (tcfg, dataclasses.replace(tcfg, attn_kind="swa"),
                dataclasses.replace(tcfg, attn_kind="full")):
        jc = dataclasses.replace(jcfg, attn_kind=cfg.attn_kind)
        assert [TTF.layer_window(cfg, l) for l in range(4)] == [
            None if int(w) == 1 << 30 else int(w)
            for w in (JTF._layer_window(jc, jnp.int32(l)) for l in range(4))]
    assert [TTF.layer_window(tcfg, l) for l in range(4)] == [16, None, 16,
                                                             None]
    rng = np.random.default_rng(10)
    ps = [_block_params(jcfg, rng) for _ in range(4)]
    seq = 128
    x = _f32(rng, 2, seq, tcfg.d_model)
    lay, tlay = JTF.head_layout(jcfg, 1), TTF.head_layout(tcfg, 1)

    def body(ps, x):
        for l, p in enumerate(ps):
            x, _, _ = JTF.dense_block(p, x, jcfg, lay, jnp.int32(l),
                                      jnp.arange(seq), None)
        return x

    mesh = make_local_mesh(dp=1, tp=1)
    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))([_j(p) for p in ps], jnp.asarray(x)))

    def port(first):
        y = torch.from_numpy(x)
        for l, p in enumerate(ps):
            y = TTF.dense_block(_t(p), y, tcfg, tlay, torch.arange(seq),
                                layer_idx=first + l)
        return y.numpy()

    np.testing.assert_allclose(port(0), want, rtol=RTOL, atol=ATOL)
    # starting on an odd (global) layer swaps local and global
    assert not np.allclose(port(1), want, rtol=1e-3)


# ---------------------------------------------------------------------------
# scales, the final soft cap
# ---------------------------------------------------------------------------

SCALES = [("gemma2-27b", "emb_scale"), ("minicpm-2b", "emb_scale"),
          ("minicpm-2b", "residual_scale"), ("minicpm-2b", "logit_scale"),
          ("command-r-35b", "logit_scale")]


@pytest.mark.parametrize("arch,field", SCALES, ids=lambda v: str(v))
def test_scales_are_the_reference_bit_for_bit(arch, field):
    """A bf16 activation times the config's scale: JAX rounds the Python
    scalar to bf16 first (weak typing).  100,000 values, bit for bit; the
    unrounded scalar would differ on 28-36% of them."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    s = getattr(tcfg, field)
    rng = np.random.default_rng(11)
    x = jnp.asarray(_f32(rng, 100_000, scale=4.0)).astype(jnp.bfloat16)
    d = jnp.asarray(_f32(rng, 100_000)).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    td = torch.from_numpy(np.array(d.astype(jnp.float32))).bfloat16()
    if field == "residual_scale":
        want = jax.jit(lambda x, d: JTF._res(jcfg, x, d))(x, d)
        got = TTF._res(tcfg, tx, td)
    else:
        want = jax.jit(lambda x: x * s)(x)
        got = TC.scale_by(tx, s)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if s != float(torch.tensor(s).bfloat16()):
        assert not torch.equal(got, tx * s if field != "residual_scale"
                               else tx + td * s)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_xent_with_final_softcap(cap):
    """The loss over the padded vocab (tail masked) with gemma2's final
    soft cap, against the reference's under shard_map (tp 1)."""
    rng = np.random.default_rng(12)
    vocab = 500
    lg = _f32(rng, 2, 32, 512, scale=40.0)
    tgt = rng.integers(0, vocab, (2, 32)).astype(np.int32)
    want = float(_shard_map1(lambda l, t: JC.vocab_parallel_xent(
        l, t, vocab, softcap=cap))(jnp.asarray(lg), jnp.asarray(tgt)))
    got = float(TC.vocab_parallel_xent(torch.from_numpy(lg),
                                       torch.from_numpy(tgt).long(), vocab,
                                       softcap=cap))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if cap is not None:
        plain = float(TC.vocab_parallel_xent(
            torch.from_numpy(lg), torch.from_numpy(tgt).long(), vocab))
        assert abs(plain - got) > 1e-2
