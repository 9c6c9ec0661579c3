"""Tensor, sequence and expert parallelism of the port against the JAX
reference at tp = 2 (CPU).

The port runs on a spawned 2-rank gloo group (``file://`` rendezvous), one
spawn for every case; the reference runs the same inputs (made from numpy
seeds) under ``shard_map`` on a dp=1 x tp=2 mesh of its host devices.  Each
case compares the forward output of every rank and the gradient of
``sum(y * w_r)`` (``w_r`` a per-rank cotangent) with respect to every input:

* the ``model``-group collectives (``psum_tp``, ``sp_gather``,
  ``sp_scatter_sum``, the token all-gather) and ``replicated_grad_psum``,
  in bf16: bit-exact (a two-term bf16 sum leaves no order to differ);
* ``row_linear`` (psum and sequence reduce-scatter), the vocab-parallel
  embedding (both), the cross entropy over a padded vocab tail and
  ``dense_block`` under sequence parallelism, in f32: within 1e-5
  relative and absolute, as ``test_torch_train.py`` holds the tp = 1
  block (matmul summation order);
* ``moe_block`` (``ep_a2a`` with the ``fp`` and ``block8`` wires,
  ``tp_dense``), in f32, within 1e-4 (fp, tp_dense) or 2e-2 (block8) of
  the reference's largest magnitude, as in ``test_torch_moe.py``; under
  sequence parallelism against the reference *without* it, cut to the
  rank's sequence shard (the reference's own sequence-parallel ``ep_a2a``
  is right only for one-row microbatches; ROADMAP C).

Also: ``HeadLayout.kv_map`` with kv heads replicated (tp 4, 2 kv heads),
the TP-local wire report, and that ``tp = 1`` calls no model-group
collective.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import hijack as JH
from repro.launch.mesh import make_local_mesh
from repro.models import common as JC
from repro.models import moe as JMOE
from repro.models import transformer as JTF
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.hijack import replicated_grad_psum
from repro_torch.interop import to_torch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as TC
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TTF

TP = 2
B, S, D, F = 2, 8, 16, 12
VOCAB, VL = 13, 7          # vocab padded to 14 = 2 x 7: one masked column
JLLAMA = jreduced(jget_arch("llama2-400m"))
TLLAMA = reduced(get_arch("llama2-400m"))
JMOE_CFG = jreduced(jget_arch("deepseek-v3-moe"))
TMOE_CFG = reduced(get_arch("deepseek-v3-moe"))
MOE_S = 8


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))


def _rng(seed):
    return np.random.default_rng(seed)


def _std(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the cases: per-rank inputs stacked on a leading axis of TP
# ---------------------------------------------------------------------------

def _dense_params(rng):
    """Reduced llama2-400m block params (global shapes) and their tp
    slices, f32."""
    infos = [i for g in JTF.build_groups(JLLAMA, TP) if g.name == "block"
             for i in g.infos]
    full = {i.name: (_std(rng, *i.shape, scale=i.fan_scale())
                     if i.init == "normal" else
                     1.0 + _std(rng, *i.shape, scale=0.1)) for i in infos}
    return infos, full


def _tp_slices(info, a):
    if info.tp_dim is None:
        return np.stack([a] * TP)
    return np.stack(np.split(a, TP, axis=info.tp_dim))


def _moe_params(rng, impl):
    cfg = dataclasses.replace(JMOE_CFG, moe_impl=impl)
    infos = {i.name: i for g in JTF.build_groups(cfg, TP) if g.name == "block"
             for i in g.infos
             if i.name in ("router", "w1", "w2", "w3", "ws1", "ws2", "ws3")}
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    fs = cfg.n_shared_experts * f
    shapes = {"router": (d, E), "w1": (E, d, f), "w3": (E, d, f),
              "w2": (E, f, d), "ws1": (d, fs), "ws3": (d, fs),
              "ws2": (fs, d)}
    p = {k: _std(rng, *s, scale=1 / np.sqrt(s[-2])) for k, s in shapes.items()}
    p["router"] *= 4.0  # confident routing: few near-ties
    return {k: _tp_slices(infos[k], v) for k, v in p.items()}


def make_cases():
    """name -> (inputs stacked per rank, cotangent stacked per rank)."""
    c = {}
    r = _rng(0)
    c["psum"] = ([_bf16(_std(r, TP, B, S, D))], _std(r, TP, B, S, D))
    c["sp_gather"] = ([_bf16(_std(r, TP, B, S // TP, D))],
                      _std(r, TP, B, S, D))
    c["sp_scatter_sum"] = ([_bf16(_std(r, TP, B, S, D))],
                           _std(r, TP, B, S // TP, D))
    c["all_gather_tokens"] = ([_bf16(_std(r, TP, 6, D))],
                              _std(r, TP, TP * 6, D))
    x = _bf16(_std(r, B, S, D))
    c["replicated_grad_psum"] = ([np.stack([x] * TP)], _std(r, TP, B, S, D))
    for sp in (False, True):
        out_s = S // TP if sp else S
        c[f"row_linear sp={sp}"] = (
            [_std(r, TP, B, S, F // TP), _std(r, TP, F // TP, D)],
            _std(r, TP, B, out_s, D))
        ids = r.integers(0, VOCAB, (B, S)).astype(np.int32)
        c[f"embed sp={sp}"] = ([_std(r, TP, VL, D), np.stack([ids] * TP)],
                               _std(r, TP, B, out_s, D))
    t = r.integers(0, VOCAB, (B, S)).astype(np.int32)
    t[0, :2] = VOCAB - 1  # the last real column, beside the masked tail
    c["xent padded vocab"] = ([_std(r, TP, B, S, VL, scale=3.0),
                               np.stack([t] * TP)], np.ones((TP, 1), np.float32))
    infos, full = _dense_params(r)
    c["dense_block sp"] = (
        [_std(r, TP, B, S // TP, JLLAMA.d_model)]
        + [_tp_slices(i, full[i.name]) for i in infos],
        _std(r, TP, B, S // TP, JLLAMA.d_model))
    for impl, codec in (("ep_a2a", "fp"), ("ep_a2a", "block8"),
                        ("tp_dense", "fp")):
        p = _moe_params(_rng(5), impl)
        x = _std(r, B, MOE_S, JMOE_CFG.d_model)
        for sp in (False, True):
            w = _std(r, TP, B, MOE_S, JMOE_CFG.d_model)
            if sp:  # the cotangent of each rank's sequence shard only
                s = MOE_S // TP
                for k in range(TP):
                    w[k, :, :k * s] = 0.0
                    w[k, :, (k + 1) * s:] = 0.0
            c[f"moe {impl} {codec} sp={sp}"] = (
                [np.stack([x] * TP)] + [p[k] for k in sorted(p)], w)
    return c


CASES = make_cases()
MOE_KEYS = ("router", "w1", "w2", "w3", "ws1", "ws2", "ws3")


def _moe_cfg(jax_side, impl, codec):
    cfg = JMOE_CFG if jax_side else TMOE_CFG
    return dataclasses.replace(cfg, moe_impl=impl, moe_a2a_codec=codec)


# ---------------------------------------------------------------------------
# reference side (shard_map over a dp=1 x tp=2 mesh)
# ---------------------------------------------------------------------------

def _jax_fn(name):
    """Per-rank function of the case's inputs -> (y, scalar aux or None)."""
    if name == "psum":
        return lambda x: (JC.psum_tp(x), None)
    if name == "sp_gather":
        return lambda x: (JC.sp_gather(x), None)
    if name == "sp_scatter_sum":
        return lambda x: (JC.sp_scatter_sum(x), None)
    if name == "all_gather_tokens":
        return lambda x: (jax.lax.all_gather(x, "model", tiled=True), None)
    if name == "replicated_grad_psum":
        return lambda x: (JH.replicated_grad_psum(x), None)
    if name.startswith("row_linear"):
        return lambda x, w: (JC.row_linear(x, w, sp=name.endswith("True")),
                             None)
    if name.startswith("embed"):
        return lambda e, ids: (JC.vocab_parallel_embed(
            e, ids, sp=name.endswith("True")), None)
    if name.startswith("xent"):
        return lambda lg, t: (JC.vocab_parallel_xent(lg, t, VOCAB), None)
    if name.startswith("dense_block"):
        infos = [i for g in JTF.build_groups(JLLAMA, TP) if g.name == "block"
                 for i in g.infos]
        lay = JTF.head_layout(JLLAMA, TP)

        def f(x, *ps):
            p = {i.name: a for i, a in zip(infos, ps)}
            y, _, _ = JTF.dense_block(p, x, JLLAMA, lay, 0, jnp.arange(S),
                                      None, sp=True)
            return y, None
        return f
    _, impl, codec, _ = name.split()
    cfg = _moe_cfg(True, impl, codec)

    def moe(x, *ps):
        y, aux = JMOE.moe_block(x, dict(zip(sorted(MOE_KEYS), ps)), cfg)
        return y, aux["aux"] + aux["z"]
    return moe


def reference(name):
    """[(y, [grads...]) per rank] of the reference."""
    args, w = CASES[name]
    fn = _jax_fn(name)
    diff = [i for i, a in enumerate(args) if a.dtype != np.int32]

    def body(w, *a):
        a = [x[0] for x in a]

        def loss(*d):
            full = list(a)
            for i, v in zip(diff, d):
                full[i] = v
            y, extra = fn(*full)
            val = jnp.sum(y.astype(jnp.float32) * w[0])
            return val + (extra if extra is not None else 0.0), y
        (_, y), g = jax.value_and_grad(loss, argnums=tuple(range(len(diff))),
                                       has_aux=True)(*[a[i] for i in diff])
        return (y[None],) + tuple(x[None] for x in g)

    mesh = make_local_mesh(dp=1, tp=TP)
    spec = P("model")
    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(spec,) * (1 + len(args)),
                              out_specs=spec, check_vma=False))
    outs = [np.asarray(jnp.asarray(o).astype(jnp.float32))
            for o in f(jnp.asarray(w), *map(jnp.asarray, args))]
    return [(outs[0][r], [g[r] for g in outs[1:]]) for r in range(TP)]


# ---------------------------------------------------------------------------
# port side (a spawned 2-rank gloo group)
# ---------------------------------------------------------------------------

def _port_fn(name, group):
    if name == "psum":
        return lambda x: (TC.psum_tp(x, group), None)
    if name == "sp_gather":
        return lambda x: (TC.sp_gather(x, group), None)
    if name == "sp_scatter_sum":
        return lambda x: (TC.sp_scatter_sum(x, group), None)
    if name == "all_gather_tokens":
        return lambda x: (TC.all_gather_tp(x, group), None)
    if name == "replicated_grad_psum":
        return lambda x: (replicated_grad_psum(x, group), None)
    if name.startswith("row_linear"):
        return lambda x, w: (TC.row_linear(x, w, group,
                                           sp=name.endswith("True")), None)
    if name.startswith("embed"):
        return lambda e, ids: (TC.vocab_parallel_embed(
            e, ids.long(), group, sp=name.endswith("True")), None)
    if name.startswith("xent"):
        return lambda lg, t: (TC.vocab_parallel_xent(lg, t.long(), VOCAB,
                                                     group), None)
    if name.startswith("dense_block"):
        infos = [i for g in TTF.build_groups(TLLAMA, TP) if g.name == "block"
                 for i in g.infos]
        lay = TTF.head_layout(TLLAMA, TP)

        def f(x, *ps):
            p = {i.name: a for i, a in zip(infos, ps)}
            return TTF.dense_block(p, x, TLLAMA, lay, torch.arange(S), group,
                                   sp=True), None
        return f
    _, impl, codec, sp = name.split()
    cfg = _moe_cfg(False, impl, codec)

    def moe(x, *ps):
        y, aux = TMOE.moe_block(x, dict(zip(sorted(MOE_KEYS), ps)), cfg,
                                group, sp=sp == "sp=True")
        return y, aux["aux"] + aux["z"]
    return moe


def _port_case(name, rank, group):
    args, w = CASES[name]
    ts = [to_torch(a[rank]) for a in args]
    for t in ts:
        if t.is_floating_point():
            t.requires_grad_()
    y, extra = _port_fn(name, group)(*ts)
    wr = torch.from_numpy(w[rank])
    if name.startswith("moe") and name.endswith("True"):
        s = MOE_S // TP
        wr = wr[:, rank * s:(rank + 1) * s]
    loss = torch.sum(y.float() * wr) + (extra if extra is not None else 0.0)
    loss.backward()
    return (y.detach().float().numpy(),
            [t.grad.float().numpy() for t in ts if t.is_floating_point()])


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, TP, rdv)
    _, model = tmesh.mesh_groups(TP)
    res = {name: _port_case(name, rank, model) for name in CASES}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=TP,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(TP)]


def _compare(got, want, name, **tol):
    if not tol:
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif "rel_to_max" in tol:
        lim = tol["rel_to_max"] * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= lim, name
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


def _check(port, name, **tol):
    ref = reference(name)
    for r in range(TP):
        y, grads = port[r][name]
        want_y, want_g = ref[r]
        if name.startswith("moe") and name.endswith("True"):
            s = MOE_S // TP
            want_y = want_y[:, r * s:(r + 1) * s]
        _compare(y, want_y, f"{name} rank {r}: y", **tol)
        assert len(grads) == len(want_g)
        for i, (g, wg) in enumerate(zip(grads, want_g)):
            _compare(g, wg, f"{name} rank {r}: grad {i}", **tol)


@pytest.mark.parametrize("name", ["psum", "sp_gather", "sp_scatter_sum",
                                  "all_gather_tokens",
                                  "replicated_grad_psum"])
def test_collective_matches_reference_bit_exact(port, name):
    _check(port, name)


@pytest.mark.parametrize("name", ["row_linear sp=False", "row_linear sp=True",
                                  "embed sp=False", "embed sp=True",
                                  "xent padded vocab", "dense_block sp"])
def test_layer_matches_reference(port, name):
    _check(port, name, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("impl,codec", [("ep_a2a", "fp"),
                                        ("ep_a2a", "block8"),
                                        ("tp_dense", "fp")])
def test_moe_block_matches_reference(port, impl, codec, sp):
    _check(port, f"moe {impl} {codec} sp={sp}",
           rel_to_max=2e-2 if codec == "block8" else 1e-4)


def test_replicated_grad_psum_sums_the_gradient(port):
    """The gradient of the identity is the sum of every rank's cotangent."""
    w = _bf16(CASES["replicated_grad_psum"][1]).astype(np.float32)
    for r in range(TP):
        np.testing.assert_array_equal(port[r]["replicated_grad_psum"][1][0],
                                      _bf16(w[0] + w[1]).astype(np.float32))


def test_kv_map_replicated_matches_reference():
    """tp 4 over 2 kv heads: kv heads are replicated and each rank maps its
    q heads through their *global* index."""
    tp = 4
    jcfg = dataclasses.replace(JLLAMA, n_kv_heads=2)
    tcfg = dataclasses.replace(TLLAMA, n_kv_heads=2)
    jlay, tlay = JTF.head_layout(jcfg, tp), TTF.head_layout(tcfg, tp)
    assert not tlay.kv_sharded and (tlay.hl, tlay.kvl) == (1, 2)
    assert dataclasses.asdict(tlay) == dataclasses.asdict(jlay)
    f = jax.jit(jax.shard_map(lambda: jlay.kv_map()[None],
                              mesh=make_local_mesh(dp=1, tp=tp), in_specs=(),
                              out_specs=P("model"), check_vma=False))
    want = np.asarray(f()).reshape(tp, -1)
    got = np.stack([tlay.kv_map("cpu", r).numpy() for r in range(tp)])
    np.testing.assert_array_equal(got, want)
    assert got.ravel().tolist() == [0, 0, 1, 1]
    assert not tlay.kv_identity


@pytest.mark.parametrize("arch", ["llama2-400m", "deepseek-v3-moe"])
def test_plan_report_tp2_matches_reference(arch):
    """A rank's wire bytes and collectives per sync from the TP-local
    shapes at dp 2 x tp 2, as the reference reports them."""
    import types

    from repro.core import buckets as JBK
    from repro.core import policy as JPOL
    from repro.core.loco import SyncConfig as JSync
    from repro.telemetry import wire as JW
    from repro_torch.core import buckets as TBK
    from repro_torch.core import policy as TPOL
    from repro_torch.core.loco import SyncConfig as TSync
    from repro_torch.telemetry import wire as TW

    topo = types.SimpleNamespace(tp=2, dp=2)
    spec = "embed=loco8,min=16384"
    jplan = JBK.make_sync_plan(
        JTF.build_groups(jreduced(jget_arch(arch)), 2), topo,
        JBK.BucketConfig(1 << 16), JPOL.parse_policy(spec, JSync()))
    tplan = TBK.make_sync_plan(
        TTF.build_groups(reduced(get_arch(arch)), 2), topo,
        TBK.BucketConfig(1 << 16), TPOL.parse_policy(spec, TSync()))
    j, t = JW.plan_report(jplan), TW.plan_report(tplan)
    for k in ("total_wire", "fp32_bytes", "bf16_bytes", "state_bytes",
              "launches_per_bucket", "launches_coalesced", "comm_groups"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.by_class() == j.by_class()
    one = TW.plan_report(TBK.make_sync_plan(
        TTF.build_groups(reduced(get_arch(arch)), 1),
        types.SimpleNamespace(tp=1, dp=2), TBK.BucketConfig(1 << 16),
        TPOL.parse_policy(spec, TSync())))
    assert t.fp32_bytes < one.fp32_bytes  # TP-local: a slice per rank


def test_tp1_calls_no_model_collective(monkeypatch):
    """At tp = 1 the model (and its step) never enter a model-group
    collective: sequence parallelism and the TP psums add nothing."""
    from repro_torch.core import hijack
    from repro_torch.launch import train

    def refuse(*a, **k):
        raise AssertionError("model-group collective called at tp = 1")

    for cls in (TC._AllGather, TC._ReduceScatter, TC._Psum,
                hijack._SumGradsOverModel):
        monkeypatch.setattr(cls, "apply", refuse)
    for arch in ("llama2-400m", "deepseek-v3-moe"):
        out = train.main(["--arch", arch, "--reduced", "--steps", "1",
                          "--seq-len", "16", "--global-batch", "2",
                          "--device", "cpu", "--log-every", "1"])
        assert np.isfinite(out["losses"]).all()
