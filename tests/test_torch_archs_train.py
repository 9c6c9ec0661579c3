"""The pool's attention-decoder configs train in the port as in the JAX
reference (CPU, ``--sync loco``, Adam, 3 steps, global batch 8,
microbatch 2, dp 1, tp 1).

Each of the seven configs the port adds (mixtral-8x7b, qwen3-moe-30b-a3b
with ``--moe-a2a block8``, gemma2-27b, minicpm-2b, h2o-danube-1.8b,
command-r-35b, chameleon-34b), reduced, starts from the reference's
``make_init`` state (``interop.from_reference``) and sees the same numpy
batches: seq 128 for the windowed configs (``swa``, ``local_global``), so
their reduced 64-token window cuts, and seq 32 for the others.  Bounds are
the north star's (tests/test_torch_train.py): step-0 loss within 2e-3
relative, steps 1-2 within 2e-2 absolute, the router losses within 2e-2
relative.  The 2-rank runs (gemma2 at dp 2, qwen3 at dp 1 x tp 2) and
gemma2 on the bucketed, overlapped sync are in
tests/test_torch_archs_dist.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import policy as TPOL
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TTF

BATCH, STEPS, MICRO = 8, 3, 2
STEP0_RTOL, LATER_ATOL, ROUTER_RTOL = 2e-3, 2e-2, 2e-2
ARCHS = ["mixtral-8x7b", "qwen3-moe-30b-a3b", "gemma2-27b", "minicpm-2b",
         "h2o-danube-1.8b", "command-r-35b", "chameleon-34b"]
METRICS = ("loss", "moe_aux", "moe_z")
# --bucket-mb 0.0625 --policy "embed=loco8,min=16384" (overlapped)
BUCKETS = (64 << 10, "embed=loco8,min=16384")


def cfgs(arch, **changes):
    """(reference, port) reduced configs; qwen3 on the block8 wire."""
    if arch == "qwen3-moe-30b-a3b":
        changes.setdefault("moe_a2a_codec", "block8")
    return (dataclasses.replace(jreduced(jget_arch(arch)), **changes),
            dataclasses.replace(reduced(get_arch(arch)), **changes))


def seq_len(cfg) -> int:
    """128 where a window must cut (the reduced window is 64), else 32."""
    return 128 if cfg.attn_kind in ("swa", "local_global") else 32


def batches(vocab, seq, batch=BATCH):
    rng = np.random.default_rng(45)
    return [rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
            for _ in range(STEPS)]


def run_cfgs(micro=MICRO, bucketed=False):
    common = dict(optimizer="adam", microbatch=micro, total_steps=STEPS,
                  warmup_steps=2, lr=2e-3)
    out = []
    for steps_mod, pol, sync in ((jsteps, JPOL, JSync(strategy="loco")),
                                 (tsteps, TPOL, SyncConfig(strategy="loco"))):
        kw = (dict(bucket_bytes=BUCKETS[0],
                   policy=pol.parse_policy(BUCKETS[1], sync))
              if bucketed else {})
        out.append(steps_mod.RunConfig(sync=sync, **common, **kw))
    return tuple(out)


def _init(jcfg, dp, tp, batch, micro, bucketed=False):
    mesh = make_local_mesh(dp=dp, tp=tp)
    run = run_cfgs(micro, bucketed)[0]
    shape = JShape("t", seq_len(jcfg), batch, "train")
    init_fn, _ = jsteps.make_init(jcfg, run, mesh, shape)
    return mesh, run, shape, init_fn(jax.random.PRNGKey(0))


def init_host(jcfg, dp=1, tp=1, batch=BATCH, micro=MICRO):
    """The reference's ``make_init`` state as numpy trees."""
    return jax.tree.map(np.asarray, _init(jcfg, dp, tp, batch, micro)[3])


def reference(jcfg, dp=1, tp=1, batch=BATCH, micro=MICRO, bucketed=False):
    """(init state as numpy trees, per-step metrics) of the reference."""
    mesh, run, shape, (chunks, states, opt) = _init(jcfg, dp, tp, batch,
                                                    micro, bucketed)
    host = jax.tree.map(np.asarray, (chunks, states, opt))
    seq = shape.seq_len
    bundle = jsteps.make_train_step(jcfg, run, mesh, shape)
    out = []
    for i, tok in enumerate(batches(jcfg.vocab, seq, batch)):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        out.append({k: float(m[k]) for k in METRICS if k in m})
    return host, out


def port(tcfg, host, topo, batch=BATCH, micro=MICRO, bucketed=False):
    seq = seq_len(tcfg)
    ts = interop.from_reference(*host, groups=TTF.build_groups(tcfg, topo.tp),
                                rank=topo.rank, dp=topo.dp,
                                tp_rank=topo.tp_rank)
    step_fn = tsteps.make_train_step(tcfg, run_cfgs(micro, bucketed)[1], topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", seq, batch, "train"))
    return [{k: float(v) for k, v in step_fn(
        ts, i, {"tokens": torch.from_numpy(t).long()}).items()
        if k in METRICS}
        for i, t in enumerate(batches(tcfg.vocab, seq, batch))]


def assert_close(got, ref):
    assert [sorted(p) for p in got] == [sorted(r) for r in ref]
    gaps = [abs(p["loss"] - r["loss"]) for p, r in zip(got, ref)]
    print(f"port {got}\nreference {ref}\nloss gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(ref[0]["loss"]), gaps
    assert max(gaps[1:]) <= LATER_ATOL, gaps
    for key in ("moe_aux", "moe_z"):
        for p, r in zip(got, ref):
            if key in r:
                assert abs(p[key] - r[key]) <= ROUTER_RTOL * abs(r[key]), \
                    (key, p[key], r[key])
    assert all(np.isfinite(p["loss"]) for p in got)


@pytest.fixture(scope="module")
def topo1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield MeshTopo.from_group(g, model=tmesh.model_group())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_trains_like_reference(topo1, arch):
    jcfg, tcfg = cfgs(arch)
    host, ref = reference(jcfg)
    assert_close(port(tcfg, host, topo1), ref)



@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_main_path_wrapper_calls(topo1, monkeypatch, arch):
    """One CPU step of reduced qwen3 (block8) and mixtral (tp_dense): the
    calls of each kernel wrapper that chip_smoke.py's launch counts for
    paths k and l assume: per microbatch one fused_compress and one
    dequant_mean per LoCo tensor; six act_encode and six act_decode per
    block8 MoE layer, none under tp_dense."""
    from repro_torch.kernels import act_quant as AQ
    from repro_torch.kernels import loco_quant as LQ

    calls = {}
    for mod, name in ((LQ, "fused_compress"), (LQ, "dequant_mean"),
                      (AQ, "act_encode"), (AQ, "act_decode")):
        def wrapped(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    _, tcfg = cfgs(arch)
    run = run_cfgs()[1]
    seq = seq_len(tcfg)
    ts = tsteps.make_init(tcfg, run, topo1, torch.device("cpu"))
    step_fn = tsteps.make_train_step(tcfg, run, topo1, torch.device("cpu"),
                                     ShapeConfig("t", seq, BATCH, "train"))
    step_fn(ts, 0, {"tokens": torch.from_numpy(
        batches(tcfg.vocab, seq)[0]).long()})
    accum = BATCH // MICRO
    loco = sum((g.n_layers or 1) for g in TTF.build_groups(tcfg, 1)
               for i in g.infos if i.loco)
    want = {"fused_compress": loco * accum, "dequant_mean": loco * accum}
    if tcfg.moe_impl == "ep_a2a":
        want.update(act_encode=6 * tcfg.n_layers * accum,
                    act_decode=6 * tcfg.n_layers * accum)
    assert calls == want
