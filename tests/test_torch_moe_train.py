"""The slice as a whole: MoE training through the block8 activation wire,
and dense training through the onebit gradient wire, against the JAX
reference (CPU, tp 1, seq 32, global batch 8, microbatch 2, 3 steps).

Reduced deepseek-v3-moe (``--moe-a2a block8``) trains at dp=1 and dp=2,
first with ``--sync fp`` and then ``--sync loco``; reduced llama2-400m
trains with ``--sync onebit`` at dp=2.  Both packages start from the
reference's ``make_init`` state (``interop.from_reference``) and see the
same batches.  The bounds are the dense slice's (tests/test_torch_train.py),
set from its fp run: step-0 loss within 2e-3 relative, steps 1-2 within
2e-2 absolute; the router losses ``moe_aux`` and ``moe_z`` within 2e-2
relative at every step.

A CPU run also pins how often the main path calls each kernel wrapper
(the counts ``chip_smoke.py`` asserts on the card): per microbatch, one
``fused_compress`` and one ``dequant_mean`` per LoCo tensor, and six
``act_encode`` and six ``act_decode`` per MoE layer (dispatch and combine,
each in the forward, in the checkpoint's recomputation and in the
backward).
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

from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as JTF
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.kernels import act_quant as AQ
from repro_torch.kernels import loco_quant as LQ
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TTF

SEQ, BATCH, STEPS, MICRO = 32, 8, 3, 2
STEP0_RTOL, LATER_ATOL, ROUTER_RTOL = 2e-3, 2e-2, 2e-2
ARCHS = {"moe": "deepseek-v3-moe", "dense": "llama2-400m"}
# (arch, dp, strategy) runs compared with the reference
RUNS = [("moe", 1, "fp"), ("moe", 1, "loco"), ("moe", 2, "fp"),
        ("moe", 2, "loco"), ("dense", 2, "onebit")]


def _cfgs(arch):
    return jreduced(jget_arch(ARCHS[arch])), reduced(get_arch(ARCHS[arch]))


def _batches(vocab):
    rng = np.random.default_rng(43)
    return [rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _run_cfgs(strategy):
    common = dict(optimizer="adam", microbatch=MICRO, total_steps=STEPS,
                  warmup_steps=2, lr=2e-3)
    return (jsteps.RunConfig(sync=JSync(strategy=strategy), **common),
            tsteps.RunConfig(sync=SyncConfig(strategy=strategy), **common))


def _reference(arch, dp, strategy):
    """(init state as numpy trees, per-step metrics) of the JAX reference."""
    jcfg, _ = _cfgs(arch)
    mesh = make_local_mesh(dp=dp, tp=1)
    run = _run_cfgs(strategy)[0]
    shape = JShape("t", SEQ, BATCH, "train")
    init_fn, _ = jsteps.make_init(jcfg, run, mesh, shape)
    chunks, states, opt = init_fn(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, (chunks, states, opt))
    bundle = jsteps.make_train_step(jcfg, run, mesh, shape)
    out = []
    for i, tok in enumerate(_batches(jcfg.vocab)):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        out.append({k: float(m[k]) for k in ("loss", "moe_aux", "moe_z")
                    if k in m})
    return host, out


def _port(arch, host, strategy, topo):
    _, tcfg = _cfgs(arch)
    ts = interop.from_reference(*host, groups=TTF.build_groups(tcfg, 1),
                                rank=topo.rank, dp=topo.dp)
    step_fn = tsteps.make_train_step(tcfg, _run_cfgs(strategy)[1], topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    return [{k: float(v) for k, v in step_fn(
        ts, i, {"tokens": torch.from_numpy(t).long()}).items()
        if k in ("loss", "moe_aux", "moe_z")}
        for i, t in enumerate(_batches(tcfg.vocab))]


def _assert_close(port, ref):
    assert [sorted(p) for p in port] == [sorted(r) for r in ref]
    gaps = [abs(p["loss"] - r["loss"]) for p, r in zip(port, ref)]
    print(f"port {port}\nreference {ref}\nloss gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(ref[0]["loss"]), gaps
    assert max(gaps[1:]) <= LATER_ATOL, gaps
    for key in ("moe_aux", "moe_z"):
        for p, r in zip(port, ref):
            if key in r:
                assert abs(p[key] - r[key]) <= ROUTER_RTOL * abs(r[key]), \
                    (key, p[key], r[key])
    assert all(np.isfinite(p["loss"]) for p in port)


@pytest.fixture(scope="module")
def reference():
    return {run: _reference(*run) for run in RUNS}


def test_moe_config_mirrors_reference():
    jcfg, tcfg = _cfgs("moe")
    for j, t in ((jcfg, tcfg), (jget_arch("deepseek-v3-moe"),
                                get_arch("deepseek-v3-moe"))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        jg, tg = JTF.build_groups(j, 1), TTF.build_groups(t, 1)
        assert [(g.name, g.n_layers, [dataclasses.asdict(i) for i in g.infos])
                for g in jg] == [(g.name, g.n_layers, [
                    dataclasses.asdict(i) for i in g.infos]) for g in tg]
    assert tcfg.moe_a2a_codec == "block8" and tcfg.moe_impl == "ep_a2a"
    full = TTF.build_groups(get_arch("deepseek-v3-moe"), 1)
    # 1.34B parameters; 134 LoCo tensors (11 per layer, the 1024 x 64
    # router included, + tok + head): chip_smoke.py's launch counts
    assert sum(int(np.prod(i.shape)) * (g.n_layers or 1) for g in full
               for i in g.infos) == 1_343_513_600
    assert sum((g.n_layers or 1) for g in full for i in g.infos
               if i.loco) == 134


def test_interop_carries_expert_chunks(reference):
    host, _ = reference[("moe", 2, "fp")]
    _, tcfg = _cfgs("moe")
    groups = TTF.build_groups(tcfg, 1)
    block = next(g for g in groups if g.name == "block")
    w1 = next(i for i in block.infos if i.name == "w1")
    assert len(w1.shape) == 3
    for rank in range(2):
        ts = interop.from_reference(*host, groups=groups, rank=rank, dp=2)
        c = ts.chunks["block"]["w1"]
        assert c.shape == (tcfg.n_layers, w1.chunklen(1, 2))
        ref = np.asarray(host[0]["block"]["w1"])[:, 0]
        np.testing.assert_array_equal(
            c.numpy(), ref[:, rank * c.shape[1]:(rank + 1) * c.shape[1]])


@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield MeshTopo.from_group(g,
                                  model=tmesh.model_group())


@pytest.mark.parametrize("strategy", ["fp", "loco"])
def test_moe_slice_dp1_matches_reference(reference, group1, strategy):
    host, ref = reference[("moe", 1, strategy)]
    port = _port("moe", host, strategy, group1)
    _assert_close(port, ref)


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, 2, rdv)
    topo = MeshTopo.from_group(dist.group.WORLD,
                               model=tmesh.model_group())
    res = {run: _port(run[0], hosts[run], run[2], topo) for run in hosts}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_dp2(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_train")
    hosts = {run: reference[run][0] for run in RUNS if run[1] == 2}
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                        nprocs=2, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("run", [r for r in RUNS if r[1] == 2],
                         ids=lambda r: f"{r[0]}-{r[2]}")
def test_slice_dp2_matches_reference(reference, port_dp2, run):
    _assert_close(port_dp2[0][run], reference[run][1])
    assert port_dp2[0][run] == port_dp2[1][run]  # dp-mean metrics


def test_main_path_wrapper_calls(group1, monkeypatch):
    """One CPU step of reduced deepseek-v3-moe with LoCo and block8: the
    calls of each kernel wrapper that chip_smoke.py's launch counts assume."""
    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((LQ, "fused_compress"), (LQ, "dequant_mean"),
                      (AQ, "act_encode"), (AQ, "act_decode")):
        counting(mod, name)
    _, tcfg = _cfgs("moe")
    run = _run_cfgs("loco")[1]
    ts = tsteps.make_init(tcfg, run, group1, torch.device("cpu"))
    step_fn = tsteps.make_train_step(tcfg, run, group1, torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    step_fn(ts, 0, {"tokens": torch.from_numpy(_batches(tcfg.vocab)[0]).long()})
    accum = BATCH // MICRO
    loco = sum((g.n_layers or 1) for g in TTF.build_groups(tcfg, 1)
               for i in g.infos if i.loco)
    assert calls == {"fused_compress": loco * accum,
                     "dequant_mean": loco * accum,
                     "act_encode": 6 * tcfg.n_layers * accum,
                     "act_decode": 6 * tcfg.n_layers * accum}
