"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
reference's (``repro.launch.dryrun``) and against the port's own real
step, on the CPU.

* at the production meshes (16 x 16 and 2 x 16 x 16), for every arch of
  ``ASSIGNED``: ``count_params``, the active parameters, the model FLOPs
  per device, the MoE all-to-all report and the per-tier wire report are
  the reference's;
* ``SKIPS``, ``SHAPES``, ``default_run`` and the skipped records are the
  reference's; ``make_production_mesh`` and the train CLI's
  ``--production-mesh``;
* a fake world-1 dry run of reduced llama2-400m and deepseek-v3-moe
  (``block8``) dispatches what a real world-1 gloo run of the same step
  dispatches, op for op (name, FLOPs, bytes), with the same collectives
  and kernel calls; one spawned 2-rank gloo run against a fake world-2
  run the same way;
* the all-to-all wire bytes of reduced llama2-400m at dp 2 x tp 2 are the
  reference's ``hlo_stats.analyze`` of its compiled step on ``mesh22``;
  its reduce-scatter bytes are twice the port's, a reference-side quirk
  pinned here (XLA:CPU compiles the bf16 collectives as f32 ones);
* a full-width production dry run of llama2-400m at 16 x 16 on fake CPU
  tensors peaks at several GiB while the process's RSS grows by under
  1 GiB.

Every comparison is exact.
"""
import dataclasses
import os
import resource

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.analysis import hlo_stats as HS
from repro.analysis import roofline as JRL
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import policy as JPOL
from repro.core.flatparam import MeshTopo as JTopo
from repro.core.flatparam import count_params as jcount_params
from repro.core.loco import SyncConfig as JSync
from repro.core.quantizer import QuantConfig as JQuant
from repro.launch import steps as JST
from repro.telemetry import wire as JWIRE
from repro_torch.analysis import op_stats as OS
from repro_torch.configs.all_archs import ASSIGNED
from repro_torch.configs.base import SHAPES, ShapeConfig, get_arch, reduced
from repro_torch.core import policy as POL
from repro_torch.core.flatparam import MeshTopo, count_params
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TRAIN
from repro_torch.telemetry import wire as WIRE

POLICY = "embed=loco8,norm=fp,min=1048576"


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS to 512
    host devices; this process's JAX keeps the 8 it started with, and the
    variable is restored for the processes the tests spawn."""
    import jax

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _topos(multi_pod: bool):
    pm = MESH.make_production_mesh(multi_pod=multi_pod)
    pods = pm.pods or 1
    mine = MeshTopo(group=None, dp=pm.dp, rank=0, tp=pm.tp, pods=pods)
    axes = ("pod", "data") if multi_pod else ("data",)
    ref = JTopo(dp_axes=axes, tp_axis="model", dp=pm.dp, tp=pm.tp,
                pods=pods)
    return pm, mine, ref


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_production_accounting_is_the_references(arch, multi_pod):
    pm, topo, jtopo = _topos(multi_pod)
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    n = count_params(ST.model_groups(cfg, pm.tp))
    assert n == jcount_params(JST.build_model(jcfg, pm.tp).groups())
    # the reference's inline active-parameter and model-FLOP rules
    if jcfg.n_experts and jcfg.top_k:
        ep = jcfg.n_layers * jcfg.n_experts * jcfg.d_ff * jcfg.d_model * (
            3 if jcfg.mlp in ("swiglu", "geglu") else 2)
        jactive = n - ep + ep * (jcfg.top_k / jcfg.n_experts)
    else:
        jactive = n
    active = DR.n_params_active(cfg, n)
    assert active == jactive
    for name, shape in SHAPES.items():
        js = JSHAPES[name]
        if js.kind == "train":
            want = JRL.model_flops_per_step(jactive,
                                            js.global_batch * js.seq_len)
        elif js.kind == "prefill":
            want = 2.0 * jactive * js.global_batch * js.seq_len
        else:
            want = 2.0 * jactive * js.global_batch
        assert DR.model_flops_global(shape, active) / pm.world \
            == want / (pm.dp * pm.tp)
    train = SHAPES["train_4k"]
    jtrain = JSHAPES["train_4k"]
    assert WIRE.moe_a2a_report(cfg, train, topo, 1) \
        == JWIRE.moe_a2a_report(jcfg, jtrain, jtopo, 1)
    sync = DR.default_run(cfg).sync
    run = dataclasses.replace(DR.default_run(cfg), bucket_bytes=4 << 20,
                              policy=POL.parse_policy(POLICY, sync))
    jsync = JSync(strategy="loco", quant=JQuant(mode="block"))
    jrun = dataclasses.replace(JST.RunConfig(sync=jsync), microbatch=1,
                               bucket_bytes=4 << 20,
                               policy=JPOL.parse_policy(POLICY, jsync))
    plan = ST.build_sync_plan(run, ST.model_groups(cfg, pm.tp), topo)
    jplan = JST.build_sync_plan(jrun, JST.build_model(jcfg, pm.tp).groups(),
                                jtopo)
    mine = [t.record() for t in
            WIRE.plan_report(plan, pods=topo.pods, wans=1).tiers]
    ref = [t.record() for t in
           JWIRE.plan_report(jplan, pods=jtopo.pods, wans=1).tiers]
    assert mine == ref


def test_skips_shapes_and_default_run_are_the_references(jdryrun):
    assert DR.SKIPS == jdryrun.SKIPS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    mine, ref = DR.default_run(get_arch("llama2-400m")), \
        jdryrun.default_run(jget_arch("llama2-400m"))
    for f in ("optimizer", "microbatch", "remat"):
        assert getattr(mine, f) == getattr(ref, f)
    assert (mine.sync.strategy, mine.sync.quant.mode) \
        == (ref.sync.strategy, ref.sync.quant.mode)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_status_of_every_arch_is_the_references(jdryrun, shape):
    """Which (arch, shape) the dry run skips, and the skipped records."""
    for arch in ASSIGNED:
        skip = (arch, shape) in DR.SKIPS
        assert skip == ((arch, shape) in jdryrun.SKIPS)
        if skip:
            rec = DR.dryrun_one(arch, shape)
            assert rec == {"arch": arch, "shape": shape, "mesh": "16x16",
                           "sync": "loco", "status": "skipped",
                           "reason": jdryrun.SKIPS[(arch, shape)]}


def test_production_mesh_and_cli_flag():
    pm = MESH.make_production_mesh()
    assert (pm.shape, pm.axes, pm.world, pm.dp, pm.tp, pm.pods) \
        == ((16, 16), ("data", "model"), 256, 16, 16, 0)
    pm2 = MESH.make_production_mesh(multi_pod=True)
    assert (pm2.shape, pm2.world, pm2.dp, pm2.pods, pm2.name) \
        == ((2, 16, 16), 512, 32, 2, "2x16x16")
    args = TRAIN.build_args(["--arch", "llama2-400m", "--production-mesh"])
    TRAIN.production_mesh(args, 256)
    assert (args.tp, args.pods) == (16, 0)
    args = TRAIN.build_args(["--arch", "llama2-400m", "--production-mesh",
                             "--pods", "2"])
    TRAIN.production_mesh(args, 512)
    assert (args.tp, args.pods) == (16, 2)
    for argv, world in (([], 8), ([], 512), (["--pods", "2"], 256),
                        (["--pods", "4"], 1024)):
        args = TRAIN.build_args(["--arch", "llama2-400m",
                                 "--production-mesh", *argv])
        with pytest.raises(SystemExit, match="production"):
            TRAIN.production_mesh(args, world)


SMALL = ShapeConfig("t", 32, 4, "train")
CASES = {  # name: (arch, codec, run overrides)
    "llama2-400m": ("llama2-400m", None, {"microbatch": 2}),
    "deepseek-v3-moe-block8": ("deepseek-v3-moe", "block8",
                               {"microbatch": 4}),
}


def _cfg(arch, codec):
    cfg = reduced(get_arch(arch))
    return dataclasses.replace(cfg, moe_a2a_codec=codec) if codec else cfg


def _real_trace(cfg, run, topo, shape) -> OS.OpStats:
    cpu = torch.device("cpu")
    state = ST.make_init(cfg, run, topo, cpu, 0, shape)
    step = ST.make_train_step(cfg, run, topo, cpu, shape, finalize=False)
    batch = DR._train_batch(cfg, shape, cpu)
    with OS.OpStats(cpu, trace=True) as st:
        step(state, 0, batch)
    return st


def _assert_same(rec: dict, st: OS.OpStats) -> None:
    assert rec["trace"] == st.trace
    assert rec["flops_per_device"] == st.flops
    assert rec["hbm_bytes_per_device"] == st.bytes
    assert rec["collectives"] == st.collectives()
    assert rec["kernels"] == dict(st.kernels)
    assert rec["ops"] == st.n_ops == len(st.trace)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_world1_is_the_real_gloo_run(name):
    arch, codec, ov = CASES[name]
    cfg = _cfg(arch, codec)
    rec = DR.dryrun_one(arch, "train_4k", device="cpu",
                        world=DR.parse_world("1x1"), cfg=cfg, shape=SMALL,
                        run_overrides=ov, keep_trace=True)
    assert rec["status"] == "ok", rec.get("traceback")
    run = dataclasses.replace(DR.default_run(cfg), **ov)
    cpu = torch.device("cpu")
    with MESH.dp_group(cpu):
        data, model = MESH.mesh_groups(1)
        topo = MeshTopo.from_group(data, model=model,
                                   axes=MESH.mesh_axes(data, 1, 0))
        st = _real_trace(cfg, run, topo, SMALL)
    _assert_same(rec, st)
    assert rec["kernels"]["fused_compress"] > 0
    if codec:
        assert rec["kernels"]["act_encode"] == rec["kernels"]["act_decode"] > 0


WORLD2 = ("llama2-400m", None, {"microbatch": 4}, "1x2")


def _world2_rank(rank, rdv, out_dir):
    torch.set_num_threads(1)
    arch, codec, ov, _ = WORLD2
    cfg = _cfg(arch, codec)
    cpu = torch.device("cpu")
    MESH.init_file_group(cpu, rank, 2, rdv)
    data, model = MESH.mesh_groups(2)
    topo = MeshTopo.from_group(data, model=model,
                               axes=MESH.mesh_axes(data, 2, 0))
    st = _real_trace(cfg, dataclasses.replace(DR.default_run(cfg), **ov),
                     topo, SMALL)
    torch.save({"trace": st.trace, "flops": st.flops, "bytes": st.bytes,
                "collectives": st.collectives(), "kernels": dict(st.kernels),
                "n_ops": st.n_ops}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_fake_world2_is_a_spawned_gloo_run(tmp_path):
    """Rank 0 of a 2-rank gloo group at dp 1 x tp 2 (the model group's
    tensor, sequence and vocab collectives) against rank 0 of a fake
    world of 2."""
    ctx = tmp.start_processes(_world2_rank,
                              args=(str(tmp_path / "rdv"), str(tmp_path)),
                              nprocs=2, join=False, start_method="spawn")
    arch, codec, ov, world = WORLD2
    rec = DR.dryrun_one(arch, "train_4k", device="cpu",
                        world=DR.parse_world(world), cfg=_cfg(arch, codec),
                        shape=SMALL, run_overrides=ov, keep_trace=True)
    while not ctx.join():
        pass
    real = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["trace"] == real["trace"]
    assert (rec["flops_per_device"], rec["hbm_bytes_per_device"],
            rec["collectives"], rec["kernels"], rec["ops"]) \
        == (real["flops"], real["bytes"], real["collectives"],
            real["kernels"], real["n_ops"])
    assert rec["collectives"]["bytes_by_kind"]["all-reduce"] > 0


def test_all_to_all_bytes_at_mesh22_are_the_references(mesh22):
    """Reduced llama2-400m, 2 microbatches a step: the port's counted
    all-to-all wire bytes and launches equal the reference's
    trip-count-weighted ``analyze`` of its compiled step; its
    reduce-scatters are the port's in number and twice in bytes."""
    S, GB = 32, 4
    jsync = JSync(strategy="loco", quant=JQuant(mode="block"))
    jrun = JST.RunConfig(sync=jsync, optimizer="adam", microbatch=1,
                         remat=True)
    bundle = JST.make_train_step(jreduced(jget_arch("llama2-400m")), jrun,
                                 mesh22, JShape("t", S, GB, "train"))
    lowered = bundle.fn.lower(*bundle.input_shapes)
    hlo = lowered.compile().as_text()
    st = HS.analyze(hlo)
    rec = DR.dryrun_one("llama2-400m", "train_4k", device="cpu",
                        world=DR.parse_world("2x2"),
                        cfg=reduced(get_arch("llama2-400m")),
                        shape=ShapeConfig("t", S, GB, "train"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["collectives"]["bytes_by_kind"]["all-to-all"] \
        == st.coll_bytes["all-to-all"] > 0
    assert rec["collectives"]["counts"]["all-to-all"] \
        == st.coll_counts["all-to-all"]
    # the reference-side quirk (ROADMAP.md C): XLA:CPU compiles the step's
    # bf16 reduce-scatters and all-gathers as f32 ones, so its HLO counts
    # twice the reduce-scatter bytes the program sends, at the same count
    assert rec["collectives"]["counts"]["reduce-scatter"] \
        == st.coll_counts["reduce-scatter"]
    assert st.coll_bytes["reduce-scatter"] \
        == 2 * rec["collectives"]["bytes_by_kind"]["reduce-scatter"]
    assert "bf16" in "".join(l for l in lowered.as_text().splitlines()
                             if "all_gather" in l)
    assert not [l for l in hlo.splitlines()
                if ("reduce-scatter(" in l or "all-gather(" in l)
                and "bf16[" in l.split("=")[1].split("(")[0]]


def _rss_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def test_production_llama_peaks_at_gib_without_the_memory():
    """Full width, 16 x 16, the train_4k shape with its 16 sequences per
    rank in one microbatch (``--microbatch`` 16, the cheap form of the
    same step's tokens): a peak of several GiB on fake tensors, the
    process's resident memory up by under 1 GiB."""
    rss0 = _rss_mib()
    max0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    rec = DR.dryrun_one("llama2-400m", "train_4k", device="cpu",
                        run_overrides={"microbatch": 16})
    # the resident size now, and its high-water mark if this run raised it
    grown = max(_rss_mib() - rss0, resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024 - max(max0, rss0))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16"
    peak = rec["memory"]["peak_bytes"] / 2**30
    assert 2 < peak < 40, peak
    assert grown < 1024, grown
    assert rec["collectives"]["wire_bytes"] > 0
    assert rec["kernels"]["fused_compress"] == rec["kernels"]["dequant_mean"]
