"""The port's backward-overlapped stage schedule (CPU).

Static: ``build_overlap_schedule`` (``tests/test_overlap.py``'s geometry
cases, ported: chunk-space partition, atomic non-fusible runs, the
degenerate single stage, per-stage launch accounting, readiness at bucket
ends) and stage for stage equal to the reference's over the layouts of
``tests/test_torch_wirepack.py``; ``plan_launches``' overlapped count
equal to the reference's on real plans.

Distributed, dp = 2 on two spawned gloo ranks: the overlapped
``dist_sync_runs`` (pieces cut from a run's peer-major state buffer) and
``dist_sync_buckets`` give the same bits as the flat schedule over two
rounds whose state evolves, and issue the schedule's launches; the
overlapped shards equal the reference's ``dist_sync_runs(overlap=True)``
bit for bit and its f8 states within one f8 quantum on fewer than 5e-3 of
the elements (ROADMAP's codec standard).  At D = 1 a piece's state is a
view of its run's buffer, written in place.  The reference's refusals
(overlap without coalesce, cadence on a pipelined schedule) hold, and in
training the overlapped and the flat schedule give the same losses.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import policy as JPOL
from repro.core import wirepack as JWP
from repro.core.flatparam import MeshTopo as JTopo
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.telemetry import wire as JWIRE
from repro_torch.configs.base import get_arch, reduced as treduced
from repro_torch.core import buckets as TBK
from repro_torch.core import comm as tcomm
from repro_torch.core import flatparam as TFP
from repro_torch.core import policy as TPOL
from repro_torch.core import wirepack as TWP
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import build_groups
from repro_torch.telemetry import wire as TWIRE
from test_torch_bucketed_train import (_assert_state_close, _bf16_grads,
                                       _reference_sync)
from test_torch_wirepack import (EF, FP, LAYOUTS, LOCO4, LOCO8, NAIVET,
                                 ONEBIT, _cfg, _count_collectives,
                                 _init_states, _same, _sync_fields,
                                 make_plan)

N = 2

# ---------------------------------------------------------------------------
# schedule geometry (tests/test_overlap.py, ported)
# ---------------------------------------------------------------------------


def test_schedule_partitions_chunk_space():
    sched = TWP.build_overlap_schedule(make_plan((LOCO4,) * 4, 1), 2)
    assert sched.n_stages == 2 and sched.pipelined
    assert sched.readiness == (1024, 2048)
    (p0,), (p1,) = (st.pieces for st in sched.stages)
    assert p0.buckets == (0, 1) and p1.buckets == (2, 3)
    assert p0.run_index == p1.run_index == 0
    assert (p0.col_off, p1.col_off) == (0, 1024)
    assert p0.run_total == p1.run_total == 2048
    assert not p0.whole and not p1.whole
    assert p1.offset == p0.offset + p0.chunk_total


def test_schedule_atomic_nonfusible_runs():
    plan = make_plan((NAIVET, ONEBIT, LOCO4, LOCO4), 1)
    pieces = [p for st in TWP.build_overlap_schedule(plan, 2).stages
              for p in st.pieces]
    by_slot = {p.slot: p for p in pieces}
    assert by_slot[0].whole and by_slot[0].buckets == (0,)
    assert by_slot[1].whole and by_slot[1].buckets == (1,)
    assert sum(len(p.buckets) for p in pieces) == 4


@pytest.mark.parametrize("cfgs", [(LOCO4,), (NAIVET,)],
                         ids=["one-bucket", "one-atomic-run"])
def test_schedule_degenerate_single_stage(cfgs):
    sched = TWP.build_overlap_schedule(make_plan(cfgs, 1), 2)
    assert sched.n_stages == 1 and not sched.pipelined


def test_schedule_launch_accounting():
    plan = make_plan((LOCO4, NAIVET, FP, FP), 1)
    s0, s1 = TWP.build_overlap_schedule(plan, 2).stages
    assert [p.slot for p in s0.pieces] == [0, 1]
    assert [p.buckets for p in s1.pieces] == [(2, 3)]
    assert {g.kind for g in s0.gplan.groups} == {"a2a", "gather"}
    assert {g.kind for g in s1.gplan.groups} == {"reduce"}
    sched = TWP.build_overlap_schedule(plan, 2)
    assert sched.comm_groups == sched.launches() == 3
    assert {g.kind for st in sched.stages for g in st.gplan.groups} == {
        g.kind for g in TWP.build_group_plan(plan, 2).groups}
    got = TWIRE.plan_launches(TBK.SyncPlan(params=(
        make_plan((LOCO4,) * 4, 1),)))
    assert (got["coalesced"], got["overlapped"],
            got["pipeline_stages"]) == (1, 2, 2)


def test_schedule_readiness_uses_bucket_ends():
    plan = make_plan((LOCO4, LOCO8, LOCO4, LOCO8), 1)
    ends = {b.chunk_end for b in plan.buckets}
    sched = TWP.build_overlap_schedule(plan, 2)
    assert set(sched.readiness) <= ends
    assert sched.readiness[-1] == plan.chunklen


def _stage_fields(st):
    pieces = [(p.run_index, p.slot, p.buckets, p.positions, p.offset,
               p.chunk_elems, p.col_off, p.run_total, p.whole, p.fused,
               _sync_fields(p.sync)) for p in st.pieces]
    groups = [(g.stage, g.kind, g.peers, g.row_bytes,
               [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype)
                for l in g.leaves]) for g in st.gplan.groups]
    return st.index, st.ready, pieces, groups, st.gplan.launches()


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("c", [512, 1536])
def test_schedule_matches_reference(name, D, c):
    js = JWP.build_overlap_schedule(make_plan(LAYOUTS[name], 0, c, D), D,
                                    pods=1)
    ts = TWP.build_overlap_schedule(make_plan(LAYOUTS[name], 1, c, D), D)
    assert (ts.n_stages, ts.readiness, ts.chunklen, ts.comm_groups) == (
        js.n_stages, js.readiness, js.chunklen, js.comm_groups)
    assert ts.launches() == js.launches(axes=1)
    for a, b in zip(ts.stages, js.stages):
        jf = list(_stage_fields(b))
        jf[4] = b.gplan.launches(axes=1)
        assert _stage_fields(a) == tuple(jf)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("policy,bucket_mb,reduced", [
    ("embed=loco8,min=16384", 0.1, True),
    ("embed=loco8,norm=fp,body=loco4", 0.0625, True),
    ("embed=loco8,min=1048576", 4, False),
], ids=["reduced-mix", "reduced-classes", "llama2-400m-path-d"])
def test_plan_report_matches_reference(dp, policy, bucket_mb, reduced):
    """The wire report's launch counts (overlapped and pipeline depth
    included) equal the reference's on real plans, full llama2-400m
    (``chip_smoke.py``'s path d) included: building a plan allocates
    nothing."""
    jcfg, tcfg = jget_arch("llama2-400m"), get_arch("llama2-400m")
    if reduced:
        jcfg, tcfg = jreduced(jcfg), treduced(tcfg)
    nbytes = int(bucket_mb * (1 << 20))
    jrun = jsteps.RunConfig(sync=JSync(), bucket_bytes=nbytes,
                            policy=JPOL.parse_policy(policy, JSync()))
    trun = tsteps.RunConfig(sync=SyncConfig(), bucket_bytes=nbytes,
                            policy=TPOL.parse_policy(policy, SyncConfig()))
    jplan = jsteps.build_sync_plan(
        jrun, jsteps.build_model(jcfg, 1).groups(),
        JTopo(dp_axes=("data",), tp_axis="model", dp=dp, tp=1))
    tplan = tsteps.build_sync_plan(trun, build_groups(tcfg, 1),
                                   types.SimpleNamespace(dp=dp, tp=1))
    jl, tl = JWIRE.plan_launches(jplan), TWIRE.plan_launches(tplan)
    assert tl == {k: jl[k] for k in tl}
    jr, tr = JWIRE.plan_report(jplan), TWIRE.plan_report(tplan)
    assert (tr.launches_overlapped, tr.pipeline_stages) == (
        jr.launches_overlapped, jr.pipeline_stages)
    assert "overlapped across" in TWIRE.format_report(tr)
    if not reduced and dp == 1:     # the numbers chip_smoke.py asserts
        assert (tl["coalesced"], tl["overlapped"]) == (244, 246)


# ---------------------------------------------------------------------------
# dp = 2: overlapped vs flat vs the reference
# ---------------------------------------------------------------------------

CASES = {
    "uniform": (LOCO4,) * 3,             # one fused run, cut by the stage
    "mix": (LOCO4, LOCO4, LOCO8, NAIVET, EF, EF, FP, FP, LOCO4),
    "loco8-fp": (LOCO8, LOCO8, LOCO8, FP),
    # atomic runs; onebit's mean |h| sums in another order than XLA's
    # (within one bf16 ulp, test_torch_onebit), so not held to the
    # reference bit for bit
    "atomic": (ONEBIT, LOCO4, LOCO4, NAIVET, EF),
}
REFERENCE_CASES = [n for n in CASES if n != "atomic"]


def _rounds(plan, grads, rank, group, runs, overlap, counts):
    st = _init_states(plan, runs)
    out = []
    for g in grads:
        for k in counts:
            counts[k] = 0
        g = torch.from_numpy(g[rank]).to(torch.bfloat16)
        if runs:
            sh, st = tcomm.dist_sync_runs(
                g, tuple(s.clone() for s in st), plan, group,
                overlap=overlap, inplace=True)
        else:
            sh, st = tcomm.dist_sync_buckets(g, st, plan, group,
                                             overlap=overlap)
        launched = dict(counts)
        out.append((tcomm.all_gather_flat(sh, group),
                    tuple(s.clone() for s in st), launched))
    return out


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    group = dist.group.WORLD
    counts = _count_collectives()
    res = {}
    for name, cfgs in CASES.items():
        plan = make_plan(cfgs, 1)
        grads = _bf16_grads(name, N * plan.chunklen)
        res[name] = {(runs, ov): _rounds(plan, grads, rank, group, runs, ov,
                                         counts)
                     for runs in (True, False) for ov in (True, False)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=N,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(N)]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("runs", [True, False], ids=["runs", "buckets"])
def test_overlapped_matches_flat(port, name, runs):
    plan = make_plan(CASES[name], 1)
    sched = TWP.build_overlap_schedule(plan, N)
    assert sched.pipelined
    for rank in range(N):
        got, want = port[rank][name][(runs, True)], \
            port[rank][name][(runs, False)]
        for r, ((sh, st, n_ov), (wsh, wst, n_flat)) in enumerate(
                zip(got, want)):
            assert torch.equal(sh, wsh), f"round {r} rank {rank}"
            assert len(st) == len(wst)
            assert all(_same(a, b) for a, b in zip(st, wst)), \
                f"round {r} rank {rank}: states"
            assert sum(n_ov.values()) == sched.launches()
            assert sum(n_flat.values()) == \
                TWP.build_group_plan(plan, N).launches()
        assert any(float(s.float().abs().max()) > 0 for s in got[1][1])


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_overlapped_matches_reference(port, mesh22, name):
    plan = make_plan(CASES[name], 0)
    want = _reference_sync(mesh22, plan,
                           _bf16_grads(name, N * plan.chunklen), True)
    for r, (full, jst) in enumerate(want):
        for rank in range(N):
            got_full, got_st, _ = port[rank][name][(True, True)][r]
            np.testing.assert_array_equal(got_full.numpy(), full,
                                          err_msg=f"round {r} rank {rank}")
            for s, js in zip(got_st, jst):
                _assert_state_close(s, np.asarray(js)[rank])


# ---------------------------------------------------------------------------
# D = 1: a piece's state is a view of its run's buffer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield g


def test_piece_state_written_in_place_at_d1(group1):
    plan = make_plan((LOCO4,) * 4 + (FP,), 1, D=1)
    sched = TWP.build_overlap_schedule(plan, 1)
    cut = [p for st in sched.stages for p in st.pieces if not p.whole]
    assert cut and cut[-1].col_off > 0
    g = torch.from_numpy(_bf16_grads("d1", plan.chunklen)[0, 0]).to(
        torch.bfloat16)
    outs = []
    for ov in (True, False):
        st = _init_states(plan, True)
        ptrs = [s.data_ptr() for s in st]
        for _ in range(2):
            sh, ns = tcomm.dist_sync_runs(g, st, plan, group1, overlap=ov,
                                          out_dtype=torch.bfloat16,
                                          inplace=True)
            assert [s.data_ptr() for s in ns] == ptrs
            st = ns
        outs.append((sh, st))
    assert _same(outs[0][0], outs[1][0])
    assert all(_same(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    # out of place, the caller's buffers stay as they were
    st = _init_states(plan, True)
    _, ns = tcomm.dist_sync_runs(g, st, plan, group1, overlap=True)
    assert not st[0].float().any() and ns[0].float().any()


# ---------------------------------------------------------------------------
# refusals, and training
# ---------------------------------------------------------------------------

def test_overlap_requires_coalesce(group1):
    plan = make_plan((LOCO4, LOCO4), 1, D=1)
    with pytest.raises(ValueError, match="coalesce"):
        tcomm.dist_sync_buckets(torch.zeros(plan.chunklen),
                                _init_states(plan, False), plan, group1,
                                coalesce=False, overlap=True)


def test_cadence_refused_on_pipelined_schedule(group1):
    every2 = (_cfg(every=2), _cfg(every=2), _cfg(every=2))
    plan = make_plan(every2, 1, D=1)
    g = torch.zeros(plan.chunklen)
    with pytest.raises(ValueError, match="cadence every=2"):
        tcomm.dist_sync_runs(g, _init_states(plan, True), plan, group1,
                             step=0, overlap=True)
    tcomm.dist_sync_runs(g, _init_states(plan, True), plan, group1, step=0,
                         overlap=False)
    # at build time, with the parameter named; --no-overlap runs it
    sync = SyncConfig()
    run = tsteps.RunConfig(sync=sync, bucket_bytes=int(0.1 * (1 << 20)),
                           policy=TPOL.parse_policy("body=loco4+every2",
                                                    sync))
    topo = TFP.MeshTopo(group=None, dp=1, rank=0)
    cfg = ttrain.make_cfg(ttrain.build_args(["--arch", "llama2-400m",
                                             "--reduced"]))
    plan = tsteps.build_sync_plan(run, build_groups(cfg, 1), topo)
    with pytest.raises(ValueError,
                       match=r"\w+/\w+: bucket \d+ .*--no-overlap"):
        tsteps._validate_sync_configs(run, plan, topo)
    tsteps._validate_sync_configs(dataclasses.replace(run, overlap=False),
                                  plan, topo)


def test_cli_overlap_is_default_and_bit_exact(group1, capsys):
    argv = ["--arch", "llama2-400m", "--reduced", "--seq-len", "32",
            "--global-batch", "8", "--microbatch", "2", "--steps", "3",
            "--warmup", "2", "--lr", "2e-3", "--bucket-mb", "0.1",
            "--policy", "embed=loco8,min=16384", "--device", "cpu"]
    assert ttrain.build_args(argv).overlap
    assert ttrain.make_run(ttrain.build_args(argv)).overlap
    ov = ttrain.main(argv)["losses"]
    assert "overlapped across 2 pipeline stages" in capsys.readouterr().out
    assert ttrain.main(argv + ["--no-overlap"])["losses"] == ov
    assert ttrain.main(argv + ["--no-coalesce"])["losses"] == ov
    assert all(np.isfinite(ov)) and ov[-1] < ov[0]


def test_profiler_stage_ranges():
    from repro_torch.telemetry import profiler as PROF

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with PROF.phase("encode", group=1):
            torch.ones(4).sum()
        with PROF.phase("exchange"):
            pass
    names = {e.key for e in prof.key_averages()}
    assert {"loco/encode/g1", "loco/exchange"} <= names
