"""The port's hierarchical and multi-tier sync against the JAX reference
(CPU).

Distributed, on spawned gloo groups built by ``launch.mesh.mesh_axes``:
four ranks as pods 2 x data 2, and eight as wans 2 x pods 2 x data 2 (one
spawn each).  The ranks run ``comm.dist_sync`` on hierarchical configs
(the classic loco4 -> naive8 exchange, a 4-bit stage 2, a tensor-scale
codec with gather leaves, onebit, top-k on stage 1, and a tier cadence of
``every=2`` at steps 0 and 1) over two rounds whose error state evolves,
and the bucketed sync of a plan mixing hierarchical and flat buckets
(coalesced, overlapped, per bucket) with its collectives counted; the
8-rank group runs the reference's 3-tier loco8 -> naive8 -> topk 25%
schedule.  The parent runs the reference under ``shard_map`` on the same
numpy gradients and compares: synced shards bit for bit (every leg's mean
is over two peers, one add and an exact halving), f8 states within one f8
quantum on fewer than 5e-3 of the elements (the codec standard of
``tests/test_torch_codec.py``); onebit, whose ``mean|h|`` sums in another
order than XLA's, within the tolerance of ``tests/test_torch_onebit.py``
and bit for bit with the port's own simulation form.  The tier cadence is
also held to DESIGN.md section 16 directly: off cadence each rank keeps
its own pod's mean, on cadence the ungated result.

Static: the ``hier1``/``hier2`` group plans and overlap schedules and the
wire report's tier rows against the reference's; ``sim_sync_hier`` against
the reference's; and the reference's refusals, message for message.
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

from repro.core import buckets as JBK
from repro.core import comm as jcomm
from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro.core import wirepack as JWP
from repro.core.flatparam import MeshTopo as JTopo
from repro.launch import steps as jsteps
from repro.telemetry import wire as JW
from repro_torch.core import buckets as TBK
from repro_torch.core import comm as tcomm
from repro_torch.core import flatparam as TFP
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.core import wirepack as TWP
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.telemetry import wire as TW
from test_torch_codec import _np, assert_f8_close
from test_torch_onebit import assert_bf16_close, assert_shard_close
from test_torch_wirepack import (FP, LOCO4, NAIVET, _count_collectives,
                                 _init_states, _same, make_plan)

PODS, DD = 2, 2
N = PODS * DD
n = N * 1024
N8 = 8
n8 = N8 * 512


def _both(**kw):
    """(reference, port) SyncConfigs of the same fields; ``stage2`` and
    ``tiers`` are given as (strategy, bits, mode[, every]) tuples."""
    def build(side):
        L, Q = ((jloco, jQ), (tloco, tQ))[side]
        k = dict(kw)
        q = k.pop("quant", {})
        s2 = k.pop("stage2", None)
        tiers = k.pop("tiers", None)

        def sub(spec):
            strategy, bits, mode = spec[:3]
            extra = spec[3] if len(spec) > 3 else {}
            return L.SyncConfig(strategy=strategy, quant=Q.QuantConfig(
                bits=bits, mode=mode), **extra)
        if s2 is not None:
            k["stage2"] = sub(s2)
        if tiers is not None:
            k["tiers"] = tuple(L.SyncTier(sub(t[:4]), every=t[4])
                               for t in tiers)
        return L.SyncConfig(quant=Q.QuantConfig(**q), **k)
    return build(0), build(1)


NAIVE8 = ("naive4", 8, "block")
MONO = {   # name: (configs, steps of the two rounds)
    "classic": (_both(strategy="loco", hierarchical=True), (None, None)),
    "hier4": (_both(strategy="loco", hierarchical=True,
                    stage2=("naive4", 4, "block")), (None, None)),
    "tensor": (_both(strategy="naive4", quant=dict(bits=8, mode="tensor"),
                     hierarchical=True), (None, None)),
    "ef": (_both(strategy="ef", hierarchical=True), (None, None)),
    "topk": (_both(strategy="topk", topk_frac=0.05, hierarchical=True),
             (None, None)),
    "onebit": (_both(strategy="onebit", hierarchical=True), (None, None)),
    "cadence": (_both(strategy="loco", hierarchical=True,
                      tiers=(NAIVE8 + ({}, 2),)), (0, 1)),
}
HIER_LOCO4 = _both(strategy="loco", hierarchical=True)
HIER_NAIVET = _both(strategy="naive4", quant=dict(bits=8, mode="tensor"),
                    hierarchical=True)
HIER_LOCO8 = _both(strategy="loco", quant=dict(bits=8), hierarchical=True,
                   stage2=("naive4", 4, "block"))
PLAN = (HIER_LOCO4, LOCO4, LOCO4, HIER_NAIVET, FP, HIER_LOCO8)
TOPK25 = ("topk", 4, "block", {"topk_frac": 0.25})
THREE = {
    "three_tier": (_both(strategy="loco", quant=dict(bits=8),
                         hierarchical=True,
                         tiers=(NAIVE8 + ({}, 1), TOPK25 + (1,))),
                   (None, None)),
    "wan_cadence": (_both(strategy="loco", quant=dict(bits=8),
                          hierarchical=True,
                          tiers=(NAIVE8 + ({}, 1), TOPK25 + (2,))),
                    (0, 1)),
}


def _grads(seed, ranks, length):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((2, ranks, length)).astype(np.float32) * 1e-3
    g[:, 1] *= 30.0     # one rank's scale far larger: per-node scales
    g[:, :, :256] *= 0.01
    return g


def _mono_rounds(name, cfg, rank, world, axes, length):
    st = tloco.init_state(cfg, length)
    out = []
    for step, g in zip(MONO.get(name, THREE.get(name))[1],
                       _grads(len(name), dist.get_world_size(), length)):
        shard, st = tcomm.dist_sync(torch.from_numpy(g[rank]), st, cfg,
                                    world, step=step, axes=axes)
        out.append((tcomm.all_gather_flat(shard, world), st.clone()))
    return out


def _worker4(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    world = dist.group.WORLD
    axes = tmesh.mesh_axes(world, 1, pods=PODS)
    res = {"axes": [(a.name, a.size, a.index,
                     dist.get_process_group_ranks(a.group)) for a in axes]}
    for name, (cfgs, _) in MONO.items():
        res[name] = _mono_rounds(name, cfgs[1], rank, world, axes, n)
    counts = _count_collectives()
    plan = make_plan(PLAN, 1, D=N)
    grads = _grads(99, N, N * plan.chunklen)
    for mode, kw in (("per_bucket", dict(coalesce=False)),
                     ("coalesced", dict(coalesce=True)),
                     ("overlapped", dict(coalesce=True, overlap=True))):
        st = _init_states(plan, False)
        rounds, launches = [], []
        for g in grads:
            before = sum(counts.values())
            shard, st = tcomm.dist_sync_buckets(
                torch.from_numpy(g[rank]), st, plan, world, axes=axes, **kw)
            launches.append(sum(counts.values()) - before)
            rounds.append((tcomm.all_gather_flat(shard, world),
                           tuple(s.clone() for s in st)))
        res[mode] = (rounds, launches)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _worker8(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N8, rdv)
    world = dist.group.WORLD
    axes = tmesh.mesh_axes(world, 1, pods=2, wans=2)
    res = {"axes": [(a.name, a.size, a.index,
                     dist.get_process_group_ranks(a.group)) for a in axes]}
    for name, (cfgs, _) in THREE.items():
        res[name] = _mono_rounds(name, cfgs[1], rank, world, axes, n8)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _spawn(fn, ranks, d):
    tmp.start_processes(fn, args=(str(d / "rdv"), str(d)), nprocs=ranks,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(ranks)]


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    return _spawn(_worker4, N, tmp_path_factory.mktemp("hier4"))


@pytest.fixture(scope="module")
def port8(tmp_path_factory):
    return _spawn(_worker8, N8, tmp_path_factory.mktemp("hier8"))


def _ref_rounds(mesh, axes, cfg, steps, grads):
    def body(g, st, s):
        shard, new = jcomm.dist_sync(g.reshape(-1), st.reshape(-1), cfg,
                                     axes, step=None if s is None else s)
        return jcomm.all_gather_flat(shard, axes), new[None]

    spec = P(axes)
    length = grads.shape[-1]
    st = jnp.stack([jloco.init_state(cfg, length)
                    for _ in range(grads.shape[1])])
    out = []
    for step, g in zip(steps, grads):
        fn = jax.jit(jax.shard_map(
            lambda gg, ss: body(gg, ss, None if step is None
                                else jnp.int32(step)),
            mesh=mesh, in_specs=(spec, spec), out_specs=(P(None), spec),
            check_vma=False))
        full, st = fn(jnp.asarray(g), st)
        out.append((np.asarray(full), st))
    return out


def _check_rounds(got_ranks, want, cfg, name, onebit=False):
    for r, (full, jst) in enumerate(want):
        for rank, got in enumerate(got_ranks):
            got_full, got_st = got[name][r]
            if onebit:
                assert_shard_close(got_full, full)
            else:
                np.testing.assert_array_equal(
                    got_full.numpy(), full, err_msg=f"{name} round {r} "
                    f"rank {rank}")
            if not cfg.needs_state():
                continue
            ref = np.asarray(jst)[rank]
            if got_st.dtype == torch.float8_e4m3fn:
                assert_f8_close(got_st, ref)
            elif onebit:
                assert_bf16_close(got_st, ref)
            else:
                np.testing.assert_array_equal(_np(got_st), _np(ref))


def test_mesh_axes_rank_layout(port4, port8):
    """Global rank ((wan * PODS + pod) * DATA + data) * TP + model: each
    axis's group holds the ranks that differ on that axis only."""
    for rank, res in enumerate(port4):
        (pn, ps, pi, pr), (dn, ds, di, dr) = res["axes"]
        assert (pn, ps, pi, dn, ds, di) == ("pod", 2, rank // 2, "data", 2,
                                            rank % 2)
        assert pr == [rank % 2, rank % 2 + 2]
        assert dr == [rank // 2 * 2, rank // 2 * 2 + 1]
    for rank, res in enumerate(port8):
        assert [(a[0], a[1], a[2]) for a in res["axes"]] == [
            ("wan", 2, rank // 4), ("pod", 2, rank // 2 % 2),
            ("data", 2, rank % 2)]
        assert res["axes"][0][3] == [rank % 4, rank % 4 + 4]


@pytest.mark.parametrize("name", list(MONO))
def test_hierarchical_sync_matches_reference(port4, mesh_pod, name):
    (jcfg, tcfg), steps = MONO[name]
    want = _ref_rounds(mesh_pod, ("pod", "data"), jcfg, steps,
                       _grads(len(name), N, n))
    _check_rounds(port4, want, tcfg, name, onebit=name == "onebit")
    if tcfg.needs_state():   # the state evolved and compensated round 2
        assert float(port4[0][name][1][1].float().abs().max()) > 0


@pytest.mark.parametrize("name", [k for k in MONO if k != "cadence"])
def test_hierarchical_sync_equals_simulation(port4, name):
    """``sim_sync_hier`` is the distributed form on one device, bit for
    bit, over the two rounds (step 1 and 2: no error reset)."""
    (_, tcfg), _ = MONO[name]
    g = _grads(len(name), N, n)
    st = tloco.sim_init(tcfg, N, n)
    for r in range(2):
        ghat, st = tloco.sim_sync_hier(torch.from_numpy(g[r]), st, r + 1,
                                       tcfg, pods=PODS)
        for rank in range(N):
            full, rst = port4[rank][name][r]
            assert _same(full, ghat), (name, r, rank)
            if tcfg.needs_state():
                assert _same(rst, st[rank]), (name, r, rank)


@pytest.mark.parametrize("name", ["classic", "hier4", "tensor", "topk"])
def test_sim_sync_hier_matches_reference(name):
    (jcfg, tcfg), _ = MONO[name]
    g = _grads(len(name), N, n)[0]
    jg, js = jloco.sim_sync_hier(jnp.asarray(g), jloco.sim_init(jcfg, N, n),
                                 jnp.int32(1), jcfg, pods=PODS)
    tg, ts = tloco.sim_sync_hier(torch.from_numpy(g),
                                 tloco.sim_init(tcfg, N, n), 1, tcfg,
                                 pods=PODS)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    if tcfg.needs_state():
        assert_f8_close(ts, js)


def test_tier_cadence_follows_design(port4):
    """DESIGN.md section 16: a tier with ``every=2`` exchanges on steps
    where ``step % 2 == 1``.  Step 0 is off cadence: rank (p, d) keeps pod
    p's stage-1 mean of its chunk, which per pod is the two-node flat
    simulation; step 1 equals the ungated classic exchange."""
    (_, tcfg), _ = MONO["cadence"]
    g = _grads(len("cadence"), N, n)
    flat = dataclasses.replace(tcfg, hierarchical=False, tiers=None)
    want = np.empty(n, np.float32)
    for p in range(PODS):
        ghat, _ = tloco.sim_sync(torch.from_numpy(g[0, 2 * p:2 * p + 2]),
                                 tloco.sim_init(flat, 2, n), 1, flat)
        sl = slice(p * n // 2, (p + 1) * n // 2)
        want[sl] = ghat.numpy()[sl]
    classic = dataclasses.replace(tcfg, tiers=None)
    st0 = tloco.sim_init(tcfg, N, n)
    _, st1 = tloco.sim_sync_hier(torch.from_numpy(g[0]), st0, 1, classic,
                                 pods=PODS)
    on, _ = tloco.sim_sync_hier(torch.from_numpy(g[1]), st1, 1, classic,
                                pods=PODS)
    for rank in range(N):
        np.testing.assert_array_equal(port4[rank]["cadence"][0][0].numpy(),
                                      want)
        assert _same(port4[rank]["cadence"][1][0], on)
    assert not np.array_equal(want, on.numpy())


def test_bucketed_hierarchical_schedules_agree(port4):
    """Coalesced, overlapped and per-bucket syncs of a plan mixing
    hierarchical and flat buckets give the same bits, and the packed ones
    launch what their plans say (the hierarchical legs one collective per
    group, over their axis's group)."""
    plan = make_plan(PLAN, 1, D=N)
    gp = TWP.build_group_plan(plan, N, pods=PODS)
    sched = TWP.build_overlap_schedule(plan, N, pods=PODS)
    assert sched.pipelined
    assert {g.stage for g in gp.groups} == {"flat", "hier1", "hier2"}
    for rank in range(N):
        base, _ = port4[rank]["per_bucket"]
        for mode, launches in (("coalesced", gp.launches()),
                               ("overlapped", sched.launches())):
            rounds, got_launches = port4[rank][mode]
            assert got_launches == [launches, launches], mode
            for (sh, st), (wsh, wst) in zip(rounds, base):
                assert _same(sh, wsh), (mode, rank)
                for s, w in zip(st, wst):
                    assert _same(s, w), (mode, rank)


def test_bucketed_hierarchical_matches_reference(port4, mesh_pod):
    jplan = make_plan(PLAN, 0, D=N)
    axes = ("pod", "data")

    def body(g, *st):
        shard, new = jcomm.dist_sync_buckets(
            g.reshape(-1), tuple(s.reshape(-1) for s in st), jplan, axes)
        return (jcomm.all_gather_flat(shard, axes),) + tuple(
            s[None] for s in new)

    spec = P(axes)
    k = len(jplan.buckets)
    fn = jax.jit(jax.shard_map(body, mesh=mesh_pod, in_specs=(spec,) * (k + 1),
                               out_specs=(P(None),) + (spec,) * k,
                               check_vma=False))
    st = tuple(jnp.stack([jnp.asarray(_np(s)).astype(s_dt)
                          for _ in range(N)])
               for s, s_dt in ((s, jnp.dtype(TWP.dtype_name(s.dtype)))
                               for s in _init_states(make_plan(PLAN, 1, D=N),
                                                     False)))
    # the fp bucket's bf16 reduce-scatter adds four peers in bf16, in an
    # order gloo and XLA choose otherwise: held within one bf16 ulp of its
    # largest value; every codec bucket bit for bit
    C = jplan.chunklen
    fp_cols = np.zeros(N * C, bool)
    for b in jplan.buckets:
        if b.sync.strategy == "fp":
            for rank in range(N):
                fp_cols[rank * C + b.offset:rank * C + b.chunk_end] = True
    for r, g in enumerate(_grads(99, N, N * jplan.chunklen)):
        full, *st = fn(jnp.asarray(g), *st)
        full = np.asarray(full)
        for rank in range(N):
            got, gst = port4[rank]["coalesced"][0][r]
            got = got.numpy()
            np.testing.assert_array_equal(got[~fp_cols], full[~fp_cols])
            np.testing.assert_allclose(
                got[fp_cols], full[fp_cols], rtol=0,
                atol=2.0**-7 * np.abs(full[fp_cols]).max())
            for b, (s, w) in enumerate(zip(gst, st)):
                w = np.asarray(w)[rank]
                if s.dtype == torch.float8_e4m3fn:
                    assert_f8_close(s, w)
                elif s.numel() > 1:
                    np.testing.assert_array_equal(_np(s), _np(w))


@pytest.mark.parametrize("name", list(THREE))
def test_three_tier_schedule_matches_reference(port8, mesh_wan, name):
    (jcfg, tcfg), steps = THREE[name]
    want = _ref_rounds(mesh_wan, ("wan", "pod", "data"), jcfg, steps,
                       _grads(len(name), N8, n8))
    _check_rounds(port8, want, tcfg, name)


def test_three_tier_wan_cadence_keeps_own_group(port8):
    """Off the WAN tier's cadence (step 0) each WAN group keeps its own
    mean: the result differs between the groups and is the 4-rank
    two-tier exchange of the group; on cadence (step 1) every rank holds
    the same synced gradient."""
    off = [port8[r]["wan_cadence"][0][0] for r in range(N8)]
    on = [port8[r]["wan_cadence"][1][0] for r in range(N8)]
    assert all(_same(x, off[0]) for x in off[:4])
    assert all(_same(x, off[4]) for x in off[4:])
    assert all(_same(x, on[0]) for x in on)
    (_, tcfg), _ = THREE["wan_cadence"]
    pod_only = dataclasses.replace(tcfg, tiers=tcfg.tiers[:1])
    g = _grads(len("wan_cadence"), N8, n8)[0]
    st = tloco.sim_init(tcfg, 4, n8)
    for w in range(2):
        ghat, _ = tloco.sim_sync_hier(torch.from_numpy(g[4 * w:4 * w + 4]),
                                      st, 1, pod_only, pods=2)
        sl = slice(w * n8 // 2, (w + 1) * n8 // 2)
        np.testing.assert_array_equal(off[4 * w].numpy()[sl],
                                      ghat.numpy()[sl])


# ---------------------------------------------------------------------------
# static: plans, schedules, the wire report's tier rows
# ---------------------------------------------------------------------------

def _fields(gp):
    return [(g.stage, g.kind, g.peers, g.row_bytes,
             [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype,
               l.count_of) for l in g.leaves]) for g in gp.groups]


LAYOUTS = {
    "hier-flat-fp": (HIER_LOCO4, LOCO4, FP),
    "hier4-tensor": (HIER_LOCO8, NAIVET, HIER_LOCO4),
    "mix": PLAN,
    "onebit": (MONO["onebit"][0], LOCO4, MONO["hier4"][0]),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("D,pods", [(4, 2), (8, 2), (8, 4)])
def test_hier_plans_match_reference(name, D, pods):
    jp, tp = (make_plan(LAYOUTS[name], s, D=D) for s in (0, 1))
    assert _fields(TWP.build_group_plan(tp, D, pods=pods)) == _fields(
        JWP.build_group_plan(jp, D, pods=pods))
    js = JWP.build_overlap_schedule(jp, D, pods=pods)
    ts = TWP.build_overlap_schedule(tp, D, pods=pods)
    assert (ts.n_stages, ts.readiness, ts.comm_groups) == (
        js.n_stages, js.readiness, js.comm_groups)
    for a, b in zip(ts.stages, js.stages):
        assert [(p.run_index, p.slot, p.buckets, p.offset, p.chunk_elems,
                 p.col_off) for p in a.pieces] == [
            (p.run_index, p.slot, p.buckets, p.offset, p.chunk_elems,
             p.col_off) for p in b.pieces]
        assert _fields(a.gplan) == _fields(b.gplan)
        # every port group crosses one process group: one launch each
        assert a.gplan.launches() == len(b.gplan.groups)


def test_hier_plan_refusals_match_reference():
    topk_hier = _both(strategy="topk", hierarchical=True)
    three = THREE["three_tier"][0]
    for cfgs in ((topk_hier,), (three,), (_both(
            strategy="loco", hierarchical=True,
            stage2=("topk", 4, "block")),)):
        with pytest.raises(ValueError) as je:
            JWP.build_group_plan(make_plan(cfgs, 0, D=4), 4, pods=2)
        with pytest.raises(ValueError) as te:
            TWP.build_group_plan(make_plan(cfgs, 1, D=4), 4, pods=2)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("pods,wans", [(1, 1), (2, 1), (2, 2)])
def test_wire_report_tiers_match_reference(pods, wans):
    """Per-bucket ICI/DCN/WAN bytes, the tier rows and the launch counts
    of a plan of flat, hierarchical, 3-tier and top-k buckets equal the
    reference's (the coalesced launches: one per comm group in the port,
    the reference's ``comm_groups``)."""
    D = 8
    wan = _both(strategy="loco", hierarchical=True,
                tiers=(NAIVE8 + ({}, 1), TOPK25 + (4,)))
    topk = _both(strategy="topk", topk_frac=0.05)
    layout = (HIER_LOCO4, LOCO4, FP, topk, HIER_NAIVET) + (
        (wan,) if wans > 1 else ())
    jp = JBK.SyncPlan(params=(make_plan(layout, 0, D=D),))
    tp = TBK.SyncPlan(params=(make_plan(layout, 1, D=D),))
    jr = JW.plan_report(jp, pods=pods, wans=wans)
    tr = TW.plan_report(tp, pods=pods, wans=wans)
    rec_j, rec_t = jr.record(), tr.record()
    for k in ("launches", "t"):
        rec_j.pop(k, None)
        rec_t.pop(k, None)
    assert rec_t == rec_j
    assert [dataclasses.asdict(b) for b in tr.buckets] == [
        dataclasses.asdict(b) for b in jr.buckets]
    jl, tl = JW.plan_launches(jp, pods, wans), TW.plan_launches(tp, pods,
                                                                wans)
    assert (tl["per_bucket"], tl["comm_groups"], tl["pipeline_stages"]) == (
        jl["per_bucket"], jl["comm_groups"], jl["pipeline_stages"])
    if wans == 1:   # a 3-tier bucket launches un-coalesced
        assert tl["coalesced"] == tl["comm_groups"]
    assert TW.format_report(tr) == JW.format_report(jr).replace(
        f"{jr.launches_coalesced} coalesced",
        f"{tr.launches_coalesced} coalesced").replace(
        f"{jr.launches_overlapped} overlapped",
        f"{tr.launches_overlapped} overlapped")


# ---------------------------------------------------------------------------
# the reference's refusals, message for message
# ---------------------------------------------------------------------------

def _raises_same(jfn, tfn):
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    assert str(te.value) == str(je.value)
    return str(te.value)


def test_hierarchical_rejects_unsupported():
    """A one-axis mesh, a strategy without a codec and a stateful stage 2
    raise the reference's errors."""
    ax = (tcomm.MeshAxis("data", None),)
    msg = _raises_same(
        lambda: jcomm.hierarchical_sync(
            jnp.zeros(1024), jnp.zeros(1), jloco.SyncConfig(
                hierarchical=True), ("data",)),
        lambda: tcomm.hierarchical_sync(
            torch.zeros(1024), torch.zeros(1), tloco.SyncConfig(
                hierarchical=True), ax))
    assert "(pod, data) mesh" in msg
    axes2 = (tcomm.MeshAxis("pod", None), tcomm.MeshAxis("data", None))
    _raises_same(
        lambda: jcomm.hierarchical_sync(
            jnp.zeros(1024), jnp.zeros(1), jloco.SyncConfig(
                strategy="ef21", hierarchical=True), ("pod", "data")),
        lambda: tcomm.hierarchical_sync(
            torch.zeros(1024), torch.zeros(1), tloco.SyncConfig(
                strategy="ef21", hierarchical=True), axes2))
    three = THREE["three_tier"][0]
    _raises_same(
        lambda: jcomm.hierarchical_sync(jnp.zeros(1024), jnp.zeros(1),
                                        three[0], ("pod", "data")),
        lambda: tcomm.hierarchical_sync(torch.zeros(1024), torch.zeros(1),
                                        three[1], axes2))
    fp = _both(strategy="fp", hierarchical=True)
    _raises_same(
        lambda: jloco.sim_sync_hier(jnp.zeros((4, 2048)), jnp.zeros((4, 1)),
                                    jnp.int32(0), fp[0], pods=2),
        lambda: tloco.sim_sync_hier(torch.zeros(4, 2048), torch.zeros(4, 1),
                                    0, fp[1], pods=2))
    ob = _both(strategy="loco", hierarchical=True,
               stage2=("onebit", 4, "block"))
    msg = _raises_same(
        lambda: jloco.sim_sync_hier(
            jnp.zeros((4, 2048)), jnp.zeros((4, 2048), jnp.float8_e4m3fn),
            jnp.int32(0), ob[0], pods=2),
        lambda: tloco.sim_sync_hier(
            torch.zeros(4, 2048), torch.zeros(4, 2048,
                                              dtype=torch.float8_e4m3fn),
            0, ob[1], pods=2))
    assert "stateless" in msg


def _topos(dp=4, tp=2, pods=2, wans=1):
    names = (("wan",) if wans > 1 else ()) + ("pod", "data")
    jt = JTopo(dp_axes=names, tp_axis="model", dp=dp, tp=tp, pods=pods,
               wans=wans)
    tt = TFP.MeshTopo(group=None, dp=dp, rank=0, tp=tp, pods=pods, wans=wans,
                      axes=tuple(tcomm.MeshAxis(a, None) for a in names))
    return jt, tt


def _plan_of(cfgs, D=4):
    out = []
    for side in (0, 1):
        BK = (JBK, TBK)[side]
        buckets, off = [], 0
        for i, s in enumerate(cfgs):
            buckets.append(BK.Bucket(index=i, offset=off, chunk_elems=512,
                                     seg_elems=D * 512, sync=s[side]))
            off += 512
        out.append(BK.SyncPlan(params=(BK.ParamPlan(
            group="blocks", name="wq", tensor_class="body", chunklen=off,
            layers=1, buckets=tuple(buckets)),)))
    return out


def _validate_same(run_kw, cfgs=None, topo=None, sync=None):
    jt, tt = topo or _topos()
    jsync, tsync = sync or (jloco.SyncConfig(), tloco.SyncConfig())
    jplan, tplan = _plan_of(cfgs) if cfgs is not None else (None, None)
    return _raises_same(
        lambda: jsteps._validate_sync_configs(
            jsteps.RunConfig(sync=jsync, **run_kw), jplan, jt),
        lambda: tsteps._validate_sync_configs(
            tsteps.RunConfig(sync=tsync, **run_kw), tplan, tt))


def test_validate_rejects_cadence_and_tier_combos():
    """``test_comm_dist.py::test_validate_rejects_cadence_and_tier_combos``
    and the single-pod ``+hier`` refusal, each with the reference's
    message."""
    qb = dict(bits=8, mode="block")
    assert "has no state" in _validate_same(
        {}, sync=_both(strategy="naive4", every=2))
    assert "multiple of" in _validate_same(
        {}, sync=_both(strategy="loco", every=3, reset_every=512))
    wan = _both(strategy="loco", quant=qb, hierarchical=True,
                tiers=(NAIVE8 + ({}, 1), ("topk", 4, "block", {}, 16)))
    assert "--wans >= 2" in _validate_same({}, sync=wan)
    hier_cad = _both(strategy="loco", quant=qb, hierarchical=True,
                     tiers=(NAIVE8 + ({}, 4),))
    assert "--no-coalesce" in _validate_same({}, cfgs=(hier_cad,),
                                             sync=hier_cad)
    jt, tt = _topos()
    jp, tp = _plan_of((hier_cad,))
    tsteps._validate_sync_configs(tsteps.RunConfig(sync=hier_cad[1],
                                                   coalesce=False), tp, tt)
    loco = _both(strategy="loco", quant=qb)
    cad = _both(strategy="loco", quant=qb, every=2)
    naivet = _both(strategy="naive4", quant=dict(bits=8, mode="tensor"))
    assert "--no-overlap" in _validate_same(
        {}, cfgs=(cad, naivet, _both(strategy="fp")), sync=loco)
    topk = _both(strategy="topk")
    assert "--no-overlap" in _validate_same(
        {}, cfgs=(topk, naivet, _both(strategy="fp")), sync=loco)
    one_pod = _topos(dp=2, tp=1, pods=1)
    assert "--pods >= 2" in _validate_same(
        {}, topo=one_pod, sync=_both(strategy="loco", hierarchical=True))
    assert "no meaning for the fp" in _validate_same(
        {}, sync=_both(strategy="fp", hierarchical=True))
    assert "tier 1: stage-2 codec" in _validate_same(
        {}, sync=_both(strategy="loco", hierarchical=True,
                       stage2=("loco", 4, "block")))


# ---------------------------------------------------------------------------
# the simulation forms: ef21, stochastic rounding, the Lemma 2 bound
# ---------------------------------------------------------------------------

def test_ef21_sim_sync_matches_reference():
    """EF21 (simulation only) over two rounds whose estimates evolve."""
    rng = np.random.default_rng(4)
    Nn, d = 2, 2 * 512
    g = (rng.standard_normal((Nn, d)) * 1e-3).astype(np.float32)
    jcfg, tcfg = _both(strategy="ef21")
    jst, tst = jloco.sim_init(jcfg, Nn, d), tloco.sim_init(tcfg, Nn, d)
    for step in (1, 2):
        jg, jst = jloco.sim_sync(jnp.asarray(g * step), jst, jnp.int32(step),
                                 jcfg)
        tg, tst = tloco.sim_sync(torch.from_numpy(g * step), tst, step, tcfg)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(_np(tst), _np(jst))
    with pytest.raises(NotImplementedError):
        with tmesh.dp_group(torch.device("cpu")) as g1:
            tcomm.dist_sync(torch.zeros(1024), torch.zeros(1024,
                                                           dtype=torch.bfloat16),
                            tcfg, g1)


def test_stochastic_rounding_sim_is_unbiased_and_seeded():
    """torch's and jax's generators differ, so stochastic rounding is held
    in distribution: each node rounds with its own generator, one seed
    gives the same bits twice and another seed other bits, and the mean
    over many rounds of a value between two quantization levels tends to
    the value, where round-to-nearest keeps its bias."""
    qc = dict(bits=4, mode="fixed", scale=1.0, stochastic_rounding=True)
    cfg = tloco.SyncConfig(strategy="naive4", quant=tQ.QuantConfig(**qc))
    nearest = tloco.SyncConfig(strategy="naive4", quant=tQ.QuantConfig(
        **dict(qc, stochastic_rounding=False)))
    x = torch.full((2, 512), 0.3)
    st = tloco.sim_init(cfg, 2, 512)

    def draw(seed, step=1):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return tloco.sim_sync(x, st, step, cfg, gen)[0]

    assert torch.equal(draw(7), draw(7))
    assert not torch.equal(draw(7), draw(8))
    assert torch.equal(draw(None, 3), draw(None, 3))   # seeded by the step
    assert not torch.equal(draw(None, 3), draw(None, 4))
    mean = torch.stack([draw(s) for s in range(200)]).mean()
    # 1024 x 200 Bernoulli(0.3) draws: the mean's std is 1.4e-3
    assert abs(float(mean) - 0.3) < 1e-2
    assert float(tloco.sim_sync(x, st, 1, nearest)[0].mean()) == 0.0
    nodes = tloco._node_gens(2, 1, torch.Generator().manual_seed(1), "cpu")
    assert nodes[0].initial_seed() != nodes[1].initial_seed()


def test_deviation_bound_matches_reference():
    for kw in (dict(), dict(reset_every=0), dict(reset_every=64)):
        jcfg, tcfg = _both(**kw)
        for d, k in ((4096, 64), (1 << 20, 512)):
            assert tloco.deviation_bound(tcfg, d, k, 4e-3, 1 / 14) == \
                jloco.deviation_bound(jcfg, d, k, 4e-3, 1 / 14)
