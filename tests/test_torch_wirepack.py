"""The port's wire coalescer (CPU): static plans against the JAX reference,
and the packed exchange against the per-bucket one on a 2-rank gloo group.

``encode_runs`` and ``build_group_plan`` must equal the reference's field
for field (``tests/test_wirepack.py``'s layouts, ported).  Packing is pure
byte views, so pack -> unpack is the identity.  On two spawned ranks,
``dist_sync_buckets`` with ``coalesce=True`` must give the same bits as
``coalesce=False`` (one ``dist_sync`` per bucket) over two rounds whose
state evolves, for every strategy and a mix; run-space states
(``dist_sync_runs``) the same as bucket-space ones; and the coalesced sync
must issue exactly ``WireGroupPlan.launches()`` collectives, counted by
wrapping the all-to-all, all-gather and reduce-scatter calls.  A plan whose
second 4-bit run starts 8 bytes past a 16-byte boundary is synced at D = 1,
where the unpacked leaf must be copied to meet the kernels' alignment.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.core import buckets as JBK
from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro.core import wirepack as JWP
from repro_torch.core import buckets as TBK
from repro_torch.core import codec as tcodec
from repro_torch.core import comm as tcomm
from repro_torch.core import flatparam as TFP
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.core import wirepack as TWP
from repro_torch.kernels import loco_quant as LQ
from repro_torch.launch import mesh as tmesh

N = 2


def _cfg(strategy="loco", bits=4, mode="block", **kw):
    q = dict(bits=bits, mode=mode, scale=2.0**10)
    return (jloco.SyncConfig(strategy=strategy, quant=jQ.QuantConfig(**q),
                             **kw),
            tloco.SyncConfig(strategy=strategy, quant=tQ.QuantConfig(**q),
                             **kw))


LOCO4, LOCO8 = _cfg(), _cfg(bits=8)
EF, NAIVE4 = _cfg("ef"), _cfg("naive4")
NAIVET = _cfg("naive4", bits=8, mode="tensor")   # gather leaf
NAIVEF = _cfg("naive4", mode="fixed")            # static (none) leaf
ONEBIT, FP = _cfg("onebit"), _cfg("fp")
MIX = (LOCO4, LOCO4, LOCO8, NAIVET, ONEBIT, EF, EF, NAIVEF, FP, FP, LOCO4)

CASES = {
    "loco4": (LOCO4,) * 3,
    "loco8": (LOCO8,) * 2,
    "ef": (EF,) * 2,
    "naive4": (NAIVE4,) * 2,
    "onebit": (ONEBIT,) * 2,
    "fp": (FP,) * 2,
    "mix": MIX,
}


def make_plan(cfgs, side, c=512, D=N):
    """A one-parameter plan of buckets of ``c`` elements per rank, in the
    reference's (side 0) or the port's (side 1) types."""
    BK = (JBK, TBK)[side]
    buckets, off = [], 0
    for i, pair in enumerate(cfgs):
        buckets.append(BK.Bucket(index=i, offset=off, chunk_elems=c,
                                 seg_elems=D * c, sync=pair[side]))
        off += c
    return BK.ParamPlan(group="g", name="p", tensor_class="body",
                        chunklen=off, layers=1, buckets=tuple(buckets))


def _sync_fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("use_kernels", None)
    return d


# ---------------------------------------------------------------------------
# static plans
# ---------------------------------------------------------------------------

LAYOUTS = {
    "fusion": (LOCO4, LOCO4, LOCO8, LOCO8, NAIVET, NAIVET, ONEBIT, FP, FP,
               EF, EF, NAIVEF, NAIVEF),
    "mix": MIX,
    "uniform": (LOCO4,) * 6,
    "fp-only": (FP,) * 3,
    "interleaved": (LOCO4, FP, LOCO4, FP, LOCO8),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_encode_runs_match_reference(name):
    jr = JWP.encode_runs(make_plan(LAYOUTS[name], 0, D=4))
    tr = TWP.encode_runs(make_plan(LAYOUTS[name], 1, D=4))
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert (a.slot, a.buckets, a.positions, a.offset, a.chunk_elems,
                a.chunk_total, a.fused) == (
            b.slot, b.buckets, b.positions, b.offset, b.chunk_elems,
            b.chunk_total, b.fused)
        assert _sync_fields(a.sync) == _sync_fields(b.sync)
    if name == "fusion":
        assert [r.buckets for r in tr] == [
            (0, 1), (2, 3), (4,), (5,), (6,), (7, 8), (9, 10), (11, 12)]


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("c", [512, 1536])
def test_group_plan_matches_reference(name, D, c):
    jg = JWP.build_group_plan(make_plan(LAYOUTS[name], 0, c, D), D, pods=1)
    tg = TWP.build_group_plan(make_plan(LAYOUTS[name], 1, c, D), D)
    assert len(tg.groups) == len(jg.groups)
    for a, b in zip(tg.groups, jg.groups):
        assert (a.stage, a.kind, a.peers, a.row_bytes) == (
            b.stage, b.kind, b.peers, b.row_bytes)
        assert [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype)
                for l in a.leaves] == [
            (l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype)
            for l in b.leaves]
    assert tg.launches() == jg.launches(axes=1)


def test_group_plan_refusals():
    b = TBK.Bucket(index=0, offset=0, chunk_elems=384, seg_elems=4 * 384,
                   sync=LOCO4[1])
    bad = TBK.ParamPlan(group="g", name="p", tensor_class="body",
                        chunklen=384, layers=1, buckets=(b,))
    with pytest.raises(ValueError, match="512-aligned"):
        TWP.build_group_plan(bad, 4)
    # hierarchical and top-k runs are ported: their group plans are the
    # reference's (one pod: stage 1 over the whole group, stage 2 over one
    # peer; the ragged top-k leaves with their count leaf)
    for kw in (dict(hierarchical=True), dict(strategy="topk")):
        pair = (jloco.SyncConfig(**kw), tloco.SyncConfig(**kw))
        jg = JWP.build_group_plan(make_plan((pair, LOCO4), 0, D=4), 4,
                                  pods=1)
        tg = TWP.build_group_plan(make_plan((pair, LOCO4), 1, D=4), 4)
        assert [(g.stage, g.kind, g.peers, g.row_bytes,
                 [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype,
                   l.count_of) for l in g.leaves]) for g in tg.groups] == [
            (g.stage, g.kind, g.peers, g.row_bytes,
             [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype,
               l.count_of) for l in g.leaves]) for g in jg.groups]


def _wires(plan, seed=0):
    wires = {}
    gen = torch.Generator().manual_seed(seed)
    for run in TWP.encode_runs(plan):
        if run.sync.strategy == "fp":
            continue
        codec = tcodec.get_codec(run.sync)
        n = plan.buckets[0].seg_elems // plan.buckets[0].chunk_elems \
            * run.chunk_total
        g = torch.randn(n, generator=gen) * 1e-3
        wires[run.slot], _ = codec.encode(g, tloco.init_state(run.sync, n))
    return wires


def test_pack_unpack_roundtrip_local():
    plan = make_plan(MIX, 1, D=4)
    gp = TWP.build_group_plan(plan, 4)
    wires = _wires(plan)
    a2a = gp.group("flat", "a2a")
    buf = TWP.pack_a2a(a2a, wires)
    assert buf.dtype == torch.uint8 and buf.shape == (4, a2a.row_bytes)
    back = TWP.unpack_a2a(a2a, buf)
    for l in a2a.leaves:
        got, want = back[l.bucket][l.name], wires[l.bucket][l.name]
        assert got.dtype == want.dtype and got.data_ptr() % 16 == 0
        assert torch.equal(TWP.to_bytes(got), TWP.to_bytes(want))
    gg = gp.group("flat", "gather")
    gbuf = TWP.pack_gather(gg, wires)
    assert gbuf.shape == (gg.row_bytes,)
    shapes = {l.bucket: {l.name: wires[l.bucket][l.name].shape}
              for l in gg.leaves}
    back = TWP.unpack_gather(gg, gbuf.expand(gg.peers, -1), shapes)
    for l in gg.leaves:
        for p in range(gg.peers):
            assert torch.equal(back[l.bucket][l.name][p],
                               wires[l.bucket][l.name])
    rg = gp.group("flat", "reduce")
    segs = {l.bucket: torch.randn(4 * l.elems).to(torch.bfloat16)
            for l in rg.leaves}
    packed = TWP.pack_reduce(rg, segs).reshape(4, -1)
    shard = packed[1]    # what peer 1 would receive from a lone sender
    for slot, sh in TWP.unpack_reduce(rg, shard).items():
        assert torch.equal(sh, segs[slot].reshape(4, -1)[1])


def test_fuse_split_run_states_roundtrip():
    plan = make_plan(MIX, 1, D=4)
    states = tuple(torch.randn(3, b.seg_elems).to(tloco.state_dtype(b.sync))
                   if b.sync.needs_state() else torch.zeros(3, 1)
                   for b in plan.buckets)
    runs = TFP.fuse_run_states(plan, states, 4)
    units = TFP.state_units(plan, True)
    assert [tuple(r.shape) for r in runs] == [
        (3, TFP.bucket_state_struct(u)[0]) for u in units]
    for a, b in zip(TFP.split_run_states(plan, runs, 4), states):
        assert torch.equal(TWP.to_bytes(a), TWP.to_bytes(b))


# ---------------------------------------------------------------------------
# the packed exchange on two ranks
# ---------------------------------------------------------------------------

def _grads(rounds, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((rounds, N, n)).astype(np.float32) * 1e-3
    g[:, 1, :256] *= 300.0   # one peer's block far larger
    return g


def _count_collectives():
    """Wrap the three collectives core/comm issues; returns the counter."""
    counts = {"a2a": 0, "gather": 0, "reduce": 0}

    def wrap(fn, key):
        def call(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return call

    dist.all_to_all_single = wrap(dist.all_to_all_single, "a2a")
    tcomm._ALL_GATHER = wrap(tcomm._ALL_GATHER, "gather")
    tcomm._REDUCE_SCATTER = wrap(tcomm._REDUCE_SCATTER, "reduce")
    return counts


def _init_states(plan, coalesce):
    return tuple(torch.zeros(n, dtype=dt) for n, dt in map(
        TFP.bucket_state_struct, TFP.state_units(plan, coalesce)))


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    group = dist.group.WORLD
    counts = _count_collectives()
    res = {}
    for name, cfgs in CASES.items():
        plan = make_plan(cfgs, 1)
        grads = _grads(2, N * plan.chunklen, len(name))
        out = {}
        for mode in ("coalesced", "per_bucket", "runs"):
            st = _init_states(plan, mode == "runs")
            rounds, launches = [], []
            for r, (g, dt) in enumerate(zip(grads, (torch.float32,
                                                    torch.bfloat16))):
                g = torch.from_numpy(g[rank]).to(dt)
                for k in counts:
                    counts[k] = 0
                if mode == "runs":
                    sh, st = tcomm.dist_sync_runs(
                        g, tuple(s.clone() for s in st), plan, group,
                        out_dtype=dt, inplace=True)
                    st_b = TFP.split_run_states(plan, st, N)
                else:
                    sh, st = tcomm.dist_sync_buckets(
                        g, st, plan, group, coalesce=mode == "coalesced",
                        out_dtype=dt)
                    st_b = st
                launches.append(dict(counts))
                rounds.append((sh.clone(), tuple(s.clone() for s in st_b)))
            out[mode] = (rounds, launches)
        res[name] = out
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("wirepack")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=N,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(N)]


def _same(a, b):
    return torch.equal(TWP.to_bytes(a), TWP.to_bytes(b))


@pytest.mark.parametrize("name", list(CASES))
def test_coalesced_matches_per_bucket(port, name):
    for rank in range(N):
        got, want = (port[rank][name][m][0]
                     for m in ("coalesced", "per_bucket"))
        for r, ((sh, st), (wsh, wst)) in enumerate(zip(got, want)):
            assert sh.dtype == (torch.float32, torch.bfloat16)[r]
            assert _same(sh, wsh), f"round {r} rank {rank}: shard"
            for b, (s, w) in enumerate(zip(st, wst)):
                assert _same(s, w), f"round {r} rank {rank}: bucket {b}"
        # the state evolved, and round 2 compensated round 1's error
        if any(c[1].needs_state() for c in CASES[name]):
            assert any(float(s.float().abs().max()) > 0 for s in got[1][1])


@pytest.mark.parametrize("name", list(CASES))
def test_run_space_matches_bucket_space(port, name):
    for rank in range(N):
        got, want = (port[rank][name][m][0] for m in ("runs", "coalesced"))
        for (sh, st), (wsh, wst) in zip(got, want):
            assert _same(sh, wsh)
            assert all(_same(s, w) for s, w in zip(st, wst))


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_per_sync_equal_plan_launches(port, name):
    gp = TWP.build_group_plan(make_plan(CASES[name], 1), N)
    want = {"a2a": int(gp.group("flat", "a2a") is not None),
            "gather": int(gp.group("flat", "gather") is not None),
            "reduce": int(gp.group("flat", "reduce") is not None)}
    assert sum(want.values()) == gp.launches()
    for rank in range(N):
        for mode in ("coalesced", "runs"):
            assert port[rank][name][mode][1] == [want, want]
    per_bucket = sum(port[0][name]["per_bucket"][1][0].values())
    assert per_bucket >= gp.launches()
    if name == "loco4":     # three buckets, one fused run
        assert (gp.launches(), per_bucket) == (1, 3)


# ---------------------------------------------------------------------------
# a leaf packed at 8 mod 16 bytes (D = 1)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield g


def test_misaligned_leaf_is_copied(group1):
    """Two non-fp runs of 512 elements in one a2a group: the first run's
    4-bit payload (256 B) and scales (8 B) put the second run's payload at
    byte 264 = 8 mod 16.  At D = 1 its unpacked view would be misaligned
    for dequant_mean (which refuses such a view on any device); the
    unpack copies that leaf only, and the sync equals the per-bucket one."""
    plan = make_plan((LOCO4, LOCO8, LOCO4), 1, D=1)
    gp = TWP.build_group_plan(plan, 1)
    a2a = gp.group("flat", "a2a")
    assert [(l.bucket, l.name, l.offset % 16) for l in a2a.leaves] == [
        (0, "payload", 0), (0, "scales", 0), (1, "payload", 8),
        (1, "scales", 8), (2, "payload", 0), (2, "scales", 0)]
    wires = _wires(plan)
    buf = TWP.pack_a2a(a2a, wires)
    raw = TWP.from_bytes(buf[:, 264:264 + 512], torch.int8)
    assert raw.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        LQ.dequant_mean(raw, torch.zeros(1, 2), bits=8)
    back = TWP.unpack_a2a(a2a, buf)
    assert back[1]["payload"].data_ptr() % 16 == 0
    assert back[0]["payload"].data_ptr() == buf.data_ptr()     # not copied
    assert back[2]["payload"].data_ptr() == buf.data_ptr() + 784
    g = (torch.from_numpy(_grads(1, plan.chunklen, 7)[0, 0])
         .to(torch.bfloat16))
    outs = []
    for co in (True, False):
        st = _init_states(plan, False)
        outs.append(tcomm.dist_sync_buckets(g, st, plan, group1,
                                            coalesce=co,
                                            out_dtype=torch.bfloat16))
    assert _same(outs[0][0], outs[1][0])
    assert all(_same(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_bucketed_gathers_agree(group1):
    """The three bucketed gathers (run-space, bucket-space coalesced,
    per-bucket) give the same gradient and states, written into the
    caller's buffers; under a uniform plan they equal the monolithic
    gather's."""
    from repro_torch.core import hijack as TH

    def run(plan, gather, coalesce):
        C = plan.chunklen
        w = (torch.arange(C, dtype=torch.float32) / C).to(torch.bfloat16)
        w.requires_grad_()
        st = _init_states(plan, coalesce)
        ptrs = [s.data_ptr() for s in st]
        coef = torch.from_numpy(_grads(1, C, 3)[0, 0]).to(torch.bfloat16)
        for step in range(2):
            (gather(w, st) * coef * (step + 1)).sum().backward()
        assert [s.data_ptr() for s in st] == ptrs
        return w.grad, (st if coalesce else TFP.fuse_run_states(plan, st, 1))

    for cfgs, uniform in ((MIX, False), ((LOCO4,) * 3, True)):
        plan = make_plan(cfgs, 1, D=1)
        outs = [run(plan, lambda w, st: TH.gather_with_sync_runs(
                    w, st, plan, group1), True),
                run(plan, lambda w, st: TH.gather_with_sync_buckets(
                    w, st, plan, group1), False),
                run(plan, lambda w, st: TH.gather_with_sync_buckets(
                    w, st, plan, group1, coalesce=False), False)]
        if uniform:                 # the monolithic gather
            outs.append(run(plan, lambda w, st: TH.gather_with_sync(
                w, st[0], LOCO4[1], group1), True))
        for g, st in outs[1:]:
            assert _same(g, outs[0][0])
            assert all(_same(a, b) for a, b in zip(st, outs[0][1]))
        assert outs[0][0].abs().max() > 0
