"""The port's step analysis (``repro_torch.analysis``) against the JAX
reference's (``repro.analysis``), on the CPU.

* wire bytes: every collective kind over 2, 16 and 256 ranks, dispatched on
  fake tensors over a fake process group and counted by ``OpStats``,
  equals ``hlo_stats._collective_wire`` of the matching HLO line;
* a toy step's FLOPs are the closed form and its bytes the hand sum under
  the port's rule (every op that launches work: its inputs plus its
  outputs; views free);
* the overlap cases of ``tests/test_analysis.py`` built from dispatched
  ops (partial hide, full hide, a synchronous collective exposing all),
  and the comm hooks of a bucketed overlapped step;
* ``roofline_terms``'s dominance on the H100 constants;
* ``report``'s tables equal the reference's on the same records but for
  the fit mark, which a peak between 16 GiB and the H100's memory shows.

Tolerances are 0 (exact equality) throughout.
"""
import contextlib

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import hlo_stats as HS
from repro.analysis import report as JREPORT
from repro.analysis import roofline as JRL
from repro_torch.analysis import op_stats as OS
from repro_torch.analysis import report as REPORT
from repro_torch.analysis import roofline as RL
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.launch import dryrun as DR

UNIT = dict(peak_flops=1.0, hbm_bw=1.0, link_bw=1.0)


@contextlib.contextmanager
def fake_pg(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _run_collective(kind: str, n: int, nbytes: int) -> OS.OpStats:
    """One collective of ``kind`` over ``n`` fake ranks whose per-rank
    output is ``nbytes`` f32 bytes, counted by OpStats."""
    numel = nbytes // 4
    with fake_pg(n) as g, FakeTensorMode(), OS.OpStats("cpu") as st:
        if kind == "all-gather":
            x = torch.zeros(numel // n)
            dist.all_gather_single(torch.empty(numel), x, group=g)
        elif kind == "reduce-scatter":
            x = torch.zeros(numel * n)
            dist.reduce_scatter_single(torch.empty(numel), x, group=g)
        elif kind == "all-reduce":
            dist.all_reduce(torch.zeros(numel), group=g)
        else:
            x = torch.zeros(n, numel // n)
            dist.all_to_all_single(torch.empty_like(x), x, group=g)
    return st


@pytest.mark.parametrize("n", [2, 16, 256])
@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all"])
def test_wire_bytes_are_the_references(kind, n):
    nbytes = 4 * 1024 * 256
    st = _run_collective(kind, n, nbytes)
    line = (f"f32[{nbytes // 4}]{{0}}",
            f"%p0), replica_groups=[1,{n}]<=[{n}], dimensions={{0}}")
    want = HS._collective_wire(kind, *line)
    assert st.coll_counts == {kind: 1}
    assert st.coll_bytes[kind] == want == st.wire_bytes
    assert OS.collective_wire(kind, nbytes, n) == want


@pytest.mark.parametrize("n", [2, 16, 256])
def test_permute_wire_is_the_references(n):
    line = ("f32[1024]{0}", f"%p0), source_target_pairs={{{{0,1}}}}")
    assert OS.collective_wire("collective-permute", 4096, n) \
        == HS._collective_wire("collective-permute", *line) == 4096


def test_toy_step_flops_and_bytes():
    """``y = x @ w; (y * y).sum().backward()`` with ``w`` a leaf, f32:
    forward mm (2BKN flops), backward mm for dL/dw (2BKN); no other dot.
    Bytes, op by op under the rule (inputs + outputs, by numel):

      mm       x, w -> y            4(BK + KN + BN)
      mul      y, y -> z            4(3 BN)
      sum      z -> ()              4(BN + 1)
      ones_like () -> ()            4(1 + 1)
      expand   (view)               0
      mul      g, y -> gy           4(3 BN)       (dz/dy = 2 y g: two muls
      mul      g, y -> gy'          4(3 BN)        and an add)
      add      gy, gy' -> gy2       4(3 BN)
      mm       x^T, gy2 -> dw       4(BK + BN + KN)
    """
    B, K, N = 8, 16, 4
    with OS.OpStats("cpu", trace=True) as st:
        x = torch.randn(B, K)
        w = torch.randn(K, N, requires_grad=True)
        st.reset()
        y = x @ w
        (y * y).sum().backward()
    names = [t[0] for t in st.trace]
    assert st.flops == 2 * (2 * B * K * N)
    assert names.count("mm") == 2
    want = 4 * ((B * K + K * N + B * N) + 3 * B * N + (B * N + 1) + 2
                + 3 * 3 * B * N + (B * K + B * N + K * N))
    assert st.bytes == want, st.trace


def test_views_and_allocations_are_free():
    with OS.OpStats("cpu") as st:
        x = torch.empty(64, 64)
        st.reset()
        x.t()[:5].unsqueeze(0)
        x.view(-1).detach()
        torch.empty_like(x)
    assert st.n_ops == 0 and st.bytes == 0


def _overlap_case(compute_elems: int, asynchronous: bool) -> OS.OpStats:
    """The reference's ``_ASYNC_HLO`` from dispatched ops: an f32[1024]
    all-reduce over 4 ranks (wire 2 * 4096 * 3/4 = 6144 at unit rates) and
    one f32 add of ``compute_elems`` between its issue and its wait."""
    with fake_pg(4) as g, FakeTensorMode(), OS.OpStats("cpu", **UNIT) as st:
        t = torch.zeros(1024)
        a = torch.zeros(compute_elems)
        st.reset()
        if asynchronous:
            work = dist.all_reduce(t, group=g, async_op=True)
            st.issued(work)
            a + a
            st.wait(work)
        else:
            dist.all_reduce(t, group=g)
            a + a
    return st


def test_overlap_async_window_partial():
    """The add charges 3 x 64 bytes (its two inputs and its output; the
    reference charges its 64-byte result): exactly that is hidden."""
    ov = _overlap_case(16, True).overlap()
    assert ov.collective_s == 6144.0
    assert ov.n_async == 1 and ov.n_sync == 0
    assert ov.hidden_s == 192.0
    assert ov.overlap_fraction == 192.0 / 6144.0
    assert ov.exposed_s == 6144.0 - 192.0


def test_overlap_async_fully_hidden():
    ov = _overlap_case(8192, True).overlap()
    assert ov.collective_s == 6144.0
    assert ov.hidden_s == 6144.0  # min(wire, 3 x 32768)
    assert ov.overlap_fraction == 1.0


def test_overlap_sync_collective_exposes_everything():
    ov = _overlap_case(8192, False).overlap()
    assert ov.collective_s == 6144.0
    assert ov.n_sync == 1 and ov.n_async == 0
    assert ov.hidden_s == 0.0
    assert ov.overlap_fraction == 0.0


def test_overlap_hooks_of_a_bucketed_step():
    """``core.comm``'s issue and wait hooks: the bucketed sync's packed
    collectives hide some of their time under the next stage's compute on
    the overlapped schedule and none on the flat one; both schedules are
    recorded whichever is the primary, as the reference does."""
    cfg = reduced(get_arch("llama2-400m"))
    rec = DR.dryrun_one(
        "llama2-400m", "train_4k", device="cpu",
        world=DR.parse_world("2x1"), cfg=cfg,
        shape=ShapeConfig("t", 32, 4, "train"),
        run_overrides={"bucket_bytes": 8192, "microbatch": 2})
    assert rec["status"] == "ok", rec.get("traceback")
    ov = rec["overlap"]
    assert set(ov) == {"overlapped", "legacy"}
    assert ov["overlapped"]["n_async"] > 0
    assert 0 < ov["overlapped"]["hidden_s"] <= ov["overlapped"]["collective_s"]
    # the flat schedule waits for each stage's collectives at once
    assert ov["legacy"]["hidden_s"] == 0
    assert ov["legacy"]["n_async"] < ov["overlapped"]["n_async"]
    flat = DR.dryrun_one(
        "llama2-400m", "train_4k", device="cpu",
        world=DR.parse_world("2x1"), cfg=cfg,
        shape=ShapeConfig("t", 32, 4, "train"),
        run_overrides={"bucket_bytes": 8192, "microbatch": 2,
                       "overlap": False})
    assert flat["overlap"] == ov


@pytest.mark.parametrize("flops,hbm,wire,dom", [
    (1e15, 1e9, 1e6, "compute_s"),
    (1e9, 1e13, 1e6, "memory_s"),
    (1e9, 1e9, 1e12, "collective_s"),
])
def test_roofline_dominance(flops, hbm, wire, dom):
    t = RL.roofline_terms(flops, hbm, wire)
    assert t["dominant"] == dom
    assert t["compute_s"] == flops / 989.4e12
    assert t["memory_s"] == hbm / 3.35e12
    assert t["collective_s"] == wire / 50e9
    assert t["compute_fraction_of_roofline"] == t["compute_s"] / t[dom]
    ref = JRL.roofline_terms(flops * JRL.PEAK_FLOPS / RL.PEAK_FLOPS,
                             hbm * JRL.HBM_BW / RL.HBM_BW,
                             wire * JRL.ICI_BW / RL.LINK_BW)
    assert ref["dominant"] == dom
    assert RL.model_flops_per_step(7.0, 11.0) \
        == JRL.model_flops_per_step(7.0, 11.0)


def _record(arch, shape, mesh, peak, *, skipped=False, fid=False):
    if skipped:
        return {"arch": arch, "shape": shape, "mesh": mesh, "sync": "loco",
                "status": "skipped", "reason": "full attention"}
    r = {"arch": arch, "shape": shape, "mesh": mesh, "sync": "loco",
         "status": "ok",
         "memory": {"argument_bytes": peak // 3, "peak_bytes": peak},
         "flops_per_device": 3.5e14, "hbm_bytes_per_device": 2.25e12,
         "collectives": {"counts": {"all-gather": 10, "all-to-all": 4},
                         "bytes_by_kind": {"all-gather": 3 * 2**30,
                                           "all-to-all": 2**29},
                         "wire_bytes": 3.5 * 2**30},
         "overlap": {"overlapped": {"overlap_fraction": 0.25},
                     "legacy": {"overlap_fraction": 0.0}},
         "roofline": JRL.roofline_terms(3.5e14, 2.25e12, 3.5 * 2**30),
         "useful_flops_ratio": 0.61}
    if fid:
        r["fidelity"] = {"every": 4, "probe_wire_bytes": 2**31,
                         "extra_wire_bytes": 2**30,
                         "extra_launches": {"reduce-scatter": 12}}
    return r


def _records(peak_a: int) -> dict:
    recs = [
        _record("chameleon-34b", "train_4k", "16x16", peak_a, fid=True),
        _record("chameleon-34b", "long_500k", "16x16", 0, skipped=True),
        _record("mixtral-8x7b", "train_4k", "16x16", 9 * 2**30),
        _record("mixtral-8x7b", "train_4k", "2x16x16", 7 * 2**30),
        _record("mamba2-2.7b", "decode_32k", "16x16", 2**30),
        _record("mamba2-2.7b", "decode_32k", "2x16x16", 2**30),
    ]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


TABLES = ["roofline_table", "collective_table", "fidelity_overhead_table",
          "compare_meshes"]


@pytest.mark.parametrize("table", TABLES)
def test_report_tables_are_the_references(table):
    recs = _records(12 * 2**30)  # under both fit marks
    args = (recs,) if table == "compare_meshes" else (recs, "16x16")
    assert getattr(REPORT, table)(*args) == getattr(JREPORT, table)(*args)


def test_report_fit_mark_is_the_h100s():
    """A peak between 16 GiB and the H100's memory: the reference marks
    it as not fitting, the port does not; nothing else differs."""
    peak = 40 * 2**30
    assert 16 * 2**30 < peak < RL.HBM_BYTES
    recs = _records(peak)
    mine = REPORT.roofline_table(recs).splitlines()
    ref = JREPORT.roofline_table(recs).splitlines()
    diff = [(a, b) for a, b in zip(mine, ref) if a != b]
    assert len(mine) == len(ref) and len(diff) == 1
    a, b = diff[0]
    assert b == a.replace(f"{peak / 2**30:.2f} |",
                          f"{peak / 2**30:.2f} ⚠ |")
    over = _records(RL.HBM_BYTES + 2**20)
    assert " ⚠ |" in REPORT.roofline_table(over).splitlines()[2]


def test_fidelity_run_table_is_the_references(tmp_path):
    import json

    p = tmp_path / "run.jsonl"
    recs = [{"kind": "header"},
            {"kind": "fidelity", "step": 1, "metrics": {
                "fidelity/cos": 0.99, "fidelity/rel_l2": 0.1,
                "fidelity/comp_gain": 0.95, "embed/fid_cos": 0.98,
                "body/fid_cos": 0.97}},
            {"kind": "fidelity", "step": 3, "metrics": {
                "fidelity/cos": 0.991}}]
    p.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    assert REPORT.fidelity_run_table(str(p)) \
        == JREPORT.fidelity_run_table(str(p))


def _kernel_calls():
    """(name, prep, bytes the kernel must move) for each of the five
    wrappers: ``prep()`` draws the inputs on the current device and
    returns the call."""
    from repro_torch.kernels import act_quant as AQ
    from repro_torch.kernels import loco_quant as LQ
    from repro_torch.kernels import sign_pack as SP

    def compress():
        g = torch.randn(1024).to(torch.bfloat16)
        e = torch.zeros(1024).to(torch.float8_e4m3fn)
        return lambda: LQ.fused_compress(g, e, beta=0.5, escale=2.0**14)

    def compress_inplace():
        g = torch.randn(1024)
        e = torch.zeros(1024).to(torch.float8_e4m3fn)

        def call():
            out = LQ.fused_compress(g, e, bits=8, beta=0.5, escale=2.0**14,
                                    e_out=e)
            assert out[2] is e
            return out
        return call

    def dequant():
        q = torch.randint(-8, 8, (2, 512), dtype=torch.int8)
        s = torch.rand(2, 4) + 0.5
        return lambda: LQ.dequant_mean(q, s, out_dtype=torch.bfloat16)

    def onebit():
        h, s = torch.randn(1024), torch.ones(1)
        return lambda: SP.onebit_pack(h, s)

    def encode():
        h = torch.randn(4, 512)
        return lambda: AQ.act_encode(h)

    def decode():
        q = torch.randint(-128, 127, (4, 512), dtype=torch.int8)
        s = torch.rand(4) + 0.5
        return lambda: AQ.act_decode(q, s)

    return {
        "fused_compress": (compress, LQ.compress_bytes(1024)),
        "fused_compress 8-bit in place": (
            compress_inplace, LQ.compress_bytes(1024, 8, 4)),
        "dequant_mean": (dequant, LQ.dequant_bytes(1024, 2)),
        "onebit_pack": (onebit, SP.onebit_bytes(1024)),
        "act_encode": (encode, AQ.act_bytes(4)),
        "act_decode": (decode, AQ.act_bytes(4)),
    }


def _meta(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("case", sorted(_kernel_calls()))
def test_wrappers_plan_fake_tensors_as_their_plain_versions(case):
    """On fake tensors each wrapper returns the plain version's shapes and
    dtypes, counts a planned launch and launches nothing; under a recorder
    on real CPU tensors it is one op moving the kernel's bytes, its plain
    version's ops uncounted, with the plain version's bits."""
    from repro_torch.kernels import wrap as W

    prep, nbytes = _kernel_calls()[case]
    name = case.split()[0]
    torch.manual_seed(0)
    plain = prep()()
    W.reset_launches()
    before = W.PLANNED[name]
    with FakeTensorMode():
        fake = prep()()
    assert _meta(fake) == _meta(plain)
    assert W.PLANNED[name] == before + 1
    assert not W.LAUNCHES
    torch.manual_seed(0)
    call = prep()
    with OS.OpStats("cpu") as st:
        recorded = call()
    assert st.kernels == {name: 1} and st.n_ops == 1
    assert st.bytes == nbytes and st.flops == 0
    assert W.OBSERVER is None and not W.LAUNCHES
    recorded = recorded if isinstance(recorded, tuple) else (recorded,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for a, b in zip(recorded, plain):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_memory_tracker_is_the_hand_sum():
    """The live storages' bytes and their peak, by hand: views add
    nothing, a freed storage leaves.  (On a CUDA device each storage
    rounds up to the caching allocator's 512 bytes; fake CUDA storages
    need a CUDA build of torch, so the card's run checks that path
    against ``max_memory_allocated``.)"""
    assert OS.Memory(torch.device("cuda")).round == 512
    with FakeTensorMode(), OS.OpStats("cpu") as st:
        a = torch.zeros(1000)                           # 4,000 B
        assert st.memory.live == 4000
        v = a[10:].view(10, 99)                         # a view: nothing
        b = torch.ones(300, dtype=torch.bfloat16)       # 600 B
        assert st.memory.live == 4600
        st.memory.mark()
        c = a * 2                                       # 4,000 B
        del a, v
        assert st.memory.live == 4600
        assert st.memory.peak == 8600
        assert st.memory.since_mark() == 4000
        del b, c
        assert st.memory.live == 0
