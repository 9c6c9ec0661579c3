"""The port's telemetry against the reference's (CPU): ports of
``tests/test_metrics.py``'s cases; the train step's are in
``tests/test_torch_telemetry_step.py``.

* Codec hooks: ``grad_metrics`` and ``state_metrics`` of every codec cell
  on the same arrays as the reference's (counts exact, sums rtol 1e-5),
  f8 and int8 saturation, NaN counts.
* Schema: ``metric_units``/``metric_keys`` equal to the reference's for the
  monolithic, bucketed (no coalesce), coalesced and uniform plans (the
  overlapped schedule keeps the coalesced units), at tp 1 and 2; the
  packed local vector (replicated params pre-divided at tp 2) on the same
  gradients, states and chunks (counts exact, sums rtol 1e-5) and
  ``finalize`` on the same reduced vector (rtol 1e-6); ``finalize``'s
  rates.
* Sink and profiler: ``parse_window``, ``percentiles``,
  ``HealthMonitor``, the sink's round trip and validator; a port stream
  (CLI, ``--metrics-jsonl``) accepted by the reference's own validator,
  ``repro.telemetry.sink.main([path, "--expect-healthy"])``; the wire
  report record, the MoE activation-wire report and the error norms equal
  to the reference's.
"""
import dataclasses
import json
import math
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import codec as jcodec
from repro.core import flatparam as JFP
from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.core.quantizer import QuantConfig as JQuant
from repro.launch import steps as jsteps
from repro.telemetry import metrics as JM
from repro.telemetry import sink as JSINK
from repro.telemetry import wire as JWIRE
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import codec as tcodec
from repro_torch.core import policy as TPOL
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TTF
from repro_torch.telemetry import metrics as M
from repro_torch.telemetry import profiler as PROF
from repro_torch.telemetry import sink as SINK
from repro_torch.telemetry import wire as WIRE
from test_torch_train import BATCH, JCFG, MICRO, SEQ, TCFG

# ---------------------------------------------------------------------------
# codec hooks on the same arrays
# ---------------------------------------------------------------------------

# cell -> (strategy, QuantConfig fields)
CELLS = {
    "loco4_block": ("loco", {}),
    "loco8_block": ("loco", {"bits": 8}),
    "loco4_fixed": ("loco", {"mode": "fixed", "scale": 2.0**7}),
    "loco4_fixed_2e17": ("loco", {"mode": "fixed"}),
    "loco4_tensor": ("loco", {"mode": "tensor"}),
    "loco4_bf16": ("loco", {"error_codec": "bf16"}),
    "loco4_none": ("loco", {"error_codec": "none"}),
    "loco4_int8": ("loco", {"error_codec": "int8"}),
    "ef4_block": ("ef", {}),
    "naive4_block": ("naive4", {}),
    "onebit": ("onebit", {}),
}


def _codecs(cell):
    strategy, quant = CELLS[cell]
    return (jcodec.get_codec(JSync(strategy=strategy, quant=JQuant(**quant))),
            tcodec.get_codec(SyncConfig(strategy=strategy,
                                        quant=QuantConfig(**quant))))


def _assert_sums(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        if k.endswith(("_cnt", "_tot", "_bad")):
            assert g == w, (k, g, w)  # counts exact
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_grad_metrics_match_reference(cell):
    jc, tc = _codecs(cell)
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) * 1e-2
    x[::97] *= 50.0  # outliers, so the fixed modes clip
    _assert_sums(tc.grad_metrics(torch.from_numpy(x)),
                 jc.grad_metrics(jnp.asarray(x)))


@pytest.mark.parametrize("cell", sorted(c for c in CELLS
                                        if CELLS[c][0] != "naive4"))
def test_state_metrics_match_reference(cell):
    """On a stored state holding codes at the codec's bound (and a NaN
    for the float codes), the same sums and counts."""
    jc, tc = _codecs(cell)
    rng = np.random.default_rng(1)
    e = rng.normal(size=2048).astype(np.float32) * 2.0 ** -10
    e[::101] = 1.0   # beyond the f8 (448 / 2^14) and int8 bounds
    e[::203] = -1.0
    e[7] = np.nan
    jstate = jc.state_encode(jnp.asarray(e))
    tstate = interop.to_torch(np.asarray(jstate))
    assert tstate.dtype == tc.state_dtype()
    got = tc.state_metrics(tstate)
    want = jc.state_metrics(jstate)
    _assert_sums({k: v for k, v in got.items() if k != "err_sq"},
                 {k: v for k, v in want.items() if k != "err_sq"})
    assert math.isnan(float(got["err_sq"])) == math.isnan(
        float(want["err_sq"]))
    ec = CELLS[cell][1].get("error_codec", "f8")
    if cell.startswith("loco") and ec in ("f8", "int8"):
        assert float(got["err_sat_cnt"]) > 0


def test_state_metrics_f8_bound_from_codes():
    """The f8 count reads the codes: +-448 count, NaN and 240 do not."""
    tc = _codecs("loco4_block")[1]
    stored = torch.tensor([448.0, -448.0, 240.0, -2.0, 0.0, float("nan")]
                          ).to(torch.float8_e4m3fn)
    got = {k: float(v) for k, v in tc.state_metrics(stored).items()}
    assert (got["err_sat_cnt"], got["err_tot"], got["err_bad"]) == (2, 6, 1)


def test_grad_metrics_flag_nonfinite_gradient():
    tc = _codecs("loco4_block")[1]
    x = torch.ones(512)
    x[3] = float("nan")
    assert float(tc.grad_metrics(x)["scale_bad"]) >= 1


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

# plan -> (bucket bytes, policy, coalesce)
PLANS = {"monolithic": (0, None, True),
         "bucketed": (64 << 10, "embed=loco8,norm=fp,min=16384", False),
         "coalesced": (64 << 10, "embed=loco8,norm=fp,min=16384", True),
         "uniform": (64 << 10, None, True)}


def _unit_fields(u) -> tuple:
    return (u.key, u.group, u.name, u.unit, u.offset, u.chunk_elems,
            u.tp_replicated, u.stateful, u.sync.strategy,
            dataclasses.asdict(u.sync.quant), u.sync.beta)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_metric_units_and_keys_match_reference(plan, tp):
    nbytes, policy, coalesce = PLANS[plan]
    jsync, tsync = JSync(), SyncConfig()
    jrun = jsteps.RunConfig(sync=jsync, bucket_bytes=nbytes,
                            coalesce=coalesce, policy=JPOL.parse_policy(
                                policy, jsync) if policy else None)
    trun = tsteps.RunConfig(sync=tsync, bucket_bytes=nbytes,
                            coalesce=coalesce, policy=TPOL.parse_policy(
                                policy, tsync) if policy else None)
    jgroups = jsteps.build_model(JCFG, tp).groups()
    jtopo = JFP.MeshTopo(dp_axes=("data",), tp_axis="model", dp=2, tp=tp)
    tgroups = TTF.build_groups(TCFG, tp)
    ttopo = MeshTopo(group=None, dp=2, rank=0, tp=tp)
    ju = JM.metric_units(jgroups, jsync, jsteps.build_sync_plan(
        jrun, jgroups, jtopo), jtopo, coalesce)
    tu = M.metric_units(tgroups, tsync, tsteps.build_sync_plan(
        trun, tgroups, ttopo), ttopo, coalesce)
    assert ju and [_unit_fields(u) for u in tu] == \
        [_unit_fields(u) for u in ju]
    assert M.metric_keys(tu) == JM.metric_keys(ju)
    if plan != "monolithic":
        assert len(tu) > len(tgroups)  # more than one unit per param


# (plan, tp, strategy, QuantConfig fields)
LV_CASES = [(plan, tp, "loco", {}) for plan in sorted(PLANS)
            for tp in (1, 2)] + [
    ("monolithic", 1, "loco", {"mode": "fixed"}),
    ("coalesced", 2, "loco", {"mode": "tensor", "error_codec": "bf16"}),
    ("monolithic", 2, "onebit", {}), ("monolithic", 1, "ef", {}),
    ("monolithic", 1, "naive4", {"bits": 8})]
COUNT_FIELDS = [i for i, f in enumerate(M.UNIT_FIELDS)
                if f.endswith(("_cnt", "_tot", "_bad"))]


def _np_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _np_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np_tree(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("plan,tp,strategy,quant", LV_CASES)
def test_local_vector_matches_reference(plan, tp, strategy, quant):
    """The packed local vector and its finalized metrics on the same
    gradients, states and chunks: counts exact, sums rtol 1e-5."""
    nbytes, policy, coalesce = PLANS[plan]
    jsync = JSync(strategy=strategy, quant=JQuant(**quant))
    tsync = SyncConfig(strategy=strategy, quant=QuantConfig(**quant))
    jrun = jsteps.RunConfig(sync=jsync, bucket_bytes=nbytes,
                            coalesce=coalesce, policy=JPOL.parse_policy(
                                policy, jsync) if policy else None)
    trun = tsteps.RunConfig(sync=tsync, bucket_bytes=nbytes,
                            coalesce=coalesce, policy=TPOL.parse_policy(
                                policy, tsync) if policy else None)
    jgroups = jsteps.build_model(JCFG, tp).groups()
    jtopo = JFP.MeshTopo(dp_axes=("data",), tp_axis="model", dp=2, tp=tp)
    tgroups = TTF.build_groups(TCFG, tp)
    ttopo = MeshTopo(group=None, dp=2, rank=0, tp=tp)
    ju = JM.metric_units(jgroups, jsync, jsteps.build_sync_plan(
        jrun, jgroups, jtopo), jtopo, coalesce)
    tu = M.metric_units(tgroups, tsync, tsteps.build_sync_plan(
        trun, tgroups, ttopo), ttopo, coalesce)
    ts = tsteps.make_init(TCFG, trun, ttopo, torch.device("cpu"))
    rng = np.random.default_rng(7)

    def grad(t):
        g = rng.normal(size=tuple(t.shape)).astype(np.float32) * 1e-2
        g.reshape(-1)[::97] *= 50.0
        return g

    def state(t):
        if t.dtype == torch.float8_e4m3fn:
            e = rng.normal(size=tuple(t.shape)).astype(np.float32) * 2.0**-10
            e.reshape(-1)[::101] = 1.0  # at the f8 bound
            return np.asarray(jnp.clip(jnp.asarray(e) * 2.0**14, -448, 448)
                              .astype(jnp.float8_e4m3fn))
        if t.dtype == torch.bfloat16:
            return (rng.normal(size=tuple(t.shape)) * 1e-3).astype(
                ml_dtypes.bfloat16)
        return rng.normal(size=tuple(t.shape)).astype(np.float32) * 1e-3

    grads = _np_tree(ts.chunks, grad)
    states = _np_tree(ts.states, state)
    chunks = _np_tree(ts.chunks, lambda t: t.numpy())
    new = _np_tree(chunks, lambda a: a - 1e-3 * rng.normal(
        size=a.shape).astype(np.float32))
    want = np.asarray(JM.local_vector(
        ju, *(_np_tree(x, jnp.asarray) for x in (grads, states, chunks,
                                                 new)), jgroups, tp))
    got = M.local_vector(tu, *(_np_tree(x, interop.to_torch) for x in (
        grads, states, chunks, new)), tgroups, tp, "cpu").numpy()
    assert got.shape == want.shape == (len(tu) * M.NF + 2,)
    rows, jrows = got[:-2].reshape(-1, M.NF), want[:-2].reshape(-1, M.NF)
    np.testing.assert_array_equal(rows[:, COUNT_FIELDS],
                                  jrows[:, COUNT_FIELDS])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert rows[:, M.UNIT_FIELDS.index("sat_cnt")].sum() > 0
    # finalize on one reduced vector (its std subtracts two large sums, so
    # it is compared on the same input)
    gf = {k: float(v) for k, v in M.finalize(torch.from_numpy(want.copy()),
                                              tu).items()}
    wf = {k: float(v) for k, v in JM.finalize(jnp.asarray(want),
                                               ju).items()}
    assert list(gf) == list(JM.metric_keys(ju))
    np.testing.assert_allclose([gf[k] for k in wf], list(wf.values()),
                               rtol=1e-6, atol=1e-7)


def test_finalize_rates():
    u = M.MetricUnit(key="g/p", group="g", name="p", unit=0, offset=0,
                     chunk_elems=8, sync=SyncConfig(), tp_replicated=False,
                     stateful=True)
    vals = dict(sat_cnt=5.0, sat_tot=20.0, scale_l2_sum=12.0,
                scale_l2_sqsum=40.0, scale_cnt=4.0, scale_bad=0.0,
                err_sq=9.0, err_sat_cnt=1.0, err_tot=10.0, err_bad=0.0)
    red = torch.tensor([vals[f] for f in M.UNIT_FIELDS] + [16.0, 4.0])
    out = {k: float(v) for k, v in M.finalize(red, (u,)).items()}
    assert tuple(out) == M.metric_keys((u,))
    assert out["g/p/sat_rate"] == 0.25
    assert out["g/p/scale_log2_mean"] == 3.0
    np.testing.assert_allclose(out["g/p/scale_log2_std"], 1.0, atol=1e-6)
    assert out["g/p/err_sq"] == 9.0
    np.testing.assert_allclose(out["g/p/err_sat_rate"], 0.1, rtol=1e-6)
    assert (out["err_norm"], out["sat_rate"], out["param_norm"],
            out["update_norm"], out["update_ratio"], out["nonfinite"]) == \
        (3.0, 0.25, 4.0, 2.0, 0.5, 0.0)
    jout = {k: float(v) for k, v in JM.finalize(
        jnp.asarray(red.numpy()), (jsteps_unit(u),)).items()}
    assert jout == out


def jsteps_unit(u):
    """The reference's MetricUnit with the same fields."""
    return JM.MetricUnit(key=u.key, group=u.group, name=u.name, unit=u.unit,
                         offset=u.offset, chunk_elems=u.chunk_elems,
                         sync=JSync(), tp_replicated=u.tp_replicated,
                         stateful=u.stateful)


# ---------------------------------------------------------------------------
# the step, on a spawned 2-rank group
# ---------------------------------------------------------------------------

ONOFF = {"monolithic": (0, None),
         "overlapped": (64 << 10, "embed=loco8,norm=fp,min=16384")}


def _run_cfg(quant, telemetry, jax_side=False, buckets=(0, None), **kw):
    sync = (JSync(quant=JQuant(**quant)) if jax_side
            else SyncConfig(quant=QuantConfig(**quant)))
    nbytes, policy = buckets
    pol = ((JPOL if jax_side else TPOL).parse_policy(policy, sync)
           if policy else None)
    mod = jsteps if jax_side else tsteps
    return mod.RunConfig(sync=sync, microbatch=MICRO, total_steps=4,
                         warmup_steps=0, lr=1e-3, telemetry=telemetry,
                         bucket_bytes=nbytes, policy=pol, **kw)


# ---------------------------------------------------------------------------
# profiler window, sink, validator
# ---------------------------------------------------------------------------

def test_parse_window():
    assert PROF.parse_window("5") == (5, 5)
    assert PROF.parse_window("3:9") == (3, 9)
    for bad in ("9:3", "abc", "-1"):
        with pytest.raises(ValueError):
            PROF.parse_window(bad)


def test_percentiles_match_reference():
    xs = [float(i) for i in range(1, 101)]
    assert SINK.percentiles(xs) == JSINK.percentiles(xs)
    assert SINK.percentiles([7.0]) == {"p50": 7.0, "p90": 7.0, "p99": 7.0}
    assert math.isnan(SINK.percentiles([])["p50"])


def test_health_monitor_fires(capsys):
    mon = SINK.HealthMonitor()
    assert mon.check({"loss": 1.0, "gnorm": 2.0,
                      "metrics": {"err_norm": 1.0, "sat_rate": 0.01}}) == []
    w = mon.check({"loss": float("nan"), "metrics": {}})
    assert [x["monitor"] for x in w] == ["nonfinite"]
    w = mon.check({"loss": 1.0, "metrics": {"nonfinite": 3.0}})
    assert [x["monitor"] for x in w] == ["nonfinite_values"]
    w = mon.check({"loss": 1.0, "metrics": {"err_norm": 100.0}})
    assert "err_growth" in [x["monitor"] for x in w]
    w = mon.check({"loss": 1.0, "metrics": {"err_norm": 1e5, "sat_rate": 0.9}})
    kinds = [x["monitor"] for x in w]
    assert "err_divergence" in kinds and "saturation" in kinds
    assert "TELEMETRY WARNING" in capsys.readouterr().err


def test_sink_roundtrip_and_cli(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    sink = SINK.MetricsSink(path, header={"run": {"arch": "t"},
                                          "topo": {"dp": 2}})
    for i in range(3):
        sink.step(i, loss=1.0, gnorm=2.0, lr=1e-3, step_ms=5.0,
                  metrics={"err_norm": 1.0}, groups_inflight=2)
    sink.summary(steps=3, tokens_per_s=100.0)
    sink.close()
    res = SINK.validate_stream(path)
    assert res == {"kinds": {"header": 1, "step": 3, "summary": 1},
                   "errors": []}
    assert SINK.main([path, "--expect-healthy"]) == 0
    assert JSINK.main([path, "--expect-healthy"]) == 0
    sink = SINK.MetricsSink(path)
    sink.step(3, loss=float("nan"), gnorm=1.0, lr=1e-3, step_ms=5.0,
              metrics={})
    sink.close()
    assert sink.n_warnings == 1
    assert SINK.main([path, "--expect-healthy"]) == 2
    assert SINK.main([path]) == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema_version": 1, "kind": "step"}\n')
    assert SINK.main([str(bad)]) == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps(SINK.envelope("header", run={}, topo={}))
                     + "\n")
    assert SINK.main([str(empty)]) == 3
    capsys.readouterr()


CLI = ["--arch", "llama2-400m", "--reduced", "--seq-len", str(SEQ),
       "--global-batch", str(BATCH), "--microbatch", str(MICRO),
       "--steps", "3", "--device", "cpu", "--log-every", "1"]


def test_port_stream_passes_the_references_validator(tmp_path, capsys):
    """A bucketed CLI run with ``--metrics-jsonl`` (every step) and
    ``--profile-steps 1``: header (run, fingerprint, topo), wire report,
    3 step records with ``err_norm``, ``sat_rate``, ``update_ratio`` and
    ``groups_inflight``, a summary; both validators accept it; the trace
    file of step 1 is written; the log lines carry ``err_norm=``."""
    path = tmp_path / "run.jsonl"
    res = ttrain.main(CLI + ["--bucket-mb", "0.0625", "--policy",
                             "embed=loco8,min=16384", "--metrics-jsonl",
                             str(path), "--metrics-every", "1",
                             "--profile-steps", "1", "--profile-dir",
                             str(tmp_path / "trace")])
    assert "err_norm=" in capsys.readouterr().out
    assert JSINK.main([str(path), "--expect-healthy"]) == 0
    assert SINK.main([str(path), "--expect-healthy"]) == 0
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["header", "wire_report", "step",
                                         "step", "step", "summary"]
    head, steps = recs[0], recs[2:5]
    assert head["run"]["optimizer"] == "adam" and head["fingerprint"]
    assert head["topo"]["dp"] == 1
    assert [s["step"] for s in steps] == [0, 1, 2]
    assert [s["loss"] for s in steps] == res["losses"]
    for s in steps:
        assert s["groups_inflight"] == 2
        for k in ("err_norm", "sat_rate", "update_ratio"):
            assert math.isfinite(s["metrics"][k]) and s["metrics"][k] > 0
    assert steps[0]["step_ms"] is None and steps[1]["step_ms"] > 0
    assert recs[-1]["steps"] == 3 and recs[-1]["peak_err_norm"] > 0
    assert res["trace"] and os.path.exists(res["trace"]["path"])
    assert (tmp_path / "trace" / "trace_steps_1-1.json").exists()


def test_wire_report_record_matches_reference():
    """The port's ``wire_report`` record equals the reference's for the
    same plan, but for the timestamp and the tier rows (ROADMAP item
    11)."""
    nbytes, policy = ONOFF["overlapped"]
    jrun = _run_cfg({}, False, jax_side=True, buckets=ONOFF["overlapped"])
    trun = _run_cfg({}, False, buckets=ONOFF["overlapped"])
    jgroups = jsteps.build_model(JCFG, 1).groups()
    jtopo = JFP.MeshTopo(dp_axes=("data",), tp_axis="model", dp=2, tp=1)
    tgroups = TTF.build_groups(TCFG, 1)
    ttopo = MeshTopo(group=None, dp=2, rank=0, tp=1)
    want = JWIRE.plan_report(jsteps.build_sync_plan(jrun, jgroups,
                                                    jtopo)).record()
    got = WIRE.plan_report(tsteps.build_sync_plan(trun, tgroups,
                                                  ttopo)).record()
    assert SINK.validate_record(got) == [] == JSINK.validate_record(got)
    assert set(got) == set(want)
    skip = {"t", "tiers"}
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert json.loads(WIRE.plan_report(tsteps.build_sync_plan(
        trun, tgroups, ttopo)).to_json())["total_wire_bytes"] == \
        want["total_wire_bytes"]


@pytest.mark.parametrize("tp,codec", [(1, "block8"), (2, "block8"),
                                      (2, "fp")])
def test_moe_a2a_report_matches_reference(tp, codec):
    jcfg = dataclasses.replace(jreduced(jget_arch("deepseek-v3-moe")),
                               moe_a2a_codec=codec)
    tcfg = dataclasses.replace(reduced(get_arch("deepseek-v3-moe")),
                               moe_a2a_codec=codec)
    jtopo = JFP.MeshTopo(dp_axes=("data",), tp_axis="model", dp=2, tp=tp)
    ttopo = MeshTopo(group=None, dp=2, rank=0, tp=tp)
    want = JWIRE.moe_a2a_report(jcfg, JShape("t", 32, 8, "train"), jtopo, 2)
    got = WIRE.moe_a2a_report(tcfg, ShapeConfig("t", 32, 8, "train"), ttopo,
                              2)
    assert got == want
    assert WIRE.format_moe_a2a(got) == JWIRE.format_moe_a2a(want)
    assert WIRE.moe_a2a_report(TCFG, ShapeConfig("t", 32, 8, "train"),
                               ttopo, 2) is None


def test_error_norms_match_reference():
    """``error_sq_norms`` and ``error_sq_norm_local`` on the same stored
    per-unit states (f8 codes from the reference's encoder)."""
    nbytes, policy = ONOFF["overlapped"]
    jrun = _run_cfg({}, False, jax_side=True, buckets=ONOFF["overlapped"])
    trun = _run_cfg({}, False, buckets=ONOFF["overlapped"])
    jgroups = jsteps.build_model(JCFG, 1).groups()
    jtopo = JFP.MeshTopo(dp_axes=("data",), tp_axis="model", dp=1, tp=1)
    tgroups = TTF.build_groups(TCFG, 1)
    ttopo = MeshTopo(group=None, dp=1, rank=0, tp=1)
    jplan = jsteps.build_sync_plan(jrun, jgroups, jtopo)
    tplan = tsteps.build_sync_plan(trun, tgroups, ttopo)
    ts = tsteps.make_init(TCFG, trun, ttopo, torch.device("cpu"))
    rng = np.random.default_rng(5)
    jstates, tstates = {}, {}
    for g in tgroups:
        jstates[g.name], tstates[g.name] = {}, {}
        for info in g.infos:
            s = ts.states[g.name][info.name]
            if not isinstance(s, tuple):
                jstates[g.name][info.name] = jnp.asarray(s.numpy())
                tstates[g.name][info.name] = s
                continue
            js, tsx = [], []
            for leaf in s:
                if leaf.dtype == torch.float8_e4m3fn:
                    e = rng.normal(size=tuple(leaf.shape)).astype(
                        np.float32) * 2.0 ** -10
                    a = np.asarray(jnp.clip(jnp.asarray(e) * 2.0 ** 14,
                                            -448, 448).astype(
                                                jnp.float8_e4m3fn))
                    assert a.dtype == ml_dtypes.float8_e4m3fn
                else:
                    a = leaf.numpy()
                js.append(jnp.asarray(a))
                tsx.append(interop.to_torch(a))
            jstates[g.name][info.name] = tuple(js)
            tstates[g.name][info.name] = tuple(tsx)
    want = float(JWIRE.error_sq_norm_local(jstates, jgroups, jrun.sync,
                                           jplan))
    got = float(WIRE.error_sq_norm_local(tstates, tgroups, trun.sync, tplan))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    pp, jpp = tplan.params[0], jplan.params[0]
    st = tstates[pp.group][pp.name]
    jst = jstates[jpp.group][jpp.name]
    np.testing.assert_allclose(
        [float(x) for x in WIRE.bucket_error_sq_norms(st, pp)],
        [float(x) for x in JWIRE.bucket_error_sq_norms(jst, jpp)], rtol=1e-5)
