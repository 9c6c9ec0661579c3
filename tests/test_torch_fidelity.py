"""The port's fidelity-probe schema (``telemetry/fidelity``) against the
reference's (CPU, numpy inputs from a seed).

* ``local_vector`` and ``finalize`` on identical arrays: a flat unit, a
  two-stage and a three-tier unit, a stacked ``(L, K, chunk)`` leaf with
  two units at offsets, a TP-replicated unit (tp 4) and a lossless one;
  the packed sums within 1e-6 relative (the port sums in f64 and rounds
  once, XLA in f32), the finalized keys the same, in order, and their
  values within 1e-5 relative.
* The stage chain telescopes: the per-stage deviation vectors sum to the
  end-to-end one, and each stage field is its squared norm.
* ``fidelity_stats``, the numpy oracle, against the reference's.
* The build-time refusals, with the reference's messages.
* A stream with ``fidelity`` records validated by both packages' sinks,
  and the sustained-window monitors firing on the third bad probe.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro.telemetry import fidelity as JFID
from repro.telemetry import sink as JSINK
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.core.flatparam import MeshTopo
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.telemetry import fidelity as FID
from repro_torch.telemetry import sink as SINK

VEC_RTOL = 1e-6
OUT_RTOL = 1e-5


def _sync(side, strategy="loco", tiers=(), hierarchical=False):
    L, Q = ((jloco, jQ), (tloco, tQ))[side]
    ts = tuple(L.SyncTier(L.SyncConfig(strategy=s, **kw), every=1)
               for s, kw in tiers)
    return L.SyncConfig(strategy=strategy, quant=Q.QuantConfig(mode="block"),
                        hierarchical=hierarchical or bool(ts),
                        tiers=ts or None)


SYNCS = {
    "flat": {},
    "hier": dict(hierarchical=True),
    "three_tier": dict(tiers=(("naive4", {}), ("topk", {"topk_frac": 0.25}))),
}


def _units(side, sync_kw, chunks, tp_replicated=False):
    """One unit per ``(offset, length)`` of ``chunks`` on leaf g/p."""
    FIDm = (JFID, FID)[side]
    sync = _sync(side, **sync_kw)
    return tuple(
        FIDm.FidelityUnit(key=f"g/p[{i}]", group="g", name="p", unit=i,
                          offset=off, chunk_elems=c, sync=sync,
                          tp_replicated=tp_replicated,
                          stateful=sync.needs_state())
        for i, (off, c) in enumerate(chunks))


def _arrays(rows, C, lead=(), seed=7):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=lead + (rows, C)).astype(np.float32)
    g = (p[..., 0, :] + 0.1 * rng.normal(size=lead + (C,))).astype(
        np.float32)
    return g, p


CASES = {   # name: (SYNCS key, unit chunks, leaf lead dims, tp, replicated)
    "flat": ("flat", ((0, 2048),), (), 1, False),
    "hier": ("hier", ((0, 2048),), (), 1, False),
    "three_tier": ("three_tier", ((0, 2048),), (), 1, False),
    "stacked_units": ("flat", ((0, 1024), (1024, 512)), (3,), 1, False),
    "tp_replicated": ("flat", ((0, 2048),), (), 4, True),
}


def _both_vectors(name):
    key, chunks, lead, tp, rep = CASES[name]
    ju, tu = (_units(s, SYNCS[key], chunks, rep) for s in (0, 1))
    rows = FID.probe_rows(tu[0].sync)
    g, p = _arrays(rows, sum(c for _, c in chunks), lead)
    jv = JFID.local_vector(ju, {"g": {"p": jnp.asarray(g)}},
                           {"g": {"p": jnp.asarray(p)}}, tp=tp)
    tv = FID.local_vector(tu, {"g": {"p": torch.from_numpy(g)}},
                          {"g": {"p": torch.from_numpy(p)}}, tp)
    return ju, tu, np.asarray(jv), tv, g, p


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_vector_and_finalize_match_reference(name):
    ju, tu, jv, tv, _, _ = _both_vectors(name)
    assert tv.dtype == torch.float32
    assert tv.shape == jv.shape == (FID.vector_len(tu),)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=VEC_RTOL)
    want = {k: float(v) for k, v in JFID.finalize(jnp.asarray(jv),
                                                  ju).items()}
    got = {k: float(v) for k, v in FID.finalize(tv, tu).items()}
    assert tuple(got) == tuple(want) == FID.fidelity_keys(tu) \
        == JFID.fidelity_keys(ju)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=OUT_RTOL,
                                   err_msg=k)


def test_tp_replicated_unit_is_divided_by_tp():
    tu = _units(1, {}, ((0, 256),), tp_replicated=True)
    g, p = _arrays(3, 256)
    args = ({"g": {"p": torch.from_numpy(g)}},
            {"g": {"p": torch.from_numpy(p)}})
    v4 = FID.local_vector(tu, *args, 4)
    v1 = FID.local_vector(tu, *args, 1)
    np.testing.assert_allclose(v4.numpy() * 4, v1.numpy(), rtol=1e-6)


def test_lossless_unit_is_exact():
    """A unit whose sync is the true mean reports rel_l2 0 exactly."""
    tu = _units(1, {}, ((0, 64),))
    t = np.linspace(-1, 1, 64, dtype=np.float32)
    p = np.stack([t, t, t + 0.5])
    red = FID.local_vector(tu, {"g": {"p": torch.from_numpy(t)}},
                           {"g": {"p": torch.from_numpy(p)}}, 1)
    out = {k: float(v) for k, v in FID.finalize(red, tu).items()}
    assert out["g/p[0]/fid_rel_l2"] == 0.0
    np.testing.assert_allclose(out["g/p[0]/fid_cos"], 1.0, rtol=1e-6)
    assert out["g/p[0]/fid_comp_gain"] > 1e6


@pytest.mark.parametrize("key,S", [("flat", 1), ("hier", 2),
                                   ("three_tier", 3)])
def test_stage_chain_telescopes(key, S):
    """R_0 = true, R_1 = comp, mid-tier refs, R_S = sync: the stage
    deviation vectors sum to the end-to-end deviation, and each packed
    stage field is its squared norm (numpy, f64)."""
    (u,) = _units(1, SYNCS[key], ((0, 512),))
    assert FID.n_stages(u.sync) == S
    assert FID.probe_rows(u.sync) == 3 + max(0, S - 2)
    g, p = _arrays(FID.probe_rows(u.sync), 512)
    vec = FID.local_vector((u,), {"g": {"p": torch.from_numpy(g)}},
                           {"g": {"p": torch.from_numpy(p)}}, 1).numpy()
    chain = ([p[0], g] if S == 1 else
             [p[0], p[1]] + [p[3 + i] for i in range(S - 2)] + [g])
    devs = [b.astype(np.float64) - a for a, b in zip(chain[:-1], chain[1:])]
    np.testing.assert_allclose(np.sum(devs, axis=0), g - p[0], atol=1e-6)
    for s, d in enumerate(devs):
        np.testing.assert_allclose(vec[FID.NBASE + s], np.sum(d * d),
                                   rtol=1e-6)


def test_fidelity_stats_matches_reference():
    rng = np.random.default_rng(3)
    t = rng.normal(size=4096).astype(np.float32)
    s = (t + 0.05 * rng.normal(size=4096)).astype(np.float32)
    want = {k: float(v) for k, v in JFID.fidelity_stats(s, t).items()}
    got = {k: float(v) for k, v in FID.fidelity_stats(s, t).items()}
    assert sorted(got) == sorted(want) == ["cos", "rel_l2"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# build-time refusals (the reference's messages)
# ---------------------------------------------------------------------------

CFG = reduced(get_arch("llama2-400m"))
SHAPE = ShapeConfig("t", 32, 8, "train")


def _build(**kw):
    with tmesh.dp_group(torch.device("cpu")) as g:
        topo = MeshTopo.from_group(g)
        run = tsteps.RunConfig(microbatch=2, **kw)
        tsteps.make_train_step(CFG, run, topo, torch.device("cpu"), SHAPE)


def test_probe_refuses_tier0_cadence():
    sync = tloco.SyncConfig(quant=tQ.QuantConfig(mode="block"), every=2)
    with pytest.raises(ValueError, match="cannot meter a tier-0 sync"):
        _build(sync=sync, fidelity_every=2, overlap=False)
    _build(sync=sync, fidelity_every=0, overlap=False)  # cadence alone: fine


def test_probe_refuses_all_fp():
    with pytest.raises(ValueError, match="nothing to probe"):
        _build(sync=tloco.SyncConfig(strategy="fp"), fidelity_every=2)


def test_probe_step_cadence():
    run = tsteps.RunConfig(fidelity_every=3)
    assert [s for s in range(9) if tsteps.is_probe_step(run, s)] == [2, 5, 8]
    assert not any(tsteps.is_probe_step(tsteps.RunConfig(), s)
                   for s in range(9))


# ---------------------------------------------------------------------------
# the sink: fidelity records, both validators, the monitors
# ---------------------------------------------------------------------------

def test_fidelity_stream_valid_in_both_packages(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sink = SINK.MetricsSink(path, header={"run": {"arch": "t"},
                                          "topo": {"dp": 2}})
    sink.step(0, loss=1.0, gnorm=1.0, lr=1e-3, step_ms=5.0, metrics={})
    sink.fidelity(1, metrics={"fidelity/cos": 0.99, "fidelity/rel_l2": 0.05,
                              "fidelity/comp_gain": 1.2,
                              "embed/tok/fid_cos": 0.98})
    sink.summary(steps=2)
    sink.close()
    for mod in (SINK, JSINK):
        res = mod.validate_stream(path)
        assert res["errors"] == [], mod.__name__
        assert res["kinds"]["fidelity"] == 1
        assert mod.main([path, "--expect-healthy"]) == 0


def test_fidelity_monitors_fire_on_a_sustained_window(tmp_path):
    mon = SINK.HealthMonitor()
    bad = {"metrics": {"fidelity/cos": 0.5, "fidelity/comp_gain": 0.4}}
    good = {"metrics": {"fidelity/cos": 0.99, "fidelity/comp_gain": 1.3}}
    assert mon.check(bad) == [] and mon.check(bad) == []
    assert sorted(w["monitor"] for w in mon.check(bad)) == [
        "fidelity_collapse", "negative_comp_gain"]
    assert mon.check(good) == [] and mon.check(bad) == []
    path = str(tmp_path / "bad.jsonl")
    sink = SINK.MetricsSink(path)
    sink.step(0, loss=1.0, gnorm=1.0, lr=1e-3, step_ms=5.0, metrics={})
    for i in range(SINK.HealthConfig().fid_window):
        sink.fidelity(i, metrics={"fidelity/cos": 0.1,
                                  "fidelity/comp_gain": 0.5})
    sink.close()
    assert sink.n_warnings == 2
    for mod in (SINK, JSINK):
        assert mod.main([path, "--expect-healthy"]) == 2
        assert mod.main([path]) == 0


def test_probe_refuses_the_overlapped_schedule():
    """The probe runs on the flat schedule (the overlapped one gives the
    same bits): a probe buffer with ``overlap`` is refused by the gather
    and by the coalesced sync, with the reference's message."""
    from repro_torch.core import comm
    from repro_torch.core import flatparam as FP
    from test_torch_wirepack import LOCO4, make_plan

    with tmesh.dp_group(torch.device("cpu")) as g:
        topo = MeshTopo.from_group(g)
        info = FP.ParamInfo("w", (4, 512))
        with pytest.raises(ValueError, match="flat \\(non-overlapped\\)"):
            FP.materialize(torch.zeros(2048), torch.zeros(2048), info,
                           tloco.SyncConfig(), topo, overlap=True,
                           probe=torch.zeros(3, 2048))
        plan = make_plan((LOCO4, LOCO4), 1, D=1)
        with pytest.raises(ValueError, match="flat coalesced schedule"):
            comm.dist_sync_runs(torch.zeros(plan.chunklen), (
                torch.zeros(plan.chunklen, dtype=torch.float8_e4m3fn),),
                plan, g, overlap=True, probe=True)
