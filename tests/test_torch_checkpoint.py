"""The port's checkpoint layer against the reference's (CPU).

Format: bf16 and f8 cross the npz as integer views with the reference's
keys (``name::bfloat16``, ``name::float8_e4m3fn``) and the same bytes, for
every one of the 256 f8 codes (NaN codes included) and the 65,536 bf16
words; the port's layout fingerprint of a run equals the reference's as
JSON.

Reshard (``tests/test_checkpoint.py``'s cases without tp > 1 or tiers,
ported), on random states whose compensation errors are nonzero (spread
over the f8 codes through the codec's error scale) and read back through
the reference's ``logical.stitch_error``: the identity reshard is
bit-exact; dp 2 -> 4 with another bucket size and policy leaves every
target rank the f8 requantization of the source ranks' mean error and the
master chunks exact; monolithic <-> planned round-trips; a mismatch
without ``reshard`` names the differing fields; a corrupted newest
checkpoint falls back to the previous one; ``keep`` prunes; a v1 manifest
still restores.  The port's ``reshard`` gives the reference's
``repro.state.reshard.reshard`` byte for byte on the same stored arrays
(dp 2 -> 4, 2 -> 1, 4 -> 2, bucket size, policy, monolithic <-> planned;
EF (bf16 error), onebit and naive4 states and an ``embed=ef,body=onebit``
mix; reduced deepseek-v3-moe; dp 2 -> 1 and 2 -> 4 at tp 2), with the
fingerprints equal as JSON; resharding across tp is refused.

Across frameworks: ``repro`` trains reduced llama2-400m bucketed for 2
steps and checkpoints; the port's CLI (``--device cpu``) restores it and
runs steps 2-3 within ROADMAP's loss limits of the reference's own
continuation.  The port trains one step at dp = 2 (two spawned gloo ranks)
and saves; ``repro.checkpoint.checkpoint.restore`` reads the same keys,
shapes, dtypes and bytes with the reference's own fingerprint, the port's
ranks resume it bit for bit, and the port reshards its trained errors
onto dp = 1 as the reference does, byte for byte.  The CLI refuses a
resume under another bucket layout unless told to reshard, and then
continues with the uninterrupted run's losses.  At dp 2 x tp 2 (four
spawned ranks, global rank ``data * 2 + model``) the port writes the
reference's npz entries byte for byte for the same arrays, with the
reference's fingerprint, and resumes the reference's checkpoint, each rank
its ``(data, model)`` piece bit for bit, continuing within the loss
limits of the reference's own continuation.

The other optimizers' states (``sgd``'s empty tuple, ``adafactor``'s one
tree as ``adafactor_flat``, ``lamb``'s two) on the reduced bucketed llama
at dp 2: the port's npz is the reference's entry for entry and byte for
byte, each package restores the other's, and both reshard it onto dp 4
under another bucket layout into the same bytes; the CLI resumes each
optimizer's run with the uninterrupted run's loss bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.checkpoint import checkpoint as JCKPT
from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import flatparam as JFP
from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.state import logical as jlogical
from repro.state import serial as jserial
from repro.state.reshard import reshard as jreshard
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import policy as TPOL
from repro_torch.core import quantizer as Q
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.data.synthetic import DataConfig, make_batch_fn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import build_groups
from repro_torch.state import CheckpointMismatch, fingerprint_diff
from repro_torch.state import logical, serial
from repro_torch.state import manifest as MAN
from repro_torch.state.reshard import reshard
from test_torch_train import (BATCH, JCFG, LATER_ATOL, MICRO, SEQ,
                              STEP0_RTOL, TCFG)

SYNC = SyncConfig()
# run name -> (bucket bytes, policy); both frameworks parse the same text
RUNS = {"mono": (0, None), "A": (64 << 10, "embed=loco8,norm=fp,min=16384"),
        "B": (128 << 10, "embed=loco8"),
        # A's policy at B's bucket size; B's policy at A's bucket size
        "A128": (128 << 10, "embed=loco8,norm=fp,min=16384"),
        "B64": (64 << 10, "embed=loco8"),
        # the other stateful and stateless codecs, and a mix of two
        "ef": (64 << 10, "embed=ef,body=ef"),
        "onebit": (64 << 10, "embed=onebit,body=onebit"),
        "naive4": (64 << 10, "embed=naive4,body=naive4"),
        "mixed": (64 << 10, "embed=ef,body=onebit")}
ARCHS = {"llama": (JCFG, TCFG),
         "deepseek": (jreduced(jget_arch("deepseek-v3-moe")),
                      reduced(get_arch("deepseek-v3-moe")))}


def _run(name, coalesce=True, jax_side=False):
    """The named run's RunConfig, the port's or the reference's."""
    nbytes, policy = RUNS[name]
    steps_mod, sync, POL = ((jsteps, JSync(), JPOL) if jax_side
                            else (tsteps, SYNC, TPOL))
    return steps_mod.RunConfig(
        sync=sync, bucket_bytes=nbytes, coalesce=coalesce,
        policy=POL.parse_policy(policy, sync) if policy else None)


RUN_A, RUN_B, RUN_MONO = _run("A"), _run("B"), _run("mono")


def _topo(dp, tp=1):
    return MeshTopo(group=None, dp=dp, rank=0, tp=tp)


def make_layout(run, dp, tp=1, arch="llama"):
    """(fingerprint, global meta template) of one run at one dp x tp."""
    cfg = ARCHS[arch][1]
    topo = _topo(dp, tp)
    groups = build_groups(cfg, tp)
    plan = tsteps.build_sync_plan(run, groups, topo)
    ts = tsteps.make_init(cfg, run, topo, torch.device("cpu"))
    return (tsteps.state_fingerprint(run, groups, topo, plan),
            CKPT.global_template(ts, dp, tp))


# decoded compensation errors of the random states: about a gradient's
# quantization error, pre-scaled by the codec's error_scale (2^14) into f8
# codes around 16 (an unscaled value this small rounds to an f8 zero)
ERR = 2.0 ** -10
QC = Q.QuantConfig()


def random_state(tmpl, seed=0):
    """Template -> random global state: f32 chunks and moments of about
    1e-4, compressor errors of about ``ERR`` stored through the f8 codec
    (LoCo) or as bf16 (EF, onebit), stateless dummies zero."""
    gen = torch.Generator().manual_seed(seed)
    flat = {}
    for k, t in serial.flatten(tmpl).items():
        if t.shape[-1] == 1 and t.dtype == torch.float32:
            flat[k] = torch.zeros(t.shape)
        elif k.startswith("states/") and t.dtype == torch.bfloat16:
            flat[k] = (torch.randn(t.shape, generator=gen) * ERR).to(t.dtype)
        elif k.startswith("states/"):
            assert t.dtype == torch.float8_e4m3fn, k
            flat[k] = Q.error_encode(
                torch.randn(t.shape, generator=gen) * ERR, QC)
        else:
            flat[k] = (torch.randn(t.shape, generator=gen) * 1e-4).to(
                t.dtype)
    return serial.unflatten(flat, tmpl)


def as_data(state):
    return serial.decode_arrays(serial.encode_arrays(serial.flatten(state)))


def _bytes(t):
    return serial.encode_arrays({"x": t}).popitem()[1].tobytes()


def _ref(t):
    """A port tensor as the reference's numpy array (ml_dtypes)."""
    return jserial.decode_arrays(serial.encode_arrays({"x": t}))["x"]


def _pmeta(fp, group, name):
    return {f"{q['group']}/{q['name']}": q for q in fp["params"]}[
        f"{group}/{name}"]


def logical_error(state, fp, group, name):
    """Per-rank decoded compensation error of one param ``(..., D, numel)``,
    read through the reference's ``logical.stitch_error``."""
    p = _pmeta(fp, group, name)
    leaf = state["states"][group][name]
    arrs = [_ref(x) for x in (leaf if isinstance(leaf, tuple) else [leaf])]
    e = jlogical.stitch_error(arrs, p["buckets"], fp["topo"]["dp"],
                              p["chunklen"])
    return torch.from_numpy(np.ascontiguousarray(e[..., :p["numel"]]))


def _stateful(fp, group, name):
    """``(numel,)`` bool: the flat positions whose unit keeps a state."""
    p = _pmeta(fp, group, name)
    dp = fp["topo"]["dp"]
    m = torch.zeros(dp, p["chunklen"], dtype=torch.bool)
    for bd in p["buckets"]:
        if bd["needs_state"]:
            assert (bd["error_codec"], bd["error_scale"]) == \
                (QC.error_codec, QC.error_scale)
            m[:, bd["offset"]:bd["offset"] + bd["chunk_elems"]] = True
    return m.reshape(-1)[:p["numel"]]


def assert_error_migrated(src, fps, out, fpt):
    """Every target rank's error: the source rank's at an equal dp size,
    else the f8 requantization of the source ranks' mean; zero where the
    target unit keeps no state.  Master chunks move exactly.  The source
    errors must not all be zero."""
    moved = 0
    for p in fps["params"]:
        if not p["loco"]:
            continue
        g, n = p["group"], p["name"]
        e = logical_error(src, fps, g, n)
        moved += int(e.abs().max() > 0)
        if fps["topo"]["dp"] != fpt["topo"]["dp"]:
            e = Q.error_decode(Q.error_encode(e.mean(dim=-2), QC), QC)
            e = e.unsqueeze(-2).expand(e.shape[:-1] + (fpt["topo"]["dp"],
                                                       e.shape[-1]))
        want = torch.where(_stateful(fpt, g, n), e, torch.zeros(()))
        got = logical_error(out, fpt, g, n)
        assert torch.equal(got, want), f"{g}/{n}"
        np.testing.assert_array_equal(
            out["chunks"][g][n][..., :p["numel"]].numpy(),
            src["chunks"][g][n][..., :p["numel"]].numpy())
    assert moved


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

def test_f8_and_bf16_codes_cross_the_npz_both_ways():
    for dtype, words, jdtype in (
            (torch.float8_e4m3fn, np.uint8, ml_dtypes.float8_e4m3fn),
            (torch.bfloat16, np.uint16, ml_dtypes.bfloat16)):
        codes = np.arange(np.iinfo(words).max + 1, dtype=np.int64).astype(
            words)
        t = torch.from_numpy(codes.view(np.int16 if words == np.uint16
                                        else np.uint8).copy()).view(dtype)
        name = str(jnp.dtype(jdtype))
        stored = serial.encode_arrays({"s/x": t})
        assert list(stored) == [f"s/x::{name}"]
        np.testing.assert_array_equal(stored[f"s/x::{name}"], codes)
        # the reference reads the port's bytes ...
        back = jserial.decode_arrays(stored)["s/x"]
        assert back.dtype == jdtype
        np.testing.assert_array_equal(back.view(words), codes)
        ref_vals, port_vals = back.astype(np.float32), t.float().numpy()
        nan = np.isnan(ref_vals)
        np.testing.assert_array_equal(np.isnan(port_vals), nan)
        np.testing.assert_array_equal(port_vals[~nan], ref_vals[~nan])
        # ... and the port reads the reference's
        jstored = jserial.encode_arrays({"s/x": codes.view(jdtype)})
        assert set(jstored) == set(stored)
        assert serial.checksums(jstored) == jserial.checksums(jstored) \
            == serial.checksums(stored)
        got = serial.decode_arrays(jstored)["s/x"]
        assert got.dtype == dtype and _bytes(got) == codes.tobytes()


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("which", ["mono", "A", "B", "B-per-bucket"])
def test_fingerprint_matches_reference(dp, which):
    name, coalesce = which.split("-")[0], not which.endswith("per-bucket")
    run = _run(name, coalesce)
    groups = build_groups(TCFG, 1)
    fp = tsteps.state_fingerprint(run, groups, _topo(dp),
                                  tsteps.build_sync_plan(run, groups,
                                                         _topo(dp)))
    jrun = _run(name, coalesce, jax_side=True)
    jgroups = jsteps.build_model(JCFG, 1).groups()
    jtopo = JFP.MeshTopo(dp_axes=("data",), tp_axis="model", dp=dp, tp=1)
    jfp = jsteps.state_fingerprint(jrun, jgroups, jtopo,
                                   jsteps.build_sync_plan(jrun, jgroups,
                                                          jtopo))
    assert json.dumps(fp, sort_keys=True) == json.dumps(jfp, sort_keys=True)


# ---------------------------------------------------------------------------
# reshard (host-side)
# ---------------------------------------------------------------------------

def test_identity_reshard_bit_exact():
    fp, tmpl = make_layout(RUN_A, 2)
    state = random_state(tmpl)
    out = reshard(as_data(state), fp, fp, tmpl)
    flat, flat_out = serial.flatten(state), serial.flatten(out)
    assert set(flat) == set(flat_out)
    for k in flat:
        assert _bytes(flat_out[k]) == _bytes(flat[k]), k


def test_cross_dp_reshard_preserves_error():
    fpA, tmplA = make_layout(RUN_A, 2)
    fpB, tmplB = make_layout(RUN_B, 4)
    state = random_state(tmplA)
    out = reshard(as_data(state), fpA, fpB, tmplB)
    assert_error_migrated(state, fpA, out, fpB)


def test_monolithic_to_planned_and_back():
    fpM, tmplM = make_layout(RUN_MONO, 2)
    fpP, tmplP = make_layout(RUN_B, 4)
    assert not fpM["planned"] and fpP["planned"]
    state = random_state(tmplM)
    mid = reshard(as_data(state), fpM, fpP, tmplP)
    assert_error_migrated(state, fpM, mid, fpP)
    back = reshard(as_data(mid), fpP, fpM, tmplM)
    assert_error_migrated(mid, fpP, back, fpM)


# the port's reshard against the reference's, on the same stored arrays:
# case -> (source, target), each (run, dp) or (run, dp, tp, arch)
RESHARDS = {
    "identity": (("A", 2), ("A", 2)),
    "dp2-dp4-bucket-policy": (("A", 2), ("B", 4)),
    "dp2-dp1": (("A", 2), ("A", 1)),
    "dp4-dp2": (("B", 4), ("A", 2)),
    "bucket-size": (("A", 2), ("A128", 2)),
    "policy": (("A", 2), ("B64", 2)),
    "mono-planned": (("mono", 2), ("B", 4)),
    "planned-mono": (("A", 4), ("mono", 2)),
    "ef-dp2-dp4": (("ef", 2), ("ef", 4)),
    "onebit-dp2-dp1": (("onebit", 2), ("onebit", 1)),
    "naive4-dp2-dp4": (("naive4", 2), ("naive4", 4)),
    "mixed-dp4-dp2": (("mixed", 4), ("mixed", 2)),
    "mixed-to-loco": (("mixed", 2), ("A", 2)),
    "deepseek-dp2-dp4": (("A", 2, 1, "deepseek"), ("B", 4, 1, "deepseek")),
    "deepseek-identity": (("A", 1, 1, "deepseek"), ("A", 1, 1, "deepseek")),
    "tp2-dp2-dp1": (("A", 2, 2, "llama"), ("A", 1, 2, "llama")),
    "tp2-deepseek-dp2-dp4": (("A", 2, 2, "deepseek"),
                             ("B", 4, 2, "deepseek")),
}
_JGROUPS = {}


def _layout_spec(spec):
    """(run, dp) or (run, dp, tp, arch) -> (run, dp, tp, arch)."""
    return (*spec, 1, "llama")[:4]


def reference_layout(name, dp, tp=1, arch="llama", n_opt=2):
    """(fingerprint, zero template) of one run at one dp x tp, built by
    the reference, with ``n_opt`` chunk-mirroring optimizer trees."""
    if (arch, tp) not in _JGROUPS:
        _JGROUPS[arch, tp] = jsteps.build_model(ARCHS[arch][0], tp).groups()
    jgroups = _JGROUPS[arch, tp]
    jrun = _run(name, jax_side=True)
    jtopo = JFP.MeshTopo(dp_axes=("data",), tp_axis="model", dp=dp, tp=tp)
    plan = jsteps.build_sync_plan(jrun, jgroups, jtopo)
    cshape, sshape = JFP.train_state_shapes(jgroups, jrun.sync, jtopo,
                                            plan=plan)

    def zeros(tree):
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tree,
                            is_leaf=lambda x: isinstance(
                                x, jax.ShapeDtypeStruct))

    return (jsteps.state_fingerprint(jrun, jgroups, jtopo, plan),
            {"chunks": zeros(cshape), "states": zeros(sshape),
             "opt": tuple(zeros(cshape) for _ in range(n_opt))})


@pytest.mark.parametrize("case", sorted(RESHARDS))
def test_reshard_matches_reference_byte_for_byte(case):
    (sname, sdp, stp, sarch), (tname, tdp, ttp, tarch) = map(
        _layout_spec, RESHARDS[case])
    fps, tmpls = make_layout(_run(sname), sdp, stp, sarch)
    fpt, tmplt = make_layout(_run(tname), tdp, ttp, tarch)
    jfps, _ = reference_layout(sname, sdp, stp, sarch)
    jfpt, jtmplt = reference_layout(tname, tdp, ttp, tarch)
    assert json.dumps(fps, sort_keys=True) == json.dumps(jfps, sort_keys=True)
    state = random_state(tmpls, seed=3)
    stored = serial.encode_arrays(serial.flatten(state))
    port = serial.encode_arrays(serial.flatten(
        reshard(serial.decode_arrays(stored), fps, fpt, tmplt)))
    ref = jserial.encode_arrays(jserial.flatten(
        jreshard(jserial.decode_arrays(stored), jfps, jfpt, jtmplt)))
    assert set(port) == set(ref)
    nonzero = 0
    for k, a in ref.items():
        assert (port[k].dtype, port[k].shape) == (a.dtype, a.shape), k
        assert port[k].tobytes() == a.tobytes(), k
        nonzero += int(k.startswith("states/") and bool(a.any()))
    stateful = any(b["needs_state"] for p in fpt["params"]
                   for b in p["buckets"])
    assert nonzero or not stateful  # the compared errors are not all zero


def test_reshard_across_tp_is_refused():
    fps, tmpls = make_layout(RUN_A, 2, 2)
    fpt, tmplt = make_layout(RUN_A, 2, 1)
    with pytest.raises(CheckpointMismatch, match="TP sizes"):
        reshard(as_data(random_state(tmpls)), fps, fpt, tmplt)


def _pod_layout(spec, tp=2):
    """make_layout of a ``spec``-policy run (128 KiB buckets) on the
    reference's ``TOPO_POD``: dp 4 as pods 2 x data 2, tp 2; its
    fingerprint is the one the reference writes for the same run."""
    from repro_torch.core.comm import MeshAxis

    run = tsteps.RunConfig(sync=SYNC, bucket_bytes=128 << 10,
                           policy=TPOL.parse_policy(spec, SYNC))
    topo = MeshTopo(group=None, dp=4, rank=0, tp=tp, pods=2,
                    axes=(MeshAxis("pod", None), MeshAxis("data", None)))
    groups = build_groups(TCFG, tp)
    ts = tsteps.make_init(TCFG, run, topo, torch.device("cpu"))
    fp = tsteps.state_fingerprint(run, groups, topo,
                                  tsteps.build_sync_plan(run, groups, topo))
    jrun = jsteps.RunConfig(sync=JSync(), bucket_bytes=128 << 10,
                            policy=JPOL.parse_policy(spec, JSync()))
    jgroups = jsteps.build_model(JCFG, tp).groups()
    jtopo = JFP.MeshTopo(dp_axes=("pod", "data"), tp_axis="model", dp=4,
                         tp=tp, pods=2)
    jfp = jsteps.state_fingerprint(jrun, jgroups, jtopo,
                                   jsteps.build_sync_plan(jrun, jgroups,
                                                          jtopo))
    assert json.dumps(fp, sort_keys=True) == json.dumps(jfp, sort_keys=True)
    return fp, CKPT.global_template(ts, 4, tp)


def test_hier_bucket_state_round_trip():
    """``+hier`` changes the wire, not the state layout: on the pod mesh
    (whose ``pods``/``dp_axes`` the fingerprint records as the
    reference's) migrating flat <-> hier buckets at the same dp keeps
    every stored state byte (``tests/test_checkpoint.py``'s case)."""
    fpF, tmplF = _pod_layout("embed=loco8")
    fpH, tmplH = _pod_layout("embed=loco8,body=loco4+hier")
    assert fpH["topo"] == {"dp": 4, "tp": 2, "pods": 2, "wans": 1,
                           "dp_axes": ["pod", "data"]}
    diff = fingerprint_diff(fpF, fpH)
    assert any("hierarchical" in d for d in diff), diff
    state = random_state(tmplF)
    out = reshard(as_data(state), fpF, fpH, tmplH)
    back = reshard(as_data(out), fpH, fpF, tmplF)
    flat, flat_back = serial.flatten(state), serial.flatten(back)
    for k in flat:
        if k.startswith("states/"):
            assert _bytes(flat_back[k]) == _bytes(flat[k]), k


def test_tier_schedule_mismatch_names_tier(tmp_path):
    """Restoring across differing tier schedules fails loudly with the
    differing tier named: a WAN cadence change redefines what the carried
    accumulator means mid-period."""
    fpA, tmplA = _pod_layout("body=loco4+hier+wan:topk1%every16")
    fpB, tmplB = _pod_layout("body=loco4+hier+wan:topk1%every8")
    diff = fingerprint_diff(fpA, fpB)
    assert any("tiers.tier2.every" in d for d in diff), diff
    CKPT.save(str(tmp_path), 4, random_state(tmplA), fingerprint=fpA)
    with pytest.raises(CheckpointMismatch) as ei:
        CKPT.restore(str(tmp_path), 4, tmplB, fingerprint=fpB)
    assert "tiers.tier2.every" in str(ei.value)


# ---------------------------------------------------------------------------
# facade: mismatch failures, integrity, history
# ---------------------------------------------------------------------------

def test_mismatch_without_reshard_names_fields(tmp_path):
    fpA, tmplA = make_layout(RUN_A, 2)
    fpB, tmplB = make_layout(RUN_B, 4)
    CKPT.save(str(tmp_path), 3, random_state(tmplA), fingerprint=fpA)
    with pytest.raises(CheckpointMismatch) as ei:
        CKPT.restore(str(tmp_path), 3, tmplB, fingerprint=fpB)
    assert "topo.dp" in str(ei.value) and "resume-reshard" in str(ei.value)
    assert any("topo.dp" in d for d in fingerprint_diff(fpA, fpB))
    out = CKPT.restore(str(tmp_path), 3, tmplB, fingerprint=fpB, reshard=True)
    assert set(serial.flatten(out)) == set(serial.flatten(tmplB))


def test_shape_mismatch_without_fingerprint_is_loud(tmp_path):
    _, tmplA = make_layout(RUN_A, 2)
    fpB, tmplB = make_layout(RUN_B, 4)
    CKPT.save(str(tmp_path), 1, random_state(tmplA))
    with pytest.raises(ValueError, match="shape"):
        CKPT.restore(str(tmp_path), 1, tmplB)
    with pytest.raises(ValueError, match="no layout fingerprint"):
        CKPT.restore(str(tmp_path), 1, tmplB, fingerprint=fpB, reshard=True)


def test_corrupted_latest_falls_back(tmp_path):
    fp, tmpl = make_layout(RUN_A, 2)
    CKPT.save(str(tmp_path), 1, random_state(tmpl, seed=1), fingerprint=fp)
    CKPT.save(str(tmp_path), 2, random_state(tmpl, seed=2), fingerprint=fp)
    assert CKPT.latest_step(str(tmp_path)) == 2
    p2 = tmp_path / "ckpt_00000002.npz"
    p2.write_bytes(p2.read_bytes()[: p2.stat().st_size // 2])
    with pytest.warns(UserWarning, match="integrity"):
        assert CKPT.latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError, match="integrity"):
        CKPT.restore(str(tmp_path), 2, tmpl, fingerprint=fp)
    out = CKPT.restore(str(tmp_path), 1, tmpl, fingerprint=fp)
    assert set(serial.flatten(out)) == set(serial.flatten(tmpl))
    os.remove(p2)
    with pytest.warns(UserWarning, match="missing"):
        assert CKPT.latest_step(str(tmp_path)) == 1


def test_history_pruning_and_atomicity(tmp_path):
    fp, tmpl = make_layout(RUN_A, 2)
    for s in (1, 2, 3):
        CKPT.save(str(tmp_path), s, random_state(tmpl, seed=s),
                  fingerprint=fp, keep=2)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_00000002.npz", "ckpt_00000003.npz"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    hist = MAN.load_manifest(str(tmp_path))["history"]
    assert [e["step"] for e in hist] == [2, 3]
    assert all(e["checksums"] for e in hist)


def test_legacy_v1_manifest_still_restores(tmp_path):
    _, tmpl = make_layout(RUN_A, 2)
    state = random_state(tmpl)
    CKPT.save(str(tmp_path), 5, state)
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"latest": 5}, f)
    assert CKPT.latest_step(str(tmp_path)) == 5
    out = serial.flatten(CKPT.restore(str(tmp_path), 5, tmpl))
    for k, v in serial.flatten(state).items():
        assert _bytes(out[k]) == _bytes(v), k


# ---------------------------------------------------------------------------
# across frameworks: repro -> repro_torch (the port's CLI resumes)
# ---------------------------------------------------------------------------

MIX_MB, MIX_POLICY = 0.1, "embed=loco8,min=16384"
CLI = ["--arch", "llama2-400m", "--reduced", "--seq-len", str(SEQ),
       "--global-batch", str(BATCH), "--microbatch", str(MICRO),
       "--steps", "4", "--warmup", "2", "--lr", "2e-3", "--bucket-mb",
       str(MIX_MB), "--policy", MIX_POLICY, "--device", "cpu",
       "--log-every", "1"]


def _port_batches(steps):
    """The port CLI's batches (the reference trains on them too)."""
    fn = make_batch_fn(DataConfig(vocab=TCFG.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    return [fn(i)["tokens"].numpy().astype(np.int32) for i in range(steps)]


def test_reference_checkpoint_resumes_in_port(tmp_path):
    run = jsteps.RunConfig(sync=JSync(), optimizer="adam", lr=2e-3,
                           warmup_steps=2, total_steps=4, microbatch=MICRO,
                           bucket_bytes=int(MIX_MB * (1 << 20)),
                           policy=JPOL.parse_policy(MIX_POLICY, JSync()))
    mesh = make_local_mesh(dp=1, tp=1)
    init_fn, _ = jsteps.make_init(JCFG, run, mesh)
    chunks, states, opt = init_fn(jax.random.PRNGKey(0))
    bundle = jsteps.make_train_step(JCFG, run, mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    fp = jsteps.state_fingerprint(run, bundle.helpers["groups"],
                                  bundle.helpers["topo"],
                                  bundle.helpers["plan"])
    losses = []
    for i, tok in enumerate(_port_batches(4)):
        if i == 2:
            JCKPT.save(str(tmp_path), 2, {"chunks": chunks, "states": states,
                                          "opt": opt}, fingerprint=fp)
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
    res = ttrain.main(CLI + ["--ckpt-dir", str(tmp_path)])
    assert res["start"] == 2 and len(res["losses"]) == 2
    gaps = [abs(a - b) for a, b in zip(res["losses"], losses[2:])]
    print(f"port {res['losses']} reference {losses[2:]} gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(losses[2]), gaps
    assert max(gaps) <= LATER_ATOL, gaps
    # a fresh run from the same seed (no restore) is elsewhere: the
    # restore carried the reference's two steps
    assert ttrain.main(CLI + ["--steps", "3"])["losses"][2] != \
        res["losses"][0]


# ---------------------------------------------------------------------------
# across frameworks: the port at dp = 2 -> repro, and back into the port
# ---------------------------------------------------------------------------

N = 2


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    group = dist.group.WORLD
    topo = MeshTopo.from_group(group)
    run = dataclasses.replace(RUN_A, microbatch=MICRO, total_steps=4,
                              warmup_steps=2, lr=2e-3)
    groups = build_groups(TCFG, 1)
    fp = tsteps.state_fingerprint(run, groups, topo,
                                  tsteps.build_sync_plan(run, groups, topo))
    ts = tsteps.make_init(TCFG, run, topo, torch.device("cpu"))
    step_fn = tsteps.make_train_step(TCFG, run, topo, torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    step_fn(ts, 0, {"tokens": torch.from_numpy(_port_batches(1)[0]).long()})
    ckpt = os.path.join(out_dir, "ckpt")
    CKPT.save_train_state(ckpt, 1, ts, topo, fingerprint=fp)
    fresh = tsteps.make_init(TCFG, run, topo, torch.device("cpu"), seed=7)
    step = CKPT.resume(ckpt, fresh, topo, fingerprint=fp)
    mine = serial.flatten({"chunks": ts.chunks, "states": ts.states,
                           "opt": ts.opt})
    back = serial.flatten({"chunks": fresh.chunks, "states": fresh.states,
                           "opt": fresh.opt})
    torch.save({"step": step, "mine": mine,
                "resumed_same": all(_bytes(back[k]) == _bytes(v)
                                    for k, v in mine.items())},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_dp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_dp2")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=N,
                        start_method="spawn")
    return str(d / "ckpt"), [torch.load(d / f"rank{r}.pt")
                             for r in range(N)]


def test_port_dp2_checkpoint_restores_in_reference(port_dp2):
    ckpt, ranks = port_dp2
    assert all(r["step"] == 1 and r["resumed_same"] for r in ranks)
    jrun = _run("A", jax_side=True)
    mesh = make_local_mesh(dp=N, tp=1)
    init_fn, _ = jsteps.make_init(JCFG, jrun, mesh)
    chunks, states, opt = init_fn(jax.random.PRNGKey(0))
    jgroups = jsteps.build_model(JCFG, 1).groups()
    jtopo = JFP.MeshTopo.from_mesh(mesh)
    jfp = jsteps.state_fingerprint(jrun, jgroups, jtopo,
                                   jsteps.build_sync_plan(jrun, jgroups,
                                                          jtopo))
    entry = MAN.find_entry(ckpt, 1)
    assert json.dumps(entry["fingerprint"], sort_keys=True) == \
        json.dumps(jfp, sort_keys=True)
    assert JCKPT.latest_step(ckpt) == 1
    template = {"chunks": chunks, "states": states, "opt": opt}
    got = jserial.flatten(JCKPT.restore(ckpt, 1, template, fingerprint=jfp))
    tmpl = jserial.flatten(template)
    assert set(got) == set(tmpl) == set(ranks[0]["mine"])
    for k, a in got.items():
        assert a.shape == tmpl[k].shape and a.dtype == tmpl[k].dtype, k
        a = np.asarray(a)
        for r in range(N):
            local = ranks[r]["mine"][k]
            n = local.shape[-1]
            piece = (a[..., 0, r, :] if k.startswith("states/")
                     else a[..., 0, r * n:(r + 1) * n])
            assert np.ascontiguousarray(piece).tobytes() == _bytes(local), k
    # the optimizer moved: the checkpoint is not the init
    assert float(np.abs(np.asarray(got["opt/0/embed/tok"])).max()) > 0


def test_port_dp2_checkpoint_reshards_onto_dp1(port_dp2):
    ckpt, ranks = port_dp2
    fp2 = MAN.find_entry(ckpt, 1)["fingerprint"]
    fp1, tmpl1 = make_layout(RUN_A, 1)
    with pytest.raises(CheckpointMismatch, match="topo.dp"):
        CKPT.restore(ckpt, 1, tmpl1, fingerprint=fp1)
    out = CKPT.restore(ckpt, 1, tmpl1, fingerprint=fp1, reshard=True)
    src = CKPT.restore(ckpt, 1, make_layout(RUN_A, 2)[1], fingerprint=fp2)
    # one step of training left compensation errors; each dp-1 rank holds
    # the f8 requantization of their mean over the two source ranks
    assert_error_migrated(src, fp2, out, fp1)
    # and the reference reshards the same file into the same bytes
    jfp1, jtmpl1 = reference_layout("A", 1)
    ref = jserial.encode_arrays(jserial.flatten(
        JCKPT.restore(ckpt, 1, jtmpl1, fingerprint=jfp1, reshard=True)))
    port = serial.encode_arrays(serial.flatten(out))
    assert set(port) == set(ref)
    for k, a in ref.items():
        assert port[k].tobytes() == a.tobytes(), k


def test_cli_resume_reshard_across_bucket_size(tmp_path):
    """The CLI refuses to resume under another bucket layout unless
    ``--resume-reshard`` is given, and then continues from the step.  At
    one dp size the reshard moves every f8 error code unchanged, and the
    sync of a given error does not depend on the bucket size, so the
    resumed step gives the uninterrupted run's loss bit for bit; a run
    started afresh at the other bucket size does not."""
    full = ttrain.main(CLI + ["--steps", "3"])["losses"]
    first = CLI + ["--steps", "2", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "2"]
    assert ttrain.main(first)["losses"] == full[:2]
    other = CLI + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                   "--bucket-mb", "0.0625"]
    with pytest.raises(CheckpointMismatch, match="resume-reshard"):
        ttrain.main(other)
    res = ttrain.main(other + ["--resume-reshard"])
    assert res["start"] == 2 and res["losses"] == full[2:]
    fresh = ttrain.main(CLI + ["--steps", "3", "--bucket-mb", "0.0625"])
    assert fresh["losses"][2] != full[2]


# ---------------------------------------------------------------------------
# across frameworks at dp = 2 x tp = 2: both ways, four spawned gloo ranks
# ---------------------------------------------------------------------------

DP, TP = 2, 2
RUN_TP = dataclasses.replace(RUN_A, microbatch=MICRO, total_steps=4,
                             warmup_steps=2, lr=2e-3)


def _tp_worker(rank, rdv, out_dir, host, ref_dir):
    """Rank (data, model) = divmod(rank, 2): save the reference's trained
    state (``host``, its global arrays after one step) through the port,
    then resume the reference's own checkpoint of it and train steps 1-2."""
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, DP * TP, rdv)
    topo = MeshTopo.from_group(*tmesh.mesh_groups(TP))
    groups = build_groups(TCFG, TP)
    fp = tsteps.state_fingerprint(RUN_TP, groups, topo,
                                  tsteps.build_sync_plan(RUN_TP, groups, topo))
    ts = interop.from_reference(*host, groups=groups, rank=topo.rank,
                                dp=topo.dp, tp_rank=topo.tp_rank)
    CKPT.save_train_state(os.path.join(out_dir, "port"), 1, ts, topo,
                          fingerprint=fp)
    fresh = tsteps.make_init(TCFG, RUN_TP, topo, torch.device("cpu"), seed=7)
    step = CKPT.resume(ref_dir, fresh, topo, fingerprint=fp)
    mine = serial.flatten({"chunks": ts.chunks, "states": ts.states,
                           "opt": ts.opt})
    back = serial.flatten({"chunks": fresh.chunks, "states": fresh.states,
                           "opt": fresh.opt})
    differ = [k for k, v in mine.items() if _bytes(back[k]) != _bytes(v)]
    step_fn = tsteps.make_train_step(TCFG, RUN_TP, topo, torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    losses = [float(step_fn(fresh, i, {"tokens": torch.from_numpy(t).long()})
                    ["loss"]) for i, t in enumerate(_port_batches(3)) if i]
    torch.save({"step": step, "fp": fp, "losses": losses,
                "resumed_differ": differ},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def cross_tp(tmp_path_factory):
    """The reference at dp 2 x tp 2 trains step 0 and checkpoints
    (``ref/``, step 1), then trains steps 1-2; four port ranks save the
    same state (``port/``) and resume ``ref/``."""
    d = tmp_path_factory.mktemp("ckpt_tp")
    jrun = dataclasses.replace(_run("A", jax_side=True), microbatch=MICRO,
                               total_steps=4, warmup_steps=2, lr=2e-3)
    mesh = make_local_mesh(dp=DP, tp=TP)
    init_fn, _ = jsteps.make_init(JCFG, jrun, mesh)
    chunks, states, opt = init_fn(jax.random.PRNGKey(0))
    bundle = jsteps.make_train_step(JCFG, jrun, mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    jfp = jsteps.state_fingerprint(jrun, bundle.helpers["groups"],
                                   bundle.helpers["topo"],
                                   bundle.helpers["plan"])
    losses = []
    for i, tok in enumerate(_port_batches(3)):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
        if i == 0:
            host = jax.tree.map(np.asarray, (chunks, states, opt))
            JCKPT.save(str(d / "ref"), 1, {"chunks": chunks,
                                           "states": states, "opt": opt},
                       fingerprint=jfp)
    tmp.start_processes(_tp_worker, args=(str(d / "rdv"), str(d), host,
                                          str(d / "ref")),
                        nprocs=DP * TP, start_method="spawn")
    return d, jfp, losses, [torch.load(d / f"rank{r}.pt", weights_only=False)
                            for r in range(DP * TP)]


def test_port_tp2_checkpoint_is_the_references_bytes(cross_tp):
    """The port's dp 2 x tp 2 npz holds the reference's entries for the
    same arrays, byte for byte, and the reference's fingerprint."""
    d, jfp, _, ranks = cross_tp
    assert all(json.dumps(r["fp"], sort_keys=True)
               == json.dumps(jfp, sort_keys=True) for r in ranks)
    entry = MAN.find_entry(str(d / "port"), 1)
    assert json.dumps(entry["fingerprint"], sort_keys=True) == \
        json.dumps(jfp, sort_keys=True)
    port = np.load(d / "port" / MAN.ckpt_file(1))
    ref = np.load(d / "ref" / MAN.ckpt_file(1))
    assert sorted(port.files) == sorted(ref.files)
    moved = 0
    for k in ref.files:
        assert (port[k].dtype, port[k].shape) == (ref[k].dtype,
                                                  ref[k].shape), k
        assert port[k].tobytes() == ref[k].tobytes(), k
        moved += int(k.startswith("states/") and bool(ref[k].any()))
    assert moved  # one step of training left compensation errors


def test_reference_tp2_checkpoint_resumes_in_port(cross_tp):
    """Each rank restores its (data, model) piece bit for bit and the
    four ranks continue within the loss limits of the reference's own
    continuation."""
    _, _, losses, ranks = cross_tp
    assert [(r["step"], r["resumed_differ"]) for r in ranks] == \
        [(1, [])] * (DP * TP)
    got = ranks[0]["losses"]
    assert all(r["losses"] == got for r in ranks)
    gaps = [abs(a - b) for a, b in zip(got, losses[1:])]
    print(f"port {got} reference {losses[1:]} gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(losses[1]), gaps
    assert max(gaps) <= LATER_ATOL, gaps


# ---------------------------------------------------------------------------
# the other optimizers' states: sgd's empty tuple, adafactor_flat's one
# tree, lamb's two
# ---------------------------------------------------------------------------

OPT_TREES = {"sgd": 0, "adafactor": 1, "lamb": 2}


def _opt_run(opt, name="A", jax_side=False):
    return dataclasses.replace(_run(name, jax_side=jax_side), optimizer=opt)


@pytest.mark.parametrize("opt", sorted(OPT_TREES))
def test_optimizer_state_crosses_both_ways(opt, tmp_path):
    """The port's npz of a bucketed dp-2 state with ``opt``'s optimizer
    trees is the reference's, entry for entry and byte for byte; the
    reference restores it, writes it back, and the port restores that
    into the same bytes; the port reshards it onto dp 4 under another
    bucket layout as the reference does."""
    n = OPT_TREES[opt]
    fp, tmpl = make_layout(_opt_run(opt), 2)
    assert len(tmpl["opt"]) == n
    jfp, jtmpl = reference_layout("A", 2, n_opt=n)
    assert len(jsteps._make_opt(_opt_run(opt, jax_side=True)).init(
        {"g": {"x": jnp.zeros(4)}})) == n
    state = random_state(tmpl, seed=11)
    CKPT.save(str(tmp_path / "port"), 1, state, fingerprint=fp)
    got = JCKPT.restore(str(tmp_path / "port"), 1, jtmpl, fingerprint=jfp)
    JCKPT.save(str(tmp_path / "ref"), 1, got, fingerprint=jfp)
    port = np.load(tmp_path / "port" / MAN.ckpt_file(1))
    ref = np.load(tmp_path / "ref" / MAN.ckpt_file(1))
    assert sorted(port.files) == sorted(ref.files)
    assert sum(k.startswith("opt/") for k in ref.files) == \
        n * sum(k.startswith("chunks/") for k in ref.files)
    for k in ref.files:
        assert port[k].tobytes() == ref[k].tobytes(), k
    back = serial.flatten(CKPT.restore(str(tmp_path / "ref"), 1, tmpl,
                                       fingerprint=fp))
    for k, v in serial.flatten(state).items():
        assert _bytes(back[k]) == _bytes(v), k
    fpt, tmplt = make_layout(_opt_run(opt, "B"), 4)
    jfpt, jtmplt = reference_layout("B", 4, n_opt=n)
    stored = serial.encode_arrays(serial.flatten(state))
    moved = serial.encode_arrays(serial.flatten(
        reshard(serial.decode_arrays(stored), fp, fpt, tmplt)))
    jmoved = jserial.encode_arrays(jserial.flatten(
        jreshard(jserial.decode_arrays(stored), jfp, jfpt, jtmplt)))
    assert set(moved) == set(jmoved)
    for k, a in jmoved.items():
        assert moved[k].tobytes() == a.tobytes(), k


@pytest.mark.parametrize("opt", sorted(OPT_TREES))
def test_cli_resumes_each_optimizer(opt, tmp_path):
    """Three steps saving at step 2, then a run resuming step 2 from the
    same directory: the resumed step's loss is the uninterrupted run's,
    bit for bit."""
    argv = CLI + ["--optimizer", opt, "--steps", "3", "--ckpt-dir",
                  str(tmp_path)]
    full = ttrain.main(argv + ["--ckpt-every", "2"])["losses"]
    res = ttrain.main(argv)
    assert res["start"] == 2 and res["losses"] == full[2:]
