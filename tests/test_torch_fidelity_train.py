"""The gradient-fidelity probe in the sync and the train step, against the
JAX reference (CPU).

One spawn of four gloo ranks (ranks 0 and 1 also form a dp-2 group of
their own) while the parent runs the reference under ``shard_map``:

* Comm level, on numpy gradients from a seed, two rounds whose error
  state evolves: the reference stacks of ``dist_sync`` (loco at dp 2), of
  the coalesced and the per-bucket sync of a mixed plan with an fp bucket
  (dp 2), of ``hierarchical_sync`` over ``(pod, data)`` (4 ranks) and of
  the 3-tier loco8 -> naive8 -> top-k 25% schedule over ``(wan, pod,
  data)`` with a data axis of one rank, against the reference's
  ``probe=True`` calls: bit for bit at dp 2 (a mean of two peers is one
  add and an exact halving); at dp 4 the reference reduce adds four f32
  values in gloo's order and XLA in its own, so within 4 ulps of the
  stack's largest value.  The shards as the non-probe call's.
* Train step, reduced llama2-400m from the reference's init, bucketed
  (``embed=loco8,norm=fp,min=16384``, overlapped): 4 steps with
  ``fidelity_every`` 2 (probes at steps 1 and 3) and with 0 leave the
  same chunks, compressor states and optimizer state bit for bit; the
  non-probe steps issue the same collectives (counted by wrapping
  ``torch.distributed``'s and ``core/comm``'s), and a probe step adds
  exactly one reduce-scatter per loco gather's sync.  The probe metrics
  of step 1 against the reference's ``probe_fn``: the same keys;
  ``fidelity/cos`` within ``COS_ATOL``, the other globals within
  ``GLOBAL_RTOL``, every unit's cosine within ``UNIT_COS_ATOL`` and its
  other values within ``FID_RTOL``.  The packages' synced gradients
  differ by the bf16 backward's rounding, as for the health metrics of
  ``tests/test_torch_telemetry_step.py``; the gaps measured here are 9e-6
  on the global cosine, 6.7e-5 on a unit's cosine, 1.9e-3 relative on the
  global relative L2 and 2.6e-2 on one unit's gain (the embedding's,
  whose sparse rows make its small deviation norms sensitive).  A unit
  built wrongly reads far outside: with the probe buffers overwritten
  instead of accumulated over the microbatches, or the synced rows read
  one element off, some unit's cosine moves by 0.16 or 0.69 at least.  On
  identical arrays the schema agrees to 1e-6
  (``tests/test_torch_fidelity.py``).
* ``--pods 2 --hierarchical`` at dp 4: every unit's ``fid_stage1_rel``
  and ``fid_stage2_rel`` against the reference's within ``FID_RTOL``, and
  the triangle bound of the telescoping chain (``|sync - true| <= stage
  1 + stage 2``, ``>= |stage 1 - stage 2|``).
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

from repro.configs.base import ShapeConfig as JShape
from repro.core import comm as jcomm
from repro.core import loco as jloco
from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import comm as tcomm
from repro_torch.core import loco as tloco
from repro_torch.core import policy as TPOL
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TTF
from repro_torch.telemetry import fidelity as FID
from test_torch_codec import assert_f8_close
from test_torch_hier import NAIVE8, TOPK25, _both
from test_torch_optim_train import _batches
from test_torch_telemetry_step import count_collectives
from test_torch_train import BATCH, JCFG, MICRO, SEQ, TCFG
from test_torch_wirepack import EF, FP, LOCO4, LOCO8, NAIVET, _init_states, \
    make_plan

WORLD = 4
STEPS = 4
FID_RTOL = 5e-2
GLOBAL_RTOL = 5e-3
COS_ATOL = 1e-4
UNIT_COS_ATOL = 1e-3
PLAN = (LOCO4, LOCO8, NAIVET, FP, EF, LOCO4)
MONO = _both(strategy="loco")
HIER = _both(strategy="loco", hierarchical=True)
THREE = _both(strategy="loco", quant=dict(bits=8), hierarchical=True,
              tiers=(NAIVE8 + ({}, 1), TOPK25 + (1,)))
POLICY = "embed=loco8,norm=fp,min=16384"
# train case -> (dp, pods, sync fields, policy, bucket bytes)
TRAIN = {"bucketed": (2, 0, {}, POLICY, 64 << 10),
         "hier": (4, 2, dict(hierarchical=True), "", 0)}


def _grads(seed, ranks, length):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((2, ranks, length)).astype(np.float32) * 1e-3
    g[:, 1] *= 30.0
    return g


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _sync_rounds(rank, fn, state, grads):
    out = []
    for g in grads:
        shard, state, refs = fn(torch.from_numpy(g[rank]), state)
        out.append((shard.clone(), refs.clone(),
                    tuple(s.clone() for s in state)
                    if isinstance(state, tuple) else state.clone()))
    return out


def _comm(rank, pair, world, pod_axes, wan_axes):
    res = {}
    if rank < 2:
        n = 2 * 2048
        res["mono"] = _sync_rounds(
            rank, lambda g, s: tcomm.dist_sync(g, s, MONO[1], pair,
                                               probe=True),
            tloco.init_state(MONO[1], n), _grads(1, 2, n))
        plan = make_plan(PLAN, 1, D=2)
        for name, co in (("coalesced", True), ("per_bucket", False)):
            res[name] = _sync_rounds(
                rank, lambda g, s: tcomm.dist_sync_buckets(
                    g, s, plan, pair, coalesce=co, probe=True),
                _init_states(plan, False), _grads(2, 2, 2 * plan.chunklen))
    n = WORLD * 1024
    for name, cfg, axes in (("hier", HIER[1], pod_axes),
                            ("three_tier", THREE[1], wan_axes)):
        res[name] = _sync_rounds(
            rank, lambda g, s: tcomm.dist_sync(g, s, cfg, world, axes=axes,
                                               probe=True),
            tloco.init_state(cfg, n), _grads(len(name), WORLD, n))
    return res


def _run_cfgs(case, every):
    _, _, sync, policy, nbytes = TRAIN[case]
    common = dict(microbatch=MICRO, total_steps=STEPS, warmup_steps=0,
                  lr=1e-3, bucket_bytes=nbytes, fidelity_every=every)
    js, ts = JSync(**sync), SyncConfig(**sync)
    return (jsteps.RunConfig(sync=js, policy=JPOL.parse_policy(policy, js)
                             if policy else None, **common),
            tsteps.RunConfig(sync=ts, policy=TPOL.parse_policy(policy, ts)
                             if policy else None, **common))


def _train(case, topo, host, every, steps):
    ts = interop.from_reference(*host, groups=TTF.build_groups(TCFG, 1),
                                rank=topo.rank, dp=topo.dp)
    step_fn = tsteps.make_train_step(TCFG, _run_cfgs(case, every)[1], topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    metrics, counts = [], []
    probe_reduce = tcomm._probe_reduce
    for i, tok in enumerate(_batches()[:steps]):
        n = [0]

        def counted(*a, **k):
            n[0] += 1
            return probe_reduce(*a, **k)

        tcomm._probe_reduce = counted
        try:
            with count_collectives() as c:
                m = step_fn(ts, i, {"tokens": torch.from_numpy(tok).long()})
        finally:
            tcomm._probe_reduce = probe_reduce
        metrics.append({k: float(v) for k, v in m.items()})
        counts.append(dict(c, probe_reduce=n[0]))
    return ts, metrics, counts


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, WORLD, rdv)
    world = dist.group.WORLD
    pair = dist.new_group([0, 1])
    pod_axes = tmesh.mesh_axes(world, 1, pods=2)
    wan_axes = tmesh.mesh_axes(world, 1, pods=2, wans=2)
    res = {"comm": _comm(rank, pair, world, pod_axes, wan_axes)}
    if rank < 2:
        topo = MeshTopo.from_group(pair)
        on = _train("bucketed", topo, hosts["bucketed"], 2, STEPS)
        off = _train("bucketed", topo, hosts["bucketed"], 0, STEPS)
        res["onoff"] = [(ts.chunks, ts.states, ts.opt, m, c)
                        for ts, m, c in (on, off)]
    topo = MeshTopo.from_group(world, axes=pod_axes)
    res["hier"] = _train("hier", topo, hosts["hier"], 2, 2)[1]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _ref_sync(mesh, axes, fn, state0, grads):
    spec = P(axes)
    out, st = [], state0
    for g in grads:
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec),
                                  out_specs=(spec, spec, spec),
                                  check_vma=False))
        shard, st, refs = f(jnp.asarray(g), st)
        out.append((np.asarray(shard), np.asarray(refs), st))
    return out


def _ref_comm():
    res = {}
    m2 = make_local_mesh(dp=2, tp=1)
    n = 2 * 2048

    def mono(g, s):
        sh, ns, refs = jcomm.dist_sync(g.reshape(-1), s.reshape(-1), MONO[0],
                                       ("data",), probe=True)
        return sh, ns[None], refs[None]

    res["mono"] = _ref_sync(m2, ("data",), mono, jnp.stack(
        [jloco.init_state(MONO[0], n)] * 2), _grads(1, 2, n))
    plan = make_plan(PLAN, 0, D=2)
    for name, co in (("coalesced", True), ("per_bucket", False)):
        def body(g, s, co=co):
            sh, ns, refs = jcomm.dist_sync_buckets(
                g.reshape(-1), tuple(x[0] for x in s), plan, ("data",),
                coalesce=co, probe=True)
            return sh, tuple(x[None] for x in ns), refs[None]
        st0 = tuple(jnp.stack([jnp.zeros(x.shape, x.dtype)] * 2)
                    for x in map(torch_to_jax_zero, _init_states(
                        make_plan(PLAN, 1, D=2), False)))
        res[name] = _ref_sync(m2, ("data",), body, st0,
                              _grads(2, 2, 2 * plan.chunklen))
    n = WORLD * 1024
    for name, cfg, mesh, axes in (
            ("hier", HIER[0], make_local_mesh(dp=2, tp=1, pods=2),
             ("pod", "data")),
            ("three_tier", THREE[0],
             make_local_mesh(dp=1, tp=1, pods=2, wans=2),
             ("wan", "pod", "data"))):
        def body(g, s, cfg=cfg, axes=axes):
            sh, ns, refs = jcomm.dist_sync(g.reshape(-1), s.reshape(-1), cfg,
                                           axes, probe=True)
            return sh, ns[None], refs[None]
        res[name] = _ref_sync(mesh, axes, body, jnp.stack(
            [jloco.init_state(cfg, n)] * WORLD), _grads(len(name), WORLD, n))
    return res


def torch_to_jax_zero(t):
    """A zero array of the port state's shape and dtype, on the JAX side."""
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float8_e4m3fn: jnp.float8_e4m3fn}[t.dtype]
    return jnp.zeros(t.shape, dt)


def _mesh(case):
    dp, pods = TRAIN[case][:2]
    return (make_local_mesh(dp=dp // pods, tp=1, pods=pods) if pods
            else make_local_mesh(dp=dp, tp=1))


def _ref_probe_metrics(case, mesh, state):
    """The reference's metrics of steps 0 (normal) and 1 (probe)."""
    chunks, states, opt = state
    bundle = jsteps.make_train_step(JCFG, _run_cfgs(case, 2)[0], mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    out = []
    for i, tok in enumerate(_batches()[:2]):
        fn = bundle.probe_fn if i == 1 else bundle.fn
        chunks, states, opt, m = fn(chunks, states, opt, jnp.int32(i),
                                    {"tokens": jnp.asarray(tok)})
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fidelity_train")
    inits = {}
    for c in TRAIN:
        mesh = _mesh(c)
        init_fn, _ = jsteps.make_init(JCFG, _run_cfgs(c, 2)[0], mesh)
        inits[c] = (mesh, init_fn(jax.random.PRNGKey(0)))
    hosts = {c: jax.tree.map(np.asarray, st) for c, (_, st) in inits.items()}
    ctx = tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                              nprocs=WORLD, join=False, start_method="spawn")
    ref = {"comm": _ref_comm()}
    for c in TRAIN:
        ref[c] = _ref_probe_metrics(c, *inits[c])
    while not ctx.join():
        pass
    return [torch.load(d / f"rank{r}.pt") for r in range(WORLD)], ref


# ---------------------------------------------------------------------------
# comm level
# ---------------------------------------------------------------------------

def _state_close(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _state_close(g, w)
        return
    if got.dtype == torch.float8_e4m3fn:
        assert_f8_close(got, want)
    else:
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("name", ["mono", "coalesced", "per_bucket", "hier",
                                  "three_tier"])
def test_reference_stacks_match_reference(runs, name):
    ranks, ref = runs
    world = 2 if name in ("mono", "coalesced", "per_bucket") else WORLD
    for r, (shard, refs, st) in enumerate(ref["comm"][name]):
        for rank in range(world):
            got_shard, got_refs, got_st = ranks[rank]["comm"][name][r]
            want_refs = refs[rank]
            assert got_refs.dtype == torch.float32
            assert tuple(got_refs.shape) == want_refs.shape, name
            if world == 2:
                np.testing.assert_array_equal(
                    got_refs.numpy(), want_refs,
                    err_msg=f"{name} round {r} rank {rank}")
            else:
                np.testing.assert_allclose(
                    got_refs.numpy(), want_refs, rtol=0,
                    atol=4 * np.spacing(np.abs(want_refs).max()),
                    err_msg=f"{name} round {r} rank {rank}")
            np.testing.assert_array_equal(
                got_shard.float().numpy(),
                shard.reshape(world, -1)[rank])
            _state_close(got_st, jax.tree.map(
                lambda a: np.asarray(a)[rank], st))
    assert float(ranks[0]["comm"][name][1][1][1].abs().max()) > 0


def test_three_tier_stack_has_its_mid_tier_row(runs):
    ranks, _ = runs
    refs = ranks[0]["comm"]["three_tier"][0][1]
    assert refs.shape[0] == 4  # true, comp, nc, one mid-tier reference
    assert float(refs[3].abs().max()) > 0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _equal_trees(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{where}/{i}")
    else:
        assert a.dtype == b.dtype and torch.equal(
            a.contiguous().view(torch.uint8),
            b.contiguous().view(torch.uint8)), where


def test_probe_leaves_the_trajectory_bit_for_bit(runs):
    ranks, _ = runs
    for rank in range(2):
        (c1, s1, o1, m1, _), (c0, s0, o0, m0, _) = ranks[rank]["onoff"]
        _equal_trees(c1, c0, "chunks")
        _equal_trees(s1, s0, "states")
        _equal_trees(o1, o0, "opt")
        assert [m["loss"] for m in m1] == [m["loss"] for m in m0]
        assert [m["gnorm"] for m in m1] == [m["gnorm"] for m in m0]


def test_nonprobe_steps_issue_the_same_collectives(runs):
    """Steps 0 and 2 of the run with probes issue the collectives of the
    run without; a probe step runs one reference reduce per loco gather's
    sync (the flat schedule's collectives besides)."""
    ranks, _ = runs
    (_, _, _, _, on), (_, _, _, _, off) = ranks[0]["onoff"]
    for step in (0, 2):
        assert on[step] == off[step], step
        assert on[step]["probe_reduce"] == 0
    accum = BATCH // 2 // MICRO
    n_sync = sum(g.n_layers or 1 for g in TTF.build_groups(TCFG, 1)
                 for i in g.infos if i.loco) * accum
    assert on[1]["probe_reduce"] == on[3]["probe_reduce"] == n_sync
    assert off[1]["probe_reduce"] == 0


def test_probe_metrics_match_reference(runs):
    ranks, ref = runs
    got, want = ranks[0]["onoff"][0][3][1], ref["bucketed"][1]
    assert ranks[1]["onoff"][0][3][1] == got
    fid = {k for k in want if k.startswith("fidelity/") or "/fid_" in k}
    assert fid and fid == {k for k in got if k.startswith("fidelity/")
                           or "/fid_" in k}
    assert not any("fid" in k for k in ranks[0]["onoff"][0][3][0])
    print({k: (got[k], want[k]) for k in ("fidelity/cos",
                                          "fidelity/rel_l2",
                                          "fidelity/comp_gain")})
    gaps = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
            for k in fid}
    worst = max(gaps, key=gaps.get)
    print(f"largest relative gap {gaps[worst]:.3e} at {worst}")
    cos_gap = max(abs(got[k] - want[k]) for k in fid
                  if k.endswith("/fid_cos"))
    print(f"largest gap of a unit's cosine {cos_gap:.3e}")
    np.testing.assert_allclose(got["fidelity/cos"], want["fidelity/cos"],
                               atol=COS_ATOL)
    for k in FID.GLOBAL_KEYS[1:]:
        np.testing.assert_allclose(got[k], want[k], rtol=GLOBAL_RTOL,
                                   err_msg=k)
    for k in sorted(fid):
        assert math.isfinite(got[k]), k
        if k.endswith("/fid_cos"):
            np.testing.assert_allclose(got[k], want[k], atol=UNIT_COS_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=FID_RTOL,
                                       atol=1e-6, err_msg=k)


def test_hierarchical_stage_attribution(runs):
    ranks, ref = runs
    got, want = ranks[0]["hier"][1], ref["hier"][1]
    units = sorted({k.rsplit("/", 1)[0] for k in want if "/fid_stage" in k})
    assert units
    print("hier stage gaps", max(
        abs(got[k] - want[k]) / abs(want[k]) for k in want
        if "/fid_" in k))
    for u in units:
        rel = got[f"{u}/fid_rel_l2"]
        s1, s2 = got[f"{u}/fid_stage1_rel"], got[f"{u}/fid_stage2_rel"]
        assert rel <= s1 + s2 + 1e-5 and rel >= abs(s1 - s2) - 1e-5, u
        for k in ("fid_stage1_rel", "fid_stage2_rel", "fid_rel_l2"):
            np.testing.assert_allclose(got[f"{u}/{k}"], want[f"{u}/{k}"],
                                       rtol=FID_RTOL, err_msg=f"{u}/{k}")
    assert all(ranks[r]["hier"][1] == got for r in range(WORLD))
    assert set(FID.GLOBAL_KEYS) <= set(got)
