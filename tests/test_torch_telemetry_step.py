"""The train step's telemetry against the reference's (CPU, reduced
llama2-400m on a spawned 2-rank gloo group from the reference's init; the
reference trains under ``shard_map`` while the ranks do).

* Step-0 metrics at dp 2 (``--sync loco``, and ``--quant-mode fixed``,
  where the saturation rate is far from 0) and at dp 1 x tp 2
  (replicated params pre-divided by tp): the same keys as the
  reference's; the parameter and update norms and ratio within rtol 1e-4;
  ``err_norm`` and ``sat_rate``, which re-quantise the synced gradient,
  within ``GRAD_RTOL`` (the packages' synced gradients differ by the bf16
  backward's rounding; on identical inputs the metric code agrees to 1e-5,
  ``tests/test_torch_telemetry.py``).
* ``err_norm``, ``param_norm`` and ``update_norm`` are the square roots of
  the ranks' local sums of the state the step leaves (rtol 1e-5).
* With telemetry on and off: the same collectives, counted by wrapping
  ``torch.distributed``'s and ``core/comm``'s, and the same losses bit
  for bit, monolithic and bucketed-overlapped.
"""
import collections
import contextlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import comm
from repro_torch.core.flatparam import MeshTopo
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TTF
from repro_torch.telemetry import metrics as M
from repro_torch.telemetry import wire as WIRE
from test_torch_optim_train import _batches
from test_torch_telemetry import ONOFF, _run_cfg
from test_torch_train import BATCH, JCFG, SEQ, TCFG

METRIC_RTOL = 1e-4
# case -> (dp, tp, QuantConfig fields)
STEP_CASES = {"loco-dp2": (2, 1, {}), "fixed-dp2": (2, 1, {"mode": "fixed"}),
              "loco-tp2": (1, 2, {})}
def _reference_step0(case):
    """(init state as numpy trees, step-0 metrics) of the reference."""
    dp, tp, quant = STEP_CASES[case]
    mesh = make_local_mesh(dp=dp, tp=tp)
    run = _run_cfg(quant, True, jax_side=True)
    init_fn, _ = jsteps.make_init(JCFG, run, mesh)
    state = init_fn(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, state)
    bundle = jsteps.make_train_step(JCFG, run, mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    *_, m = bundle.fn(*state, jnp.int32(0),
                      {"tokens": jnp.asarray(_batches()[0])})
    return host, {k: float(v) for k, v in m.items()}


# torch.distributed's collectives, and core/comm's, which bind theirs at
# import
_DIST = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_gather", "broadcast", "reduce_scatter",
         "gather", "scatter", "barrier")
_COMM = ("_ALL_GATHER", "_REDUCE_SCATTER")


@contextlib.contextmanager
def count_collectives():
    counts = collections.Counter()

    def wrap(name, fn):
        def counted(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return counted

    saved = [(dist, n, getattr(dist, n)) for n in _DIST if hasattr(dist, n)]
    saved += [(comm, n, getattr(comm, n)) for n in _COMM]
    for mod, n, fn in saved:
        setattr(mod, n, wrap(n, fn))
    try:
        yield counts
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def _onoff(topo, buckets):
    """Losses and collectives of 2 steps with telemetry off and on, from
    the same fresh init; and the metric keys of the on run."""
    out = {}
    for on in (False, True):
        run = _run_cfg({}, on, buckets=buckets)
        ts = tsteps.make_init(TCFG, run, topo, torch.device("cpu"))
        step_fn = tsteps.make_train_step(TCFG, run, topo, torch.device("cpu"),
                                         ShapeConfig("t", SEQ, BATCH,
                                                     "train"))
        with count_collectives() as counts:
            ms = [step_fn(ts, i, {"tokens": torch.from_numpy(t).long()})
                  for i, t in enumerate(_batches()[:2])]
        out[on] = ([float(m["loss"]) for m in ms], dict(counts),
                   list(ms[-1]))
    return out


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, 2, rdv)
    res = {}
    for tp in (1, 2):
        topo = MeshTopo.from_group(*tmesh.mesh_groups(tp))
        for case, (dp, ctp, quant) in STEP_CASES.items():
            if ctp != tp:
                continue
            ts = interop.from_reference(
                *hosts[case], groups=TTF.build_groups(TCFG, tp),
                rank=topo.rank, dp=topo.dp, tp_rank=topo.tp_rank)
            step_fn = tsteps.make_train_step(
                TCFG, _run_cfg(quant, True), topo, torch.device("cpu"),
                ShapeConfig("t", SEQ, BATCH, "train"))
            groups = TTF.build_groups(TCFG, tp)
            before = {g: {n: t.clone() for n, t in sub.items()}
                      for g, sub in ts.chunks.items()}
            m = step_fn(ts, 0, {"tokens": torch.from_numpy(
                _batches()[0]).long()})
            res[case] = {k: float(v) for k, v in m.items()}
            # this rank's share of the global sums, from the state the step
            # left (its states before the next step's reset, its chunks)
            run = _run_cfg(quant, True)
            res[case + "/oracle"] = {
                "err_sq": float(WIRE.error_sq_norm_local(
                    ts.states, groups, run.sync, None, tp)),
                "param_sq": float(M._norm_sq_local(
                    lambda g, n: before[g][n], groups, tp, "cpu")),
                "update_sq": float(M._norm_sq_local(
                    lambda g, n: ts.chunks[g][n] - before[g][n], groups, tp,
                    "cpu"))}
        if tp == 1:
            res["onoff"] = {name: _onoff(topo, b) for name, b in ONOFF.items()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """(port ranks' results, reference step-0 metrics per case): the
    port's ranks train while the reference does."""
    d = tmp_path_factory.mktemp("telemetry")
    inits = {}
    for case, (dp, tp, quant) in STEP_CASES.items():
        mesh = make_local_mesh(dp=dp, tp=tp)
        init_fn, _ = jsteps.make_init(JCFG, _run_cfg(quant, True, True),
                                      mesh)
        inits[case] = jax.tree.map(np.asarray,
                                   init_fn(jax.random.PRNGKey(0)))
    ctx = tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), inits),
                              nprocs=2, join=False, start_method="spawn")
    ref = {case: _reference_step0(case)[1] for case in STEP_CASES}
    while not ctx.join():
        pass
    return ([torch.load(d / f"rank{r}.pt") for r in range(2)], ref)


# Gradient-derived metrics (err_norm, sat_rate, per unit) are counts and
# sums over the re-quantised synced gradient: the packages' synced
# gradients differ by the bf16 backward's rounding (step-0 gnorm gaps up to
# 1.3e-3 relative here), and elements near a rounding edge flip, so these
# are held to the reference within GRAD_RTOL globally; on the same inputs
# the metric code itself agrees to 1e-5 (test_local_vector_matches_reference).
GRAD_RTOL = 2e-2
EXACT_KEYS = ("param_norm", "update_norm", "update_ratio", "nonfinite")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step0_metrics_match_reference(step_runs, case):
    ranks, ref = step_runs
    got, want = ranks[0][case], ref[case]
    assert ranks[1][case] == got  # global after the all-reduce
    assert sorted(got) == sorted(want)  # the same keys
    print(f"{case}: err_norm {got['err_norm']} (reference "
          f"{want['err_norm']}), sat_rate {got['sat_rate']} "
          f"({want['sat_rate']}), update_ratio {got['update_ratio']} "
          f"({want['update_ratio']}), gnorm {got['gnorm']} "
          f"({want['gnorm']})")
    for k in EXACT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   err_msg=k)
    for k in ("err_norm", "sat_rate"):
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   err_msg=k)
    assert all(math.isfinite(v) for v in got.values())
    assert got["nonfinite"] == 0 and got["err_norm"] > 0
    if case == "fixed-dp2":
        assert got["sat_rate"] > 0.05  # far from 0: the rates are seen


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step0_metrics_are_the_ranks_sums(step_runs, case):
    """err_norm, param_norm and update_norm are the square roots of the
    ranks' local sums, computed from the state each rank holds after the
    step (replicated params counted once over the tp ranks)."""
    ranks, _ = step_runs
    got = ranks[0][case]
    tot = {k: sum(r[case + "/oracle"][k] for r in ranks)
           for k in ("err_sq", "param_sq", "update_sq")}
    for key, s2 in (("err_norm", "err_sq"), ("param_norm", "param_sq"),
                    ("update_norm", "update_sq")):
        np.testing.assert_allclose(got[key], math.sqrt(tot[s2]), rtol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("plan", sorted(ONOFF))
def test_telemetry_adds_no_collective_and_moves_no_bit(step_runs, plan):
    ranks, _ = step_runs
    for r in ranks:
        (off_l, off_c, off_k), (on_l, on_c, on_k) = (r["onoff"][plan][False],
                                                     r["onoff"][plan][True])
        assert on_c == off_c and off_c.get("all_reduce")
        assert on_l == off_l
        assert set(off_k) == {"loss", "gnorm", "lr"}
        assert set(on_k) - set(off_k) and "err_norm" in on_k
    print(f"{plan}: collectives per rank in 2 steps {off_c}")


