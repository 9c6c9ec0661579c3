"""The slice as a whole at tp > 1: training under tensor, sequence and
expert parallelism against the JAX reference (CPU, global batch 4, 3
steps; seq 16 for the dense runs, 32 for the MoE runs).  The MoE runs
need the tokens because routing is discrete: at seq 16 one token's
routing margin is 2.4e-4 in the reference (7.0e-3 in the port), the
packages' 1-ulp bf16 differences send it to another expert group, and its
row's step-0 loss moves by 0.040 (``test_moe_seq16_gap_is_a_routing_near_tie``
pins this and shows that every other row agrees).

Both packages start from the reference's ``make_init`` state on its
``(data, model)`` mesh (``interop.from_reference`` hands each rank its
``(data, model)`` piece) and see the same numpy batches.  The port runs on
spawned gloo groups (``file://`` rendezvous): 2 ranks for dp 1 x tp 2 and
4 for dp 2 x tp 2, global rank ``data * 2 + model``; the reference under
``shard_map`` on ``make_local_mesh(dp, 2)``, in the main process while
the spawned ranks train.

* reduced llama2-400m at dp 1 x tp 2 and dp 2 x tp 2, ``--sync fp`` then
  ``--sync loco``, and at dp 2 x tp 2 the bucketed sync ``--bucket-mb
  0.0625 --policy "embed=loco8,min=16384"`` (microbatch 2);
* reduced deepseek-v3-moe at dp 1 x tp 2: ``ep_a2a`` with the ``fp`` wire
  (``--sync fp``) and the ``block8`` wire (``--sync loco``), and
  ``tp_dense`` (``--sync fp``); at microbatch 1 against the reference's
  default run (sequence parallelism on), at microbatch 2 against the
  reference with ``sequence_parallel=False``: the port keeps sequence
  parallelism on, and its expert layer returns the sequence shard of the
  non-SP result, where the reference's SP reshape is wrong for
  microbatches of more than one row (ROADMAP C);
  ``test_reference_ep_under_sp_fault`` shows that the reference's own SP
  run leaves the limits there.

Bounds are the north star's (tests/test_torch_train.py): step-0 loss
within 2e-3 relative, steps 1-2 within 2e-2 absolute; the router losses
within 2e-2 relative.  Every rank reports the same (world-reduced) loss.
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

from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.models import moe as JMOE
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import policy as TPOL
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TTF

TP, BATCH, STEPS = 2, 4, 3
SEQ = {"dense": 16, "moe": 32}
STEP0_RTOL, LATER_ATOL, ROUTER_RTOL = 2e-3, 2e-2, 2e-2
BUCKETS = (1 << 16, "embed=loco8,min=16384")  # --bucket-mb 0.0625

# (arch, dp, sync, moe variant, microbatch, bucketed)
LLAMA = [("dense", dp, s, None, 2, False) for dp in (1, 2)
         for s in ("fp", "loco")] + [("dense", 2, "loco", None, 2, True)]
MOE = [("moe", 1, sync, variant, micro, False)
       for variant, sync in (("ep_a2a fp", "fp"), ("ep_a2a block8", "loco"),
                             ("tp_dense fp", "fp"))
       for micro in (1, 2)]
RUNS = LLAMA + MOE


def _cfgs(run):
    arch, _, _, variant, _, _ = run
    name = "llama2-400m" if arch == "dense" else "deepseek-v3-moe"
    cfgs = jreduced(jget_arch(name)), reduced(get_arch(name))
    if variant is None:
        return cfgs
    impl, codec = variant.split()
    return tuple(dataclasses.replace(c, moe_impl=impl, moe_a2a_codec=codec)
                 for c in cfgs)


def _batches(run, vocab, seq=None):
    rng = np.random.default_rng(44)
    seq = seq or SEQ[run[0]]
    return [rng.integers(0, vocab, (BATCH, seq + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _run_cfg(run, jax_side, sequence_parallel=True):
    _, _, sync, _, micro, bucketed = run
    steps_mod, cfg, pol = ((jsteps, JSync(strategy=sync), JPOL) if jax_side
                           else (tsteps, SyncConfig(strategy=sync), TPOL))
    kw = dict(optimizer="adam", microbatch=micro, total_steps=STEPS,
              warmup_steps=2, lr=2e-3)
    if jax_side:
        kw["sequence_parallel"] = sequence_parallel
    if bucketed:
        kw.update(bucket_bytes=BUCKETS[0],
                  policy=pol.parse_policy(BUCKETS[1], cfg))
    return steps_mod.RunConfig(sync=cfg, **kw)


def _init(run):
    """The reference's ``make_init`` state on its dp x tp mesh."""
    jcfg, _ = _cfgs(run)
    mesh = make_local_mesh(dp=run[1], tp=TP)
    init_fn, _ = jsteps.make_init(jcfg, _run_cfg(run, True), mesh,
                                  JShape("t", SEQ[run[0]], BATCH, "train"))
    return init_fn(jax.random.PRNGKey(0))


def _reference(run, state, sequence_parallel):
    """Per-step metrics of the JAX reference from ``state``."""
    jcfg, _ = _cfgs(run)
    mesh = make_local_mesh(dp=run[1], tp=TP)
    bundle = jsteps.make_train_step(jcfg, _run_cfg(run, True,
                                                   sequence_parallel),
                                    mesh, JShape("t", SEQ[run[0]], BATCH,
                                                 "train"))
    chunks, states, opt = state
    out = []
    for i, tok in enumerate(_batches(run, jcfg.vocab)):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        out.append({k: float(m[k]) for k in ("loss", "moe_aux", "moe_z",
                                             "gnorm") if k in m})
    return out


def _port(run, host, topo):
    _, tcfg = _cfgs(run)
    ts = interop.from_reference(*host, groups=TTF.build_groups(tcfg, TP),
                                rank=topo.rank, dp=topo.dp,
                                tp_rank=topo.tp_rank)
    step_fn = tsteps.make_train_step(tcfg, _run_cfg(run, False), topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", SEQ[run[0]], BATCH,
                                                 "train"))
    return [{k: float(v) for k, v in step_fn(
        ts, i, {"tokens": torch.from_numpy(t).long()}).items()
        if k in ("loss", "moe_aux", "moe_z", "gnorm")}
        for i, t in enumerate(_batches(run, tcfg.vocab))]


def _worker(rank, world, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, world, rdv)
    topo = MeshTopo.from_group(*tmesh.mesh_groups(TP))
    assert (topo.rank, topo.tp_rank) == divmod(rank, TP)
    res = {run: _port(run, hosts[run], topo) for run in hosts}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, port): per run the reference's metrics (its default,
    sequence parallelism on, for the dense runs and MoE microbatch 1;
    without it for MoE microbatch 2; plus, under "sp fault", its own SP
    run of MOE[1]) and the port's per-rank metrics, from one 2-rank and
    one 4-rank spawn that train while the reference runs."""
    states = {run: _init(run) for run in RUNS}
    spawns = []
    for dp in (1, 2):
        d = tmp_path_factory.mktemp(f"tp_train_dp{dp}")
        hosts = {run: jax.tree.map(np.asarray, states[run]) for run in RUNS
                 if run[1] == dp}
        ctx = tmp.start_processes(
            _worker, args=(dp * TP, str(d / "rdv"), str(d), hosts),
            nprocs=dp * TP, join=False, start_method="spawn")
        spawns.append((d, dp * TP, hosts, ctx))
    ref = {run: _reference(run, states[run], run[0] == "dense" or run[4] == 1)
           for run in RUNS}
    # (the reference's step donated the first state's buffers)
    ref["sp fault"] = _reference(MOE[1], _init(MOE[1]), True)
    port = {}
    for d, world, hosts, ctx in spawns:
        while not ctx.join():
            pass
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
        for run in hosts:
            port[run] = [r[run] for r in ranks]
    return ref, port


def _assert_close(port, ref):
    gaps = [abs(p["loss"] - r["loss"]) for p, r in zip(port, ref)]
    print(f"port {port}\nreference {ref}\nloss gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(ref[0]["loss"]), gaps
    assert max(gaps[1:]) <= LATER_ATOL, gaps
    for key in ("moe_aux", "moe_z"):
        for p, r in zip(port, ref):
            if key in r:
                assert abs(p[key] - r[key]) <= ROUTER_RTOL * abs(r[key]), \
                    (key, p[key], r[key])
    assert all(np.isfinite(p["loss"]) for p in port)


def _check(run, results):
    ref, port = results
    ranks = port[run]
    _assert_close(ranks[0], ref[run])
    assert all(r == ranks[0] for r in ranks), "ranks disagree"


@pytest.mark.parametrize("run", LLAMA, ids=lambda r: (
    f"dp{r[1]}-{r[2]}{'-bucketed' if r[5] else ''}"))
def test_llama_tp2_matches_reference(results, run):
    _check(run, results)


@pytest.mark.parametrize("run", MOE, ids=lambda r: (
    f"{r[3].replace(' ', '-')}-micro{r[4]}"))
def test_moe_tp2_matches_reference(results, run):
    _check(run, results)


def test_reference_ep_under_sp_fault(results):
    """At microbatch 2 the reference's own sequence-parallel ep_a2a run
    leaves the step-0 loss limit around its non-SP run, which the port
    matches: the fault the port does not copy."""
    ref, port = results
    run = MOE[1]
    assert run[3] == "ep_a2a fp" and run[4] == 2
    ref_sp, want = ref["sp fault"][0]["loss"], ref[run][0]["loss"]
    got = port[run][0][0]["loss"]
    print(f"step 0: port {got}, reference non-SP {want}, reference SP "
          f"{ref_sp}")
    assert abs(got - want) <= STEP0_RTOL * abs(want)
    assert abs(ref_sp - want) > STEP0_RTOL * abs(want)


@pytest.mark.parametrize("dp", [1, 2])
def test_tp_gnorm_is_the_references(results, dp):
    """The TP-aware global norm (replicated leaves' square sums divided by
    tp, reduced over the world): step 0 of the fp runs within the step-0
    loss bound of the reference's gnorm."""
    ref, port = results
    run = ("dense", dp, "fp", None, 2, False)
    got, want = port[run][0][0]["gnorm"], ref[run][0]["gnorm"]
    print(f"gnorm port {got} reference {want}")
    assert abs(got - want) <= STEP0_RTOL * want


# --- seq 16: where the MoE runs would leave the limits, and why ----------
ROW_RUN, ROW_SEQ = MOE[0], 16   # ep_a2a fp, microbatch 1
ROUTE_TIE = 0.02  # a routing margin (in probability) that 1-ulp bf16 moves


def _route_margin(logits, cfg):
    """Per token, the smaller of the routing decisions' margins: the
    ``group_top_k``-th group score over the next, and the ``top_k``-th
    routable expert prob over the next (route's rule, in numpy)."""
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    T, G, k, gk = len(p), cfg.n_expert_groups, cfg.top_k, cfg.group_top_k
    pg = p.reshape(T, G, -1)
    gscore = np.sort(pg, -1)[..., -min(2, pg.shape[-1]):].sum(-1)
    order = np.argsort(-gscore, -1, kind="stable")
    gs = np.take_along_axis(gscore, order, -1)
    mask = np.zeros((T, G))
    np.put_along_axis(mask, order[:, :gk], 1.0, -1)
    sel = -np.sort(-(pg * mask[..., None]).reshape(T, -1), -1)
    return np.minimum(gs[:, gk - 1] - gs[:, gk], sel[:, k - 1] - sel[:, k])


def _forward_routes(recs):
    """Each distinct routing call of one step (a recomputed layer repeats
    its forward's logits), in order."""
    return list({lg.tobytes(): (ti, lg) for ti, lg in recs}.values())


def _row_worker(rank, world, rdv, out_dir, host, rows):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, world, rdv)
    topo = MeshTopo.from_group(*tmesh.mesh_groups(TP))
    recs, route = [], TMOE.route

    def recording_route(x2d, w, *a):
        out = route(x2d, w, *a)
        with torch.no_grad():
            recs.append((np.sort(out[1].numpy(), 1),
                         (x2d.float() @ w.float()).numpy()))
        return out

    TMOE.route = recording_route
    _, tcfg = _cfgs(ROW_RUN)
    step_fn = tsteps.make_train_step(tcfg, _run_cfg(ROW_RUN, False), topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", ROW_SEQ, 1, "train"))
    res = []
    for row in rows:
        recs.clear()
        ts = interop.from_reference(*host, groups=TTF.build_groups(tcfg, TP),
                                    rank=0, dp=1, tp_rank=topo.tp_rank)
        m = step_fn(ts, 0, {"tokens": torch.from_numpy(row[None]).long()})
        res.append((float(m["loss"]), _forward_routes(recs)))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def row_results(tmp_path_factory):
    """Step 0 of ROW_RUN at seq 16 on each row of the first batch alone
    (a microbatch is one row): per row the reference's loss and, per tp
    rank, its forward routing calls (sorted expert choices, router
    logits), and the port's from one 2-rank spawn."""
    jcfg, _ = _cfgs(ROW_RUN)
    rows = _batches(ROW_RUN, jcfg.vocab, ROW_SEQ)[0]
    mesh = make_local_mesh(dp=1, tp=TP)
    rcfg, shape = _run_cfg(ROW_RUN, True), JShape("t", ROW_SEQ, 1, "train")
    init_fn, _ = jsteps.make_init(jcfg, rcfg, mesh, shape)
    host = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0)))
    d = tmp_path_factory.mktemp("tp_rows")
    ctx = tmp.start_processes(_row_worker, args=(TP, str(d / "rdv"), str(d),
                                                 host, rows),
                              nprocs=TP, join=False, start_method="spawn")
    recs = []

    def recording_route(x2d, w, *a):
        out = route(x2d, w, *a)
        jax.debug.callback(
            lambda r, ti, lg: recs.append((int(r), np.sort(ti, 1),
                                           np.asarray(lg))),
            jax.lax.axis_index("model"), out[1],
            x2d.astype(jnp.float32) @ w.astype(jnp.float32))
        return out

    route, JMOE.route = JMOE.route, recording_route
    try:
        bundle = jsteps.make_train_step(jcfg, rcfg, mesh, shape)
        ref = []
        for row in rows:
            recs.clear()
            chunks, states, opt = init_fn(jax.random.PRNGKey(0))
            *_, m = bundle.fn(chunks, states, opt, jnp.int32(0),
                              {"tokens": jnp.asarray(row[None])})
            jax.effects_barrier()
            ref.append((float(m["loss"]), [_forward_routes(
                [(ti, lg) for r, ti, lg in recs if r == k])
                for k in range(TP)]))
    finally:
        JMOE.route = route
    while not ctx.join():
        pass
    port = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(TP)]
    return ref, port


def test_moe_seq16_gap_is_a_routing_near_tie(row_results):
    """Why the MoE runs train at seq 32.  At seq 16 (8 tokens a rank) one
    row's step-0 loss leaves the step-0 limit around the reference's, and
    the cause is a discrete routing decision, not a fault on either side:
    every token that the two packages route differently has a group (or
    expert) score within ROUTE_TIE of the next one, where the packages'
    1-ulp bf16 differences in the layer's input decide, and the choice
    moves both of its experts.  Every row with no such token agrees within
    the step-0 limit."""
    ref, port = row_results
    _, tcfg = _cfgs(ROW_RUN)
    flipped = []
    for i, (want, ref_routes) in enumerate(ref):
        got = port[0][i][0]
        assert all(p[i][0] == got for p in port), "ranks disagree"
        ties = []
        for k in range(TP):
            for ti, lg in port[k][i][1]:
                jti, jlg = min(ref_routes[k],
                               key=lambda r: np.abs(r[1] - lg).max())
                for t in np.nonzero((ti != jti).any(1))[0]:
                    ties.append((k, int(t), float(_route_margin(lg, tcfg)[t]),
                                 float(_route_margin(jlg, tcfg)[t])))
        gap = abs(got - want)
        print(f"row {i}: port {got} reference {want} gap {gap} "
              f"(rank, token, margin port, margin reference) {ties}")
        assert all(max(m0, m1) < ROUTE_TIE for *_, m0, m1 in ties), ties
        if ties:
            flipped.append(gap)
        else:
            assert gap <= STEP0_RTOL * abs(want), (i, gap)
    # the observation this pins: at this size a near tie flips, and its row
    # leaves the limit
    assert flipped and max(flipped) > STEP0_RTOL * abs(ref[0][0]), flipped
