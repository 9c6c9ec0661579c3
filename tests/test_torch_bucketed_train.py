"""The port's bucketed sync against the JAX reference, and in training (CPU).

Sync level, dp = 2: the port's ``dist_sync_runs`` on two spawned gloo ranks
against the reference's under ``shard_map``, on the same gradients and
run-space states over two rounds.  The port takes the gradient as bf16 (as
its backward does); the reference takes the same values as f32 and upcasts
them, so any difference would be the port's.  Shards are bit-exact, f8
states within one f8 quantum on fewer than 5e-3 of the elements (ROADMAP's
codec standard).  One case also holds the reference's overlapped
(pipelined) schedule, which the port does not have, to the same bits.
A ``+every2`` plan follows DESIGN.md section 16 directly: off cadence the
shard is zero and the state accumulates the gradient; on cadence the sync
flushes, equal to an ``every=1`` sync from the accumulated state.

Slice level: reduced llama2-400m, 3 steps at dp = 2: bucketed under a
uniform policy gives the monolithic run's losses bit for bit inside the
port (coalesced and per-bucket alike); the mixed policy
``--bucket-mb 0.1 --policy "embed=loco8,min=16384"`` (a bucket is 12,800
elements per rank, every tensor keeps one fp tail) tracks the reference's
per-step loss within ROADMAP's limits (2e-3 relative at step 0, 2e-2
absolute later).
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

from repro.configs.base import ShapeConfig as JShape
from repro.core import comm as jcomm
from repro.core import flatparam as JFP
from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import comm as tcomm
from repro_torch.core import flatparam as TFP
from repro_torch.core import policy as TPOL
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TTF
from test_torch_codec import _np, assert_f8_close
from test_torch_train import (BATCH, JCFG, LATER_ATOL, MICRO, SEQ,
                              STEP0_RTOL, STEPS, TCFG, _batches)
from test_torch_wirepack import (EF, FP, LOCO4, LOCO8, NAIVE4, NAIVEF,
                                 NAIVET, _cfg, _grads, _init_states,
                                 make_plan)

N = 2
SYNC_CASES = {
    "uniform": (LOCO4,) * 4,
    "mix": (LOCO4, LOCO4, LOCO8, NAIVET, EF, EF, NAIVEF, FP, FP, NAIVE4,
            LOCO4),
    "loco8-fp": (LOCO8, LOCO8, FP),
}
EVERY2 = (_cfg(every=2), _cfg(every=2), _cfg(bits=8, every=2), FP)
EVERY1 = (LOCO4, LOCO4, LOCO8, FP)
MIX_BUCKET, MIX_POLICY = int(0.1 * (1 << 20)), "embed=loco8,min=16384"


def _bf16_grads(name, n):
    """Gradients with bf16 values, as f32 numpy (what both sides get)."""
    g = torch.from_numpy(_grads(2, n, len(name)))
    return g.to(torch.bfloat16).float().numpy()


def _run_cfgs(kind):
    common = dict(optimizer="adam", microbatch=MICRO, total_steps=STEPS,
                  warmup_steps=2, lr=2e-3)
    jrun = jsteps.RunConfig(sync=JSync(), **common)
    trun = tsteps.RunConfig(sync=SyncConfig(), **common)
    if kind == "uniform":
        return (dataclasses.replace(jrun, bucket_bytes=64 << 10),
                dataclasses.replace(trun, bucket_bytes=64 << 10))
    if kind == "mix":
        return (dataclasses.replace(
                    jrun, bucket_bytes=MIX_BUCKET,
                    policy=JPOL.parse_policy(MIX_POLICY, jrun.sync)),
                dataclasses.replace(
                    trun, bucket_bytes=MIX_BUCKET,
                    policy=TPOL.parse_policy(MIX_POLICY, trun.sync)))
    return jrun, trun


# ---------------------------------------------------------------------------
# the port's side, on two spawned ranks
# ---------------------------------------------------------------------------

def _port_losses(ts, run, topo):
    step_fn = tsteps.make_train_step(TCFG, run, topo, torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    return [float(step_fn(ts, i, {"tokens": torch.from_numpy(t).long()})
                  ["loss"]) for i, t in enumerate(_batches())]


def _sync_rounds(plan, grads, rank, group, step=None, states=None):
    st = _init_states(plan, True) if states is None else states
    out = []
    for r, g in enumerate(grads):
        sh, st = tcomm.dist_sync_runs(
            torch.from_numpy(g[rank]).to(torch.bfloat16),
            tuple(s.clone() for s in st), plan, group,
            step=None if step is None else step + r, inplace=True)
        out.append((tcomm.all_gather_flat(sh, group),
                    tuple(s.clone() for s in st)))
    return out


def _worker(rank, rdv, out_dir, mix_host):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    group = dist.group.WORLD
    topo = MeshTopo.from_group(group)
    res = {"sync": {}}
    for name, cfgs in SYNC_CASES.items():
        plan = make_plan(cfgs, 1)
        res["sync"][name] = _sync_rounds(
            plan, _bf16_grads(name, N * plan.chunklen), rank, group)
    # cadence: steps 0 (off) and 1 (on) of every=2, and the every=1 oracle
    p2, p1 = make_plan(EVERY2, 1), make_plan(EVERY1, 1)
    g = _bf16_grads("every2", N * p2.chunklen)
    cad = _sync_rounds(p2, g, rank, group, step=0)
    res["every2"] = cad
    res["every1_from_acc"] = _sync_rounds(p1, g[1:], rank, group,
                                          states=cad[0][1])
    # training
    for kind in ("mono", "uniform", "uniform-per-bucket"):
        run = _run_cfgs("uniform" if kind != "mono" else "mono")[1]
        if kind == "uniform-per-bucket":
            run = dataclasses.replace(run, coalesce=False)
        ts = tsteps.make_init(TCFG, run, topo, torch.device("cpu"), seed=0)
        res[kind] = _port_losses(ts, run, topo)
    groups = TTF.build_groups(TCFG, 1)
    res["mix"] = _port_losses(
        interop.from_reference(*mix_host, groups=groups, rank=rank, dp=N),
        _run_cfgs("mix")[1], topo)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _reference_mix():
    """(init state as numpy trees, per-step losses) of the reference's mixed
    bucketed run at dp = 2."""
    mesh = make_local_mesh(dp=N, tp=1)
    run = _run_cfgs("mix")[0]
    init_fn, _ = jsteps.make_init(JCFG, run, mesh)
    chunks, states, opt = init_fn(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, (chunks, states, opt))
    bundle = jsteps.make_train_step(JCFG, run, mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    losses = []
    for i, tok in enumerate(_batches()):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
    return host, losses


@pytest.fixture(scope="module")
def reference_mix():
    return _reference_mix()


@pytest.fixture(scope="module")
def port(reference_mix, tmp_path_factory):
    d = tmp_path_factory.mktemp("bucketed")
    tmp.start_processes(_worker,
                        args=(str(d / "rdv"), str(d), reference_mix[0]),
                        nprocs=N, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(N)]


def _reference_sync(mesh, plan, grads, overlap):
    units = JFP.state_units(plan, True)

    def body(g, sts):
        flat = tuple(s.reshape(-1) for s in sts)
        sh, ns = jcomm.dist_sync_runs(g.reshape(-1), flat, plan, ("data",),
                                      overlap=overlap)
        return (jcomm.all_gather_flat(sh, ("data",)),
                tuple(n[None] for n in ns))

    sspec = tuple(P("data") for _ in units)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"), sspec),
                               out_specs=(P(None), sspec), check_vma=False))
    st = tuple(jnp.stack([jnp.zeros((n,), dt)] * N) for n, dt in
               map(JFP.bucket_state_struct, units))
    out = []
    for g in grads:
        full, st = fn(jnp.asarray(g), st)
        out.append((np.asarray(full), st))
    return out


def _assert_state_close(got, want):
    if got.dtype == torch.float8_e4m3fn:
        assert_f8_close(got, want)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("name,overlap", [
    ("uniform", False), ("mix", False), ("loco8-fp", False),
    ("mix", True)])
def test_dist_sync_runs_matches_reference(port, mesh22, name, overlap):
    plan = make_plan(SYNC_CASES[name], 0)
    want = _reference_sync(mesh22, plan, _bf16_grads(
        name, N * plan.chunklen), overlap)
    for r, (full, jst) in enumerate(want):
        for rank in range(N):
            got_full, got_st = port[rank]["sync"][name][r]
            np.testing.assert_array_equal(got_full.numpy(), full,
                                          err_msg=f"round {r} rank {rank}")
            assert len(got_st) == len(jst)
            for s, js in zip(got_st, jst):
                _assert_state_close(s, np.asarray(js)[rank])


def test_every2_zero_off_cadence_then_flush(port):
    """DESIGN.md section 16 at dp = 2: step 0 is off cadence, step 1 on."""
    plan = make_plan(EVERY2, 1)
    g = _bf16_grads("every2", N * plan.chunklen)
    C = plan.chunklen
    for rank in range(N):
        (full0, st0), (full1, st1) = port[rank]["every2"]
        fp_cols = slice(3 * 512, 4 * 512)
        full0 = full0.reshape(N, C)
        # off cadence: the codec runs give zero shards, the fp run syncs
        assert not full0[:, :3 * 512].any()
        x = torch.from_numpy(g[0]).to(torch.bfloat16).reshape(N, N, C)
        fp_mean = (x[0] + x[1]).float()[:, fp_cols] / N   # bf16 wire sum
        assert torch.equal(full0[:, fp_cols], fp_mean)
        # ... and each state holds e + g (from e = 0: the gradient itself,
        # f8-encoded)
        for ri, s in enumerate(st0[:2]):
            seg = torch.from_numpy(g[0, rank]).reshape(N, C)[
                :, [slice(0, 1024), slice(1024, 1536)][ri]].reshape(-1)
            want = torch.clamp(seg * 2.0**14, -448, 448).to(
                torch.float8_e4m3fn)
            assert torch.equal(s.view(torch.uint8), want.view(torch.uint8))
        # on cadence: the flush equals an every=1 sync from that state
        oracle_full, oracle_st = port[rank]["every1_from_acc"][0]
        assert torch.equal(full1, oracle_full)
        assert full1[:3 * 512].any()
        for s, o in zip(st1, oracle_st):
            assert torch.equal(TFP.WP.to_bytes(s), TFP.WP.to_bytes(o))


def test_uniform_bucketed_train_equals_monolithic(port):
    for rank in range(N):
        mono = port[rank]["mono"]
        assert port[rank]["uniform"] == mono, port[rank]["uniform"]
        assert port[rank]["uniform-per-bucket"] == mono
        assert all(np.isfinite(mono)) and mono[-1] < mono[0]


def test_mixed_policy_train_matches_reference(port, reference_mix):
    ref = reference_mix[1]
    got = port[0]["mix"]
    gaps = [abs(a - b) for a, b in zip(got, ref)]
    print(f"port {got} reference {ref} gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(ref[0]), gaps
    assert max(gaps[1:]) <= LATER_ATOL, gaps
    assert port[1]["mix"] == got          # dp-mean loss
    assert got != port[0]["mono"]         # the policy changed the wire
