"""Training under the hierarchical and top-k syncs against the JAX
reference (CPU, reduced llama2-400m).

The harness of ``tests/test_torch_optim_train.py``: the reference's
``make_init`` state is carried into the port, the reference trains under
``shard_map`` while four spawned gloo ranks train the port, 4 steps at
``--warmup 0 --lr 1e-3`` on the CLI's synthetic batches, and each case
holds the port's losses to the reference's within the loss limits of
``tests/test_torch_train.py`` (2e-3 relative at step 0, 2e-2 absolute
after).  Cases: ``--pods 2 --hierarchical`` at dp 4 (pods 2 x data 2) on
the monolithic sync and on a bucketed plan with ``+hier`` buckets, and
``--sync topk`` at dp 2 (ranks 0 and 1 of the same spawn, on a group of
their own).  Every rank of a run reports the same (dp-mean) loss.  The CLI
maps ``--pods``, ``--wans``, ``--hierarchical`` and ``--sync topk`` as the
reference's does.
"""
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import make_local_mesh
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import policy as TPOL
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TTF
from test_torch_optim_train import (LR, STEPS, _batches, _within,
                                    _gaps)
from test_torch_train import BATCH, JCFG, MICRO, SEQ, TCFG

WORLD = 4
# case -> (dp, pods, sync fields, policy, bucket bytes)
CASES = {
    "hier": (4, 2, dict(hierarchical=True), "", 0),
    "hier-bucketed": (4, 2, {}, "embed=loco8+hier,body=loco+hier", 1 << 16),
    "topk": (2, 0, dict(strategy="topk"), "", 0),
}


def _cfgs(case):
    _, _, sync, policy, nbytes = CASES[case]
    common = dict(microbatch=MICRO, total_steps=STEPS, warmup_steps=0,
                  lr=LR, bucket_bytes=nbytes)
    js, ts = JSync(**sync), SyncConfig(**sync)
    return (jsteps.RunConfig(sync=js, policy=JPOL.parse_policy(policy, js)
                             if policy else None, **common),
            tsteps.RunConfig(sync=ts, policy=TPOL.parse_policy(policy, ts)
                             if policy else None, **common))


def _mesh(case):
    dp, pods = CASES[case][:2]
    return (make_local_mesh(dp=dp // pods, tp=1, pods=pods) if pods
            else make_local_mesh(dp=dp, tp=1))


def _reference_losses(case, mesh, state):
    from repro.configs.base import ShapeConfig as JShape
    import jax.numpy as jnp

    chunks, states, opt = state
    bundle = jsteps.make_train_step(JCFG, _cfgs(case)[0], mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    losses = []
    for i, tok in enumerate(_batches()):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
    return losses


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, WORLD, rdv)
    world = dist.group.WORLD
    pair = dist.new_group([0, 1])
    res = {}
    for case, host in hosts.items():
        dp, pods = CASES[case][:2]
        if dp == WORLD:
            topo = MeshTopo.from_group(world, axes=tmesh.mesh_axes(
                world, 1, pods=pods))
        elif rank < dp:
            topo = MeshTopo.from_group(pair)
        else:
            continue
        ts = interop.from_reference(*host, groups=TTF.build_groups(TCFG, 1),
                                    rank=topo.rank, dp=topo.dp)
        step_fn = tsteps.make_train_step(
            TCFG, _cfgs(case)[1], topo, torch.device("cpu"),
            ShapeConfig("t", SEQ, BATCH, "train"))
        res[case] = [float(step_fn(ts, i, {"tokens": torch.from_numpy(t)
                                           .long()})["loss"])
                     for i, t in enumerate(_batches())]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hier_train")
    inits = {}
    for c in CASES:
        mesh = _mesh(c)
        init_fn, _ = jsteps.make_init(JCFG, _cfgs(c)[0], mesh)
        inits[c] = (mesh, init_fn(jax.random.PRNGKey(0)))
    hosts = {c: jax.tree.map(np.asarray, st) for c, (_, st) in inits.items()}
    ctx = tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                              nprocs=WORLD, join=False, start_method="spawn")
    ref = {c: _reference_losses(c, *inits[c]) for c in CASES}
    while not ctx.join():
        pass
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]
    return ranks, ref


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_reference(runs, case):
    ranks, ref = runs
    dp = CASES[case][0]
    port = ranks[0][case]
    print(f"{case}: port {port} reference {ref[case]} "
          f"gaps {_gaps(port, ref[case])}")
    assert all(ranks[r][case] == port for r in range(dp))
    assert all(np.isfinite(port))
    assert _within(port, ref[case]), _gaps(port, ref[case])


def test_cli_maps_pods_and_topk_as_the_reference():
    argv = ["--arch", "llama2-400m", "--pods", "2", "--wans", "2",
            "--hierarchical", "--sync", "topk", "--policy",
            "body=loco+hier+wan:topk1%every4"]
    ta, ja = ttrain.build_args(argv), jtrain.build_args(argv)
    assert (ta.pods, ta.wans, ta.hierarchical, ta.sync) == (
        ja.pods, ja.wans, ja.hierarchical, ja.sync) == (2, 2, True, "topk")
    trun, jrun = ttrain.make_run(ta), jtrain.make_run(ja)
    assert trun.sync.hierarchical and jrun.sync.hierarchical
    assert trun.policy.rules[0].sync.tiers[1].every == \
        jrun.policy.rules[0].sync.tiers[1].every == 4
    for k in ("pods", "wans", "hierarchical"):
        assert getattr(ttrain.build_args(["--arch", "x"]), k) == \
            getattr(jtrain.build_args(["--arch", "x"]), k)
