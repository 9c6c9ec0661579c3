"""Reduced mamba2-2.7b, zamba2-2.7b and whisper-small at dp 2 x tp 2 (the
reference's ``mesh22``) on one spawned 4-rank gloo group, against the JAX
reference under ``shard_map`` (CPU, ``--sync loco``, Adam, 3 steps, seq
32, global batch 8, microbatch 2).

This covers what tp 1 cannot: the ssm heads (``w_x``, ``w_z``, ``w_dt``,
``conv_x``, ``normg``, ``w_out``) sharded over ``model``; the replicated
``w_B``, ``w_C``, ``conv_B`` and ``conv_C``, whose gradients are summed
over the model group before their sync (``replicated_grad_psum``); the
mixer's ``row_linear`` under sequence parallelism (16 of 32 positions per
rank); the shared block of zamba2 gathered once per microbatch, so each
of its LoCo tensors syncs once per microbatch backward; whisper's
encoder, cross-attention and tied head over a vocabulary shard.  The
ranks train while the reference runs in the main process.  Bounds as in
tests/test_torch_families_train.py; every rank reports the same loss.
Each sync of a shared-block LoCo tensor in the first step, given the
cotangent summed over both applications, is the reference's
``dist_sync`` on the same cotangents: shards bit for bit, stored errors
within the f8 one-quantum rule (tests/test_torch_codec.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

from repro.core import comm as jcomm
from repro.core import loco as jloco
from repro.core.loco import SyncConfig as JSync
from repro.launch.mesh import make_local_mesh
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.flatparam import MeshTopo
from repro_torch.kernels import loco_quant as LQ
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from test_torch_codec import assert_f8_close
from test_torch_families_train import (ARCHS, BATCH, MICRO, SEQ,
                                       _tbatch, assert_close, batches, cfgs,
                                       init_host, port, reference, run_cfgs)

DP, TP = 2, 2


def _shared_syncs(tcfg, host, topo):
    """One step (two microbatches) of reduced zamba2 with every sync of a
    shared-group LoCo tensor recorded: per tensor name, in call order,
    (the cotangent it synced as f32, the synced shard as f32); and the
    stored errors after the step (f8 as u8)."""
    from repro_torch.core import hijack

    ts = interop.from_reference(
        *host, groups=tsteps.model_groups(tcfg, topo.tp), rank=topo.rank,
        dp=topo.dp, tp_rank=topo.tp_rank)
    names = {id(v): k for k, v in ts.states["shared"].items()
             if v.dtype == torch.float8_e4m3fn}
    calls = {k: [] for k in names.values()}
    sync = hijack.dist_sync

    def recording(g_full, state, *a, **kw):
        out = sync(g_full, state, *a, **kw)
        if id(state) in names:
            calls[names[id(state)]].append((g_full.float().clone(),
                                            out[0].float().clone()))
        return out

    hijack.dist_sync = recording
    try:
        step_fn = tsteps.make_train_step(
            tcfg, run_cfgs()[1], topo, torch.device("cpu"),
            ShapeConfig("t", SEQ, BATCH, "train"))
        step_fn(ts, 0, _tbatch(batches(tcfg, steps=1)[0]))
    finally:
        hijack.dist_sync = sync
    states = {k: ts.states["shared"][k].view(torch.uint8).clone()
              for k in calls}
    return calls, states


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, DP * TP, rdv)
    calls = [0]
    compress = LQ.fused_compress

    def counting(*a, **kw):
        calls[0] += 1
        return compress(*a, **kw)

    LQ.fused_compress = counting
    topo = MeshTopo.from_group(*tmesh.mesh_groups(TP))
    res = {"where": (topo.tp_rank, topo.rank)}
    for arch in ARCHS:
        calls[0] = 0
        losses, _ = port(cfgs(arch)[1], hosts[arch], topo)
        res[arch] = (losses, calls[0])
    res["shared"] = _shared_syncs(cfgs("zamba2-2.7b")[1],
                                  hosts["zamba2-2.7b"], topo)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference losses, per-rank results) per config, from one 4-rank
    spawn that trains while the reference runs."""
    d = tmp_path_factory.mktemp("families_dist")
    hosts = {arch: init_host(cfgs(arch)[0], DP, TP) for arch in ARCHS}
    ctx = tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                              nprocs=DP * TP, join=False,
                              start_method="spawn")
    ref = {arch: reference(cfgs(arch)[0], DP, TP)[1] for arch in ARCHS}
    while not ctx.join():
        pass
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(DP * TP)]
    return ref, ranks


@pytest.mark.parametrize("arch", ARCHS)
def test_dp2_tp2_trains_like_reference(results, arch):
    ref, ranks = results
    got = [r[arch][0] for r in ranks]
    assert_close(got[0], ref[arch])
    assert all(g == got[0] for g in got), "ranks disagree"


@pytest.mark.parametrize("arch", ARCHS)
def test_each_loco_tensor_syncs_once_per_microbatch(results, arch):
    """Every rank calls fused_compress once per LoCo tensor of its TP
    slice and microbatch: zamba2's shared block, applied twice per
    forward, and whisper's tied embedding, read by the embedding and the
    head, sync once each."""
    _, ranks = results
    groups = tsteps.model_groups(cfgs(arch)[1], TP)
    loco = sum((g.n_layers or 1) for g in groups for i in g.infos if i.loco)
    backwards = 3 * BATCH // (DP * MICRO)
    assert [r[arch][1] for r in ranks] == [loco * backwards] * (DP * TP)


def test_shared_block_sync_is_the_references(results):
    """zamba2's shared-block LoCo tensors sync once per microbatch, each
    time the cotangent summed over both applications: on every rank two
    syncs per tensor in the step, and the reference's ``dist_sync`` over
    the data axis, run from a zero state on the same two rounds of
    cotangents, gives the synced shards bit for bit and the stored errors
    within one f8 quantum on fewer than 5e-3 of the elements.  (Errors
    after a whole backward cannot be held to the reference so: the
    reduced mamba layers' bf16 gradients are 15-20% from their f32
    values in either package, so the two packages' cotangents differ.)"""
    _, ranks = results
    by_where = {r["where"]: r["shared"] for r in ranks}
    mesh = make_local_mesh(dp=DP, tp=1)
    cfg = JSync(strategy="loco")

    def body(g, st):
        shard, new = jcomm.dist_sync(g.reshape(-1), st.reshape(-1), cfg,
                                     ("data",))
        return jcomm.all_gather_flat(shard, ("data",)), new[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"),) * 2,
                               out_specs=(P(None), P("data")),
                               check_vma=False))
    names = sorted(by_where[(0, 0)][0])
    assert names == ["s_w1", "s_w2", "s_w3", "s_wk", "s_wo", "s_wq",
                     "s_wv"], names
    for m in range(TP):
        for name in names:
            recs = [by_where[(m, dr)][0][name] for dr in range(DP)]
            assert [len(r) for r in recs] == [BATCH // (DP * MICRO)] * DP
            n = recs[0][0][0].numel()
            st = jnp.stack([jloco.init_state(cfg, n) for _ in range(DP)])
            for k in range(len(recs[0])):
                g = jnp.asarray(np.stack([r[k][0].numpy() for r in recs])
                                ).astype(jnp.bfloat16)
                full, st = fn(g, st)
                # the port hands the optimizer the shard in the
                # cotangent's dtype, as the reference's gather does
                full = np.asarray(full.astype(jnp.bfloat16), np.float32)
                c = full.size // DP
                for dr in range(DP):
                    np.testing.assert_array_equal(
                        recs[dr][k][1].numpy(), full[dr * c:(dr + 1) * c])
            for dr in range(DP):
                got = by_where[(m, dr)][1][name].view(torch.float8_e4m3fn)
                assert_f8_close(got.float().numpy(),
                                np.asarray(st)[dr].astype(np.float32))
