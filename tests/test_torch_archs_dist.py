"""The new configs on a spawned 2-rank gloo group against the JAX reference
under ``shard_map`` (CPU, ``--sync loco``, Adam, 3 steps):

* reduced gemma2-27b at dp 2 (seq 128, so its 64-token local window
  cuts; global batch 8, microbatch 2): the tied embedding, scaled on the
  way in and read again as the head, LoCo-synced once per microbatch;
* reduced gemma2-27b at dp 1 x tp 2 (same shape): the tied head as the
  column-parallel ``emb.T`` of the vocab shard, the final soft cap over
  vocab-parallel logits, local/global attention under sequence
  parallelism;
* reduced qwen3-moe-30b-a3b at dp 1 x tp 2 on the block8 wire (seq 32,
  global batch 4, microbatch 1, against the reference's default run with
  sequence parallelism on: tests/test_torch_tp_train.py says why MoE runs
  at tp 2 take microbatch 1): qk-norm under ``ep_a2a`` and sequence
  parallelism.

The ranks train while the reference runs in the main process.  Bounds as
in tests/test_torch_archs_train.py; every rank reports the same loss.
Also, in process at dp 1: gemma2 on the bucketed sync's overlapped stage
schedule.
"""
import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.core.flatparam import MeshTopo
from repro_torch.kernels import loco_quant as LQ
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as TTF
from test_torch_archs_train import (assert_close, cfgs, init_host, port,
                                    reference, topo1)  # noqa: F401

# name -> (arch, dp, tp, global batch, microbatch)
RUNS = {"gemma2 dp2": ("gemma2-27b", 2, 1, 8, 2),
        "gemma2 tp2": ("gemma2-27b", 1, 2, 8, 2),
        "qwen3 tp2": ("qwen3-moe-30b-a3b", 1, 2, 4, 1)}


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, 2, rdv)
    calls = [0]
    compress = LQ.fused_compress

    def counting(*a, **kw):
        calls[0] += 1
        return compress(*a, **kw)

    LQ.fused_compress = counting
    res = {}
    for name, (arch, dp, tp, batch, micro) in RUNS.items():
        topo = (MeshTopo.from_group(dist.group.WORLD,
                                    model=tmesh.model_group())
                if tp == 1 else MeshTopo.from_group(*tmesh.mesh_groups(tp)))
        calls[0] = 0
        metrics = port(cfgs(arch)[1], hosts[name], topo, batch, micro)
        res[name] = (metrics, calls[0])
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference metrics, per-rank (metrics, fused_compress calls)) per
    run, from one 2-rank spawn that trains while the reference runs."""
    d = tmp_path_factory.mktemp("archs_dist")
    hosts = {name: init_host(cfgs(arch)[0], dp, tp, batch, micro)
             for name, (arch, dp, tp, batch, micro) in RUNS.items()}
    ctx = tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                              nprocs=2, join=False, start_method="spawn")
    ref = {name: reference(cfgs(arch)[0], dp, tp, batch, micro)[1]
           for name, (arch, dp, tp, batch, micro) in RUNS.items()}
    while not ctx.join():
        pass
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return ref, ranks


@pytest.mark.parametrize("name", list(RUNS))
def test_two_ranks_train_like_reference(results, name):
    ref, ranks = results
    got = [r[name][0] for r in ranks]
    assert_close(got[0], ref[name])
    assert got[1] == got[0], "ranks disagree"


def test_tied_embedding_syncs_once_per_microbatch(results):
    """At dp 2 each rank calls fused_compress once per LoCo tensor and
    microbatch: the tied embedding (used by the embedding and the head)
    syncs once, as the reference's one gather does."""
    _, ranks = results
    arch, dp, tp, batch, micro = RUNS["gemma2 dp2"]
    tcfg = cfgs(arch)[1]
    groups = TTF.build_groups(tcfg, tp)
    assert not any(i.name == "head" for g in groups for i in g.infos)
    loco = sum((g.n_layers or 1) for g in groups for i in g.infos if i.loco)
    backwards = 3 * batch // (dp * micro)
    assert [r["gemma2 dp2"][1] for r in ranks] == [loco * backwards] * 2


def test_gemma2_bucketed_overlapped_trains_like_reference(topo1):
    """gemma2's local/global alternation, tied embedding and soft caps
    under the bucketed sync on the overlapped stage schedule (remat on):
    the embedding at loco8, the norms and small tails fp (dp 1)."""
    jcfg, tcfg = cfgs("gemma2-27b")
    host, ref = reference(jcfg, bucketed=True)
    assert_close(port(tcfg, host, topo1, bucketed=True), ref)
