"""The paper's quality claim on the port, scaled down: the ports of
``tests/test_train_integration.py::test_loss_decreases``,
``::test_loco_matches_fp_quality`` and ``::test_multipod_mesh_trains``,
with the reference's thresholds.

Reduced llama2-400m, seq 32, global batch 8, microbatch 2, Adam at lr
2e-3 with 2 warmup steps (cosine over the run), the port's own zipf
stream (``data.synthetic.make_batch_fn``, seed 0) and init (seed 0):

* ``fp`` for 12 steps falls by more than 0.3;
* ``loco`` (4-bit block mode, f8 error) ends within 0.15 of ``fp``'s
  final loss after 12 steps, and ``naive4`` at the fixed scale 2^9 more
  than twice as far;
* ``loco`` on a ``(pod, data)`` mesh of 2 x 2 ranks (tp 1) trains 6
  steps, finite and falling.

The first two run at dp 2 x tp 2 (the reference's ``mesh22``), the pod
case at pods 2 x dp 2 x tp 1 (the reference's ``mesh_pod`` is pods 2 x
dp 2 x tp 2, eight ranks): all on one spawned 4-rank gloo group.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.core.quantizer import QuantConfig
from repro_torch.data.synthetic import DataConfig, make_batch_fn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

CFG = reduced(get_arch("llama2-400m"))
SHAPE = ShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")
WORLD = 4
# name -> (sync, steps, mesh: "tp2" = dp 2 x tp 2, "pods" = (pod 2, data 2))
RUNS = {
    "fp": (SyncConfig(strategy="fp"), 12, "tp2"),
    "loco": (SyncConfig(strategy="loco", quant=QuantConfig(mode="block")),
             12, "tp2"),
    "naive4": (SyncConfig(strategy="naive4",
                          quant=QuantConfig(mode="fixed", scale=2.0**9)),
               12, "tp2"),
    "loco pods": (SyncConfig(strategy="loco",
                             quant=QuantConfig(mode="block")), 6, "pods"),
}


def _train(topo, sync, steps):
    run = tsteps.RunConfig(sync=sync, optimizer="adam", microbatch=2,
                           total_steps=steps, warmup_steps=2, lr=2e-3)
    dev = torch.device("cpu")
    ts = tsteps.make_init(CFG, run, topo, dev, seed=0)
    step_fn = tsteps.make_train_step(CFG, run, topo, dev, SHAPE)
    bf = make_batch_fn(DataConfig(vocab=CFG.vocab, seq_len=SHAPE.seq_len,
                                  global_batch=SHAPE.global_batch, seed=0))
    return [float(step_fn(ts, i, bf(i))["loss"]) for i in range(steps)]


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, WORLD, rdv)
    # every rank creates every group, in the same order
    tp2 = MeshTopo.from_group(*tmesh.mesh_groups(2))
    world = dist.group.WORLD
    pods = MeshTopo.from_group(world, axes=tmesh.mesh_axes(world, 1,
                                                           pods=2))
    topos = {"tp2": tp2, "pods": pods}
    res = {name: _train(topos[mesh], sync, steps)
           for name, (sync, steps, mesh) in RUNS.items()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def losses(tmp_path_factory):
    """name -> the losses every rank reported (asserted equal)."""
    d = tmp_path_factory.mktemp("quality")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)),
                        nprocs=WORLD, start_method="spawn")
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]
    for name in RUNS:
        assert all(r[name] == ranks[0][name] for r in ranks), name
    print({k: v[-1] for k, v in ranks[0].items()})
    return {k: np.array(v) for k, v in ranks[0].items()}


def test_loss_decreases(losses):
    l_fp = losses["fp"]
    assert np.isfinite(l_fp).all()
    assert l_fp[-1] < l_fp[0] - 0.3, l_fp


def test_loco_matches_fp_quality(losses):
    """Paper Tables 3/5 at micro scale: LoCo's final loss tracks full
    precision; naive 4-bit at a bad fixed scale does not."""
    l_fp, l_loco, l_naive = losses["fp"], losses["loco"], losses["naive4"]
    gap_loco = abs(l_loco[-1] - l_fp[-1])
    assert gap_loco < 0.15, (l_fp[-1], l_loco[-1])
    gap_naive = abs(l_naive[-1] - l_fp[-1])
    assert gap_naive > 2 * gap_loco, (l_fp[-1], l_loco[-1], l_naive[-1])


def test_multipod_mesh_trains(losses):
    """The (pod, data) dp group trains and syncs."""
    l = losses["loco pods"]
    assert np.isfinite(l).all()
    assert l[-1] < l[0], l
