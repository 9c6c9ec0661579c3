"""End-to-end driver (PyTorch port): train a ~100M-parameter llama on
synthetic data for a few hundred steps, LoCo against full precision, and
report the loss-parity check (paper Fig. 2 at laptop scale);
``examples/train_100m.py`` in torch.

  PYTHONPATH=src python examples/train_100m_torch.py --device cpu \\
      [--steps 300] [--fp-only | --loco-only]
  PYTHONPATH=src torchrun --nproc-per-node 4 examples/train_100m_torch.py

The 100M config: 12L x d512 (GQA 8/4) x ffn1536, vocab 8192 -> 104M
params.  On the CPU it spawns 4 gloo ranks (dp 2 x tp 2, the reference's
mesh); on cards it runs one process per card under ``torchrun``, or alone
on card 0.
"""
import argparse
import os
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.core.quantizer import QuantConfig
from repro_torch.data.synthetic import DataConfig, make_batch_fn
from repro_torch.launch import mesh
from repro_torch.launch.steps import RunConfig, make_init, make_train_step
from repro_torch.launch.train import resolve_device

CFG_100M = ArchConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=512, n_heads=8,
    n_kv_heads=4, d_ff=1536, vocab=8192, source="examples/train_100m")


def train(sync: SyncConfig, steps: int, device, rank: int,
          log_every: int = 20) -> list[float]:
    shape = ShapeConfig("e2e", seq_len=256, global_batch=8, kind="train")
    run = RunConfig(sync=sync, optimizer="adamw", lr=6e-4, microbatch=2,
                    total_steps=steps, warmup_steps=max(steps // 20, 5),
                    schedule="cosine")
    tp = 2 if dist.get_world_size() % 2 == 0 else 1
    data, model = mesh.mesh_groups(tp)
    topo = MeshTopo.from_group(data, model=model)
    state = make_init(CFG_100M, run, topo, device, seed=0, shape=shape)
    step_fn = make_train_step(CFG_100M, run, topo, device, shape)
    bf = make_batch_fn(DataConfig(CFG_100M.vocab, shape.seq_len,
                                  shape.global_batch))
    t0, losses = time.time(), []
    for step in range(steps):
        m = step_fn(state, step, bf(step))
        losses.append(float(m["loss"]))
        if rank == 0 and (step % log_every == 0 or step == steps - 1):
            tok_s = (step + 1) * shape.global_batch * shape.seq_len \
                / (time.time() - t0)
            print(f"[{sync.strategy}] step {step:4d} loss {losses[-1]:.4f} "
                  f"tok/s {tok_s:,.0f}", flush=True)
    return losses


def run_all(rank: int, args) -> None:
    device = resolve_device(args.device)
    results = {}
    with mesh.dp_group(device):
        if not args.loco_only:
            results["fp"] = train(SyncConfig(strategy="fp"), args.steps,
                                  device, rank)
        if not args.fp_only:
            results["loco"] = train(SyncConfig(
                strategy="loco", quant=QuantConfig(mode="block")),
                args.steps, device, rank)
    if rank == 0 and len(results) == 2:
        fp10 = float(np.mean(results["fp"][-10:]))
        lo10 = float(np.mean(results["loco"][-10:]))
        print(f"\nfinal-loss  fp={fp10:.4f}  loco={lo10:.4f}  "
              f"gap={lo10-fp10:+.4f}")
        print("paper claim at scale: gap ~ 0 (Tables 3/5, Fig. 2)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fp-only", action="store_true")
    ap.add_argument("--loco-only", action="store_true")
    args = ap.parse_args()
    if args.device == "cpu" and "WORLD_SIZE" not in os.environ:
        mesh.spawn_ranks(run_all, 4, args)           # dp 2 x tp 2, gloo
    else:
        run_all(int(os.environ.get("RANK", 0)), args)


if __name__ == "__main__":
    main()
