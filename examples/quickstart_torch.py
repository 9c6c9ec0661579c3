"""Quickstart (PyTorch port): train a tiny LM with LoCo 4-bit gradient sync
on a 2 x 2 (data x model) mesh; ``examples/quickstart.py`` in torch.

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py     # one card: 1 x 1

On the CPU it spawns 4 gloo ranks (dp 2 x tp 2, the reference's mesh); on
cards it runs one process per card under ``torchrun`` (world = dp x tp,
tp 2 when the world is even), or alone on card 0.
"""
import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.core.quantizer import QuantConfig
from repro_torch.data.synthetic import DataConfig, make_batch_fn
from repro_torch.launch import mesh
from repro_torch.launch.steps import RunConfig, make_init, make_train_step
from repro_torch.launch.train import resolve_device


def train(rank: int, args) -> None:
    device = resolve_device(args.device)
    cfg = reduced(get_arch("llama2-400m"))           # 2L, d=256 smoke variant
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=8, kind="train")
    run = RunConfig(
        sync=SyncConfig(                             # <- the paper's technique
            strategy="loco",                         # 4-bit error-feedback sync
            quant=QuantConfig(mode="block"),         # per-256-block scales
            beta=0.5,                                # error moving average (Eqn. 5)
            reset_every=512,                         # T_c (Eqn. 7)
        ),
        optimizer="adam", lr=2e-3, microbatch=2, total_steps=50, warmup_steps=5,
    )
    with mesh.dp_group(device):
        world = dist.get_world_size()
        tp = 2 if world % 2 == 0 else 1              # FSDP over dp, TP over 2
        data, model = mesh.mesh_groups(tp)
        topo = MeshTopo.from_group(data, model=model)
        state = make_init(cfg, run, topo, device, seed=0, shape=shape)
        step_fn = make_train_step(cfg, run, topo, device, shape)
        batch_fn = make_batch_fn(DataConfig(cfg.vocab, shape.seq_len,
                                            shape.global_batch))
        if rank == 0:
            print(f"mesh: dp {topo.dp} x tp {topo.tp} on {device.type}",
                  flush=True)
        for step in range(args.steps):
            m = step_fn(state, step, batch_fn(step))
            last = step == args.steps - 1
            if rank == 0 and (step % args.log_every == 0 or last):
                print(f"step {step:3d}  loss {float(m['loss']):.4f}  "
                      f"gnorm {float(m['gnorm']):.2f}", flush=True)
    if rank == 0:
        print("done -- gradients were synchronized as 4-bit all-to-all "
              "payloads with an f8 compensation-error state the whole time.")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args()
    if args.device == "cpu" and "WORLD_SIZE" not in os.environ:
        mesh.spawn_ranks(train, 4, args)             # dp 2 x tp 2, gloo
    else:
        train(int(os.environ.get("RANK", 0)), args)


if __name__ == "__main__":
    main()
