"""Expert-parallel MoE training with LoCo (PyTorch port): the qwen3-style
layer runs with its experts sharded over the model group and all-to-all
token dispatch, while LoCo compresses the data-parallel gradient traffic
(the expert gradients included); ``examples/moe_expert_parallel.py`` in
torch.

  PYTHONPATH=src python examples/moe_expert_parallel_torch.py --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      examples/moe_expert_parallel_torch.py

On the CPU it spawns 4 gloo ranks (dp 2 x tp 2: 2 experts per model
rank); on cards it runs one process per card under ``torchrun``, or alone
on card 0 (every expert on the one rank).
"""
import argparse
import os

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
    cfg = reduced(get_arch("qwen3-moe-30b-a3b"))
    assert cfg.moe_impl == "ep_a2a" and cfg.n_experts == 4
    shape = ShapeConfig("moe", seq_len=64, global_batch=8, kind="train")
    run = RunConfig(sync=SyncConfig(strategy="loco",
                                    quant=QuantConfig(mode="block")),
                    optimizer="adamw", lr=1e-3, microbatch=2,
                    total_steps=40, warmup_steps=4)
    with mesh.dp_group(device):
        tp = 2 if dist.get_world_size() % 2 == 0 else 1
        data, model = mesh.mesh_groups(tp)
        topo = MeshTopo.from_group(data, model=model)
        state = make_init(cfg, run, topo, device, seed=0, shape=shape)
        step_fn = make_train_step(cfg, run, topo, device, shape)
        bf = make_batch_fn(DataConfig(cfg.vocab, shape.seq_len,
                                      shape.global_batch))
        for step in range(args.steps):
            m = step_fn(state, step, bf(step))
            if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
                print(f"step {step:3d} loss {float(m['loss']):.4f} "
                      f"(router aux folded into total)", flush=True)
    if rank == 0:
        print(f"expert-parallel dispatch (all_to_all over the model group "
              f"of {topo.tp}) + LoCo dp sync OK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    if args.device == "cpu" and "WORLD_SIZE" not in os.environ:
        mesh.spawn_ranks(train, 4, args)             # dp 2 x tp 2, gloo
    else:
        train(int(os.environ.get("RANK", 0)), args)


if __name__ == "__main__":
    main()
