"""Serve a small model with batched requests (PyTorch port): prefill a
batch of prompts, then decode greedily in lockstep, through
``python -m repro_torch.launch.serve``; ``examples/serve_batched.py`` in
torch.

  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu \\
      --arch mamba2-2.7b
  PYTHONPATH=src torchrun --nproc-per-node 4 examples/serve_batched_torch.py

The KV caches hold the whole generation (``steps.serve_window``: the
prompt and every decoded token), not the prompt alone as the reference's
do.  On the CPU it spawns 4 gloo ranks (dp 2 x tp 2, the reference's
mesh); on cards it runs one process per card under ``torchrun``, or alone
on card 0.  Rank 0 prints the serve CLI's lines.
"""
import argparse
import contextlib
import io
import os

import torch.distributed as dist

from repro_torch.launch import mesh, serve


def serve_rank(rank: int, args) -> None:
    tp = 2 if args.device == "cpu" or dist.get_world_size() % 2 == 0 else 1
    argv = ["--arch", args.arch, "--reduced", "--batch", str(args.batch),
            "--prompt-len", str(args.prompt_len),
            "--decode-steps", str(args.decode_steps),
            "--tp", str(tp), "--device", args.device]
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank \
        else contextlib.nullcontext()
    with quiet:
        serve.main(argv)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cpu" and "WORLD_SIZE" not in os.environ:
        mesh.spawn_ranks(serve_rank, 4, args)        # dp 2 x tp 2, gloo
        return
    rank = int(os.environ.get("RANK", 0))
    with mesh.dp_group(serve.resolve_device(args.device)):
        serve_rank(rank, args)


if __name__ == "__main__":
    main()
