"""Training entry point (CLI).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-400m \\
      --sync loco --seq-len 1024 --global-batch 8 --microbatch 4 --steps 6

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-400m \\
      --reduced --steps 3 --seq-len 32 --global-batch 8 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-moe \\
      --sync loco --moe-a2a block8 --seq-len 1024 --global-batch 8 \\
      --microbatch 4 --steps 6

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-400m \\
      --sync loco --bucket-mb 4 --policy "embed=loco8,min=1048576" \\
      --seq-len 1024 --global-batch 8 --microbatch 4 --steps 3

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama2-400m --tp 2 --sync loco --seq-len 1024 --global-batch 8

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
raises rather than fall back.  Under ``torchrun`` the world of ``dp * tp``
ranks splits into ``--tp``-rank model groups (tensor, sequence and expert
parallelism) and ``dp``-rank data groups (global rank ``data * tp +
model``, ``launch.mesh.mesh_groups``); otherwise the run is one rank in a
world-size-1 group.  Prints the reference's ``step N loss=... gnorm=...
lr=... tok/s=...`` lines (MoE models add the router losses ``moe_aux`` and
``moe_z``); ``tok/s`` leaves out the first step, which pays the warm-up
(kernel build, allocator growth).  With ``--bucket-mb`` or ``--policy`` the
gradient sync runs bucketed (``core/buckets``, ``core/policy``, packed by
``core/wirepack`` unless ``--no-coalesce``), and the plan's wire report
(``telemetry/wire``) is printed first.  The coalesced sync runs the
reference's backward-overlapped stage schedule unless ``--no-overlap``
(the same losses bit for bit); ``--no-coalesce`` implies the flat one.
With ``--ckpt-dir`` the run first restores the newest valid checkpoint
there (``--resume-reshard`` migrates one written under another dp size or
plan) and saves every ``--ckpt-every`` steps, in the reference's format.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.core.policy import parse_policy
from repro_torch.data.synthetic import DataConfig, make_batch_fn
from repro_torch.launch import mesh
from repro_torch.launch.steps import (RunConfig, build_sync_plan, make_init,
                                      make_train_step, state_fingerprint)
from repro_torch.models.transformer import build_groups
from repro_torch.telemetry import wire as WIRE


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree; dp = world size / tp")
    ap.add_argument("--sync", default="loco",
                    choices=["fp", "loco", "ef", "naive4", "onebit"])
    ap.add_argument("--moe-a2a", default=None, choices=["fp", "block8"],
                    help="codec for the ep_a2a MoE dispatch/combine "
                         "all-to-all (core/act_comm): fp = raw bf16, "
                         "block8 = stateless int8 block-absmax fwd+bwd "
                         "(default: the config's own)")
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="bucketed sync: target MiB of fp32 gradient per "
                         "bucket (0 = monolithic path)")
    ap.add_argument("--policy", default="",
                    help="per-bucket wire policy, e.g. "
                         "'embed=loco8,norm=fp,min=65536' (see "
                         "repro_torch.core.policy.parse_policy); a policy "
                         "alone buckets at the default 4 MiB")
    ap.add_argument("--coalesce", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="pack the bucketed sync's wire by exchange kind and "
                         "launch one collective per comm group (the same "
                         "bits; --no-coalesce syncs each bucket on its own)")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="pipeline the coalesced bucketed sync: up to two "
                         "readiness-ordered stages whose asynchronous "
                         "collectives overlap the next stage's encode (the "
                         "same bits; --no-overlap keeps one sync region)")
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--reset-every", type=int, default=512)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "adamw"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="prune checkpoint history to the newest N "
                         "(0 = keep all)")
    ap.add_argument("--resume-reshard", action="store_true",
                    help="when resuming onto a different dp size / bucket "
                         "layout / policy, migrate the checkpointed state "
                         "(master chunks, optimizer moments, compensation "
                         "errors) through logical space instead of failing "
                         "on the layout mismatch")
    return ap.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to "
                           "train on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_run(args) -> RunConfig:
    sync = SyncConfig(strategy=args.sync, beta=args.beta,
                      reset_every=args.reset_every)
    policy = parse_policy(args.policy, sync) if args.policy else None
    return RunConfig(sync=sync, optimizer=args.optimizer, lr=args.lr,
                     warmup_steps=args.warmup, total_steps=args.steps,
                     microbatch=args.microbatch,
                     bucket_bytes=int(args.bucket_mb * (1 << 20)),
                     policy=policy, coalesce=args.coalesce,
                     overlap=args.overlap)


def make_cfg(args):
    """The architecture the arguments name (``--reduced``, ``--moe-a2a``)."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.moe_a2a:
        if cfg.moe_impl != "ep_a2a" or not cfg.n_experts:
            raise SystemExit(f"--moe-a2a: {cfg.name} has no ep_a2a MoE "
                             "dispatch to compress")
        cfg = dataclasses.replace(cfg, moe_a2a_codec=args.moe_a2a)
    return cfg


def main(argv=None) -> dict:
    """Train; returns ``{"losses": [...], "moe_aux": [...], "moe_z": [...],
    "tok_per_s": float | None, "peak_mem_bytes": int | None, "start":
    int}`` (losses of the steps this run took, from ``start``, the
    restored step or 0; router losses per step for MoE models, else empty;
    tok/s over the steps after the first; peak device memory on a
    card)."""
    args = build_args(argv)
    device = resolve_device(args.device)
    cfg = make_cfg(args)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    run = make_run(args)
    batch_fn = make_batch_fn(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                        global_batch=args.global_batch,
                                        seed=args.seed))
    cuda = device.type == "cuda"
    losses: list[float] = []
    router: dict[str, list[float]] = {"moe_aux": [], "moe_z": []}
    with mesh.dp_group(device):
        data, model = mesh.mesh_groups(args.tp)
        topo = MeshTopo.from_group(data, model=model)
        step_fn = make_train_step(cfg, run, topo, device, shape)
        groups = build_groups(cfg, topo.tp)
        plan = build_sync_plan(run, groups, topo)
        if plan is not None:
            print(WIRE.format_report(WIRE.plan_report(plan)), flush=True)
        state = make_init(cfg, run, topo, device, args.seed)
        # the *target* plan's fingerprint, built before any restore: a
        # layout change either reshards explicitly or fails loudly
        ckpt_fp = state_fingerprint(run, groups, topo, plan)
        start = 0
        if args.ckpt_dir:
            latest = CKPT.resume(args.ckpt_dir, state, topo,
                                 fingerprint=ckpt_fp,
                                 reshard=args.resume_reshard)
            if latest is not None:
                start = latest
                print(f"restored step {latest}", flush=True)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = t_run = time.perf_counter()
        first_s = None
        for step in range(start, args.steps):
            m = step_fn(state, step, batch_fn(step))
            loss = float(m["loss"])  # waits for the step to finish
            losses.append(loss)
            for k in router:
                if k in m:
                    router[k].append(float(m[k]))
            if first_s is None:
                first_s = time.perf_counter() - t0
                t_run = time.perf_counter()
            if step % args.log_every == 0 or step == args.steps - 1:
                n_run = step - start
                tok_s = (n_run * args.global_batch * args.seq_len
                         / max(time.perf_counter() - t_run, 1e-9))
                moe = "".join(f"{k}={v[-1]:.4f} " for k, v in router.items()
                              if v)
                print(f"step {step:5d} loss={loss:.4f} {moe}"
                      f"gnorm={float(m['gnorm']):.3f} lr={float(m['lr']):.2e} "
                      f"tok/s={tok_s:,.0f}", flush=True)
            if (args.ckpt_dir and args.ckpt_every
                    and (step + 1) % args.ckpt_every == 0):
                CKPT.save_train_state(args.ckpt_dir, step + 1, state, topo,
                                      fingerprint=ckpt_fp,
                                      keep=args.ckpt_keep)
        run_s = time.perf_counter() - t_run
        n_steps = max(args.steps - start, 0)
        n_run = max(n_steps - 1, 0)
        tok_s = n_run * args.global_batch * args.seq_len / run_s if n_run else None
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if not n_steps:
        print("nothing to do (restored step >= --steps)", flush=True)
        return {"losses": [], **router, "tok_per_s": None,
                "peak_mem_bytes": peak, "start": start}
    print(f"done: {n_steps} steps in {time.perf_counter() - t0:.1f}s "
          f"(first step {first_s or 0.0:.1f}s + run {run_s:.1f}s"
          + (f", {tok_s:,.0f} tok/s after the first step" if tok_s else "")
          + (f", peak device memory {peak / 2**30:.2f} GiB" if peak else "")
          + ")", flush=True)
    return {"losses": losses, **router, "tok_per_s": tok_s,
            "peak_mem_bytes": peak, "start": start}


if __name__ == "__main__":
    main()
