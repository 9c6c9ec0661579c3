"""Serving entry point (CLI): prefill a batch of prompts, then batched greedy
decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-400m \\
      --prompt-len 1024 --decode-steps 128 --batch 8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --reduced --prompt-len 64 --decode-steps 8 --batch 4 --device cpu

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch llama2-400m --reduced --tp 2 --device cpu

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
raises rather than fall back.  Under ``torchrun`` the world of ``dp * tp``
ranks splits into ``--tp``-rank model groups and ``dp``-rank data groups
(``launch.mesh.mesh_groups``); the batch is cut over the data ranks when
it has at least dp rows and replicated otherwise.  The weights are drawn
from ``--seed`` as the train CLI draws them, the prompts (or, for an
encoder-decoder, ``(batch, prompt_len, d_model)`` bf16 frames) from an
explicit generator seeded with ``--seed + 1``.

The KV caches hold the whole generation, ``prompt_len + decode_steps``
tokens (an encoder-decoder's ``min(1 + decode_steps, dec_len)``;
``steps.serve_window``): the reference sizes them to the prompt, so that
its decoded tokens lose the prompt's first positions (ROADMAP.md C).
Prints the prefill time, the decode tokens per second and milliseconds
per step, the peak device memory and one generated row.
``--profile-steps N`` traces decode step N with ``torch.profiler``.
"""
from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import flatparam as FP
from repro_torch.core.flatparam import MeshTopo
from repro_torch.kernels.wrap import LAUNCHES
from repro_torch.launch import mesh
from repro_torch.launch.steps import (greedy, make_decode_step,
                                      make_prefill_step, model_groups,
                                      serve_window)
from repro_torch.launch.train import resolve_device
from repro_torch.telemetry import profiler as PROF


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="prompt tokens (an encoder-decoder's frames)")
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree; dp = world size / tp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--profile-steps", default=None, metavar="N",
                    help="trace decode step N (0-based) with torch.profiler")
    ap.add_argument("--profile-dir", default="loco_trace",
                    help="output directory for --profile-steps traces")
    return ap.parse_args(argv)


def make_cfg(args):
    cfg = get_arch(args.arch)
    return reduced(cfg) if args.reduced else cfg


def make_batch(cfg, args) -> dict:
    """The global prompt batch, drawn on the host from ``--seed + 1``."""
    gen = torch.Generator().manual_seed(args.seed + 1)
    if cfg.enc_dec:
        return {"frames": torch.randn(args.batch, args.prompt_len,
                                      cfg.d_model, generator=gen
                                      ).to(torch.bfloat16)}
    return {"tokens": torch.randint(0, cfg.vocab,
                                    (args.batch, args.prompt_len),
                                    generator=gen)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, keep: bool = False) -> dict:
    """Serve; returns ``{"tokens": [[...]] (this rank's rows: the first
    token from the prefill, then one per decode step), "window": int (the
    tokens the caches were sized for, ``steps.serve_window``),
    "prefill_s", "prefill_tok_per_s", "decode_s" and "decode_tok_per_s"
    (over the decode steps that were not traced: the traced step's
    profiler start, export and summary are left out), "step_ms": [...]
    (every step, the traced one's decode call included), "peak_mem_bytes":
    int | None, "launches": {"prefill": {...}, "decode": {...}} (this
    repo's kernels), "trace": dict | None}``.  With ``keep`` it also holds
    ``params``, ``batch``, ``logits`` (the prefill's last-position local
    logits, then each decode step's, (B_l, V_local) f32) and ``state``."""
    args = build_args(argv)
    device = resolve_device(args.device)
    cfg = make_cfg(args)
    window = serve_window(cfg, args.prompt_len, args.decode_steps)
    cuda = device.type == "cuda"
    with mesh.dp_group(device):
        data, model = mesh.mesh_groups(args.tp)
        topo = MeshTopo.from_group(data, model=model)
        groups = model_groups(cfg, topo.tp)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        params = FP.init_serve_params(groups, topo.tp, topo.tp_rank, device,
                                      args.seed)
        batch = make_batch(cfg, args)
        prefill = make_prefill_step(cfg, topo, device, batch=args.batch,
                                    window=window)
        decode = make_decode_step(cfg, topo, device)
        trace = None
        if args.profile_steps is not None:
            n = int(args.profile_steps)
            trace = PROF.TraceSession(args.profile_dir, (n, n), cuda,
                                      torch.distributed.get_rank())

        before = collections.Counter(LAUNCHES)
        _sync(device)
        t0 = time.perf_counter()
        logits, state = prefill(params, batch)
        tok = greedy(logits, topo)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        mid = collections.Counter(LAUNCHES)
        kept = [logits.float()] if keep else None
        outs = [tok]
        step_s = []
        timed = 0
        decode_s = 0.0
        try:
            for i in range(args.decode_steps):
                traced = trace is not None and trace.lo == i
                t0 = time.perf_counter()
                if traced:
                    trace.maybe_start(i)
                t = time.perf_counter()
                tok, logits, state = decode(params, state, tok)
                _sync(device)
                step_s.append(time.perf_counter() - t)
                if traced:
                    trace.maybe_stop(i)
                else:
                    timed += 1
                    decode_s += time.perf_counter() - t0
                outs.append(tok)
                if keep:
                    kept.append(logits.float())
        finally:
            if trace is not None:
                trace.stop()
        after = collections.Counter(LAUNCHES)
        seqs = torch.cat(outs, dim=1).cpu()
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
    n_rows = seqs.shape[0]
    prompt_tokens = args.batch * args.prompt_len
    out = {"tokens": seqs.tolist(), "window": window,
           "prefill_s": prefill_s,
           "prefill_tok_per_s": prompt_tokens / prefill_s,
           "decode_s": decode_s,
           "decode_tok_per_s": (args.batch * timed / decode_s
                                if decode_s else None),
           "step_ms": [x * 1e3 for x in step_s],
           "peak_mem_bytes": peak,
           "launches": {"prefill": dict(mid - before),
                        "decode": dict(after - mid)},
           "trace": (dict(trace.summary, path=trace.path)
                     if trace is not None and trace.summary else None)}
    what = "frames" if cfg.enc_dec else "tokens"
    print(f"prefill {args.prompt_len} {what} x {args.batch} seqs: "
          f"{prefill_s:.3f} s ({out['prefill_tok_per_s']:,.0f} {what}/s); "
          f"KV window {window}", flush=True)
    if step_s:
        print(f"decoded {args.decode_steps} steps x {args.batch} seqs "
              f"({timed} untraced steps in {decode_s:.3f} s: "
              f"{out['decode_tok_per_s']:,.1f} tok/s, "
              f"median {statistics.median(out['step_ms']):.2f} ms per step)"
              + (f"; peak device memory {peak / 2**30:.2f} GiB"
                 if peak else ""), flush=True)
    print(f"sample ({n_rows} rows here): {out['tokens'][0]}", flush=True)
    if keep:
        out.update(params=params, batch=batch, logits=kept, state=state)
    return out


if __name__ == "__main__":
    main()
