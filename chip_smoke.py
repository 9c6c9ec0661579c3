#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card; all phases
    python3 chip_smoke.py --profile-only [--src OTHER/src]   # phase 4 only

Phases, in order; any failure exits non-zero and prints no result:

1. print the card (``nvidia-smi`` name and power limit) and build every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` with nvcc (one process per
   source, all at once);
2. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit: ``fused_compress``/``dequant_mean`` at every segment length
   the llama2-400m, deepseek-v3-moe and bucketed llama2-400m LoCo backwards
   give them (derived from the parameter declarations, the sync plans and
   the overlap schedules, ``sync_runs``) in every variant of their
   interface (f32 or bf16 gradient, error out of place or in place, f32 or
   bf16 shard, D = 1, 2, 4, 8), ``fused_compress`` in place into the run
   error views of path d's stage pieces, ``act_encode``/``act_decode`` at the
   deepseek-v3-moe exchange (81,920 rows of 512), ``onebit_pack`` at the
   onebit path's shapes; all of the LoCo and activation kernels also at
   the TP-local shapes a rank of a tp = 2 model group gives them at full
   width (from ``build_groups(cfg, 2)`` and the sync plans: 524,288,
   1,441,792 and 16,384,000 elements on llama2-400m, 131,072 and
   16,777,216 on deepseek-v3-moe; 40,960 rows of the exchange), which the
   one card cannot train; then each kernel's
   device time (torch.profiler)
   and host time per call beside its HBM bound, the plain version's device
   time and, for ``act_decode``, the one PyTorch call that computes the same
   function;
3. train, five paths through ``repro_torch.launch.train`` on a
   world-size-1 NCCL group, each with the launch counters zeroed just
   before it and read just after:
   a. full-width llama2-400m, ``--sync loco``, 6 steps;
   b. full-width, full-depth deepseek-v3-moe, ``--sync loco --moe-a2a
      block8``, 6 steps;
   c. full-width llama2-400m, ``--sync onebit``, 3 steps;
   d. full-width llama2-400m, ``--sync loco --bucket-mb 4 --policy
      "embed=loco8,min=1048576"``, 3 steps: the bucketed, coalesced sync
      with loco8, loco4 and fp buckets on the default backward-overlapped
      stage schedule (its wire report is printed first);
   d'. the same with ``--no-overlap``; d and d' run twice each, in the
      order d d' d' d, and all four give the same losses bit for bit;
   e. path a's command with ``--telemetry --metrics-jsonl --metrics-every
      1 --profile-steps 2:2``: path a's losses bit for bit (telemetry moves
      no bit), path a's kernel launches and collectives (every
      ``torch.distributed`` call counted), every metric finite, the stream
      accepted by ``repro_torch.telemetry.sink.validate_stream`` with
      ``err_norm``, ``sat_rate`` and ``update_ratio`` in every step record,
      a trace file of step 2; its tok/s beside path a's (information);
   f. path b's command with telemetry, 3 steps: path b's first 3 losses
      bit for bit, its collectives per step, 432 act_encode and 432
      act_decode, the MoE activation-wire report in the stream's header;
   g. full-width llama2-400m, 3 steps each, with ``--optimizer sgd``
      (``--lr 0.1``; no moments), ``lamb`` (``--lr 1e-3``), ``adafactor``
      (``--lr 3e-5``, run as ``adafactor_flat``: one moment), each
      profiled at step 2, and ``--schedule wsd`` (which keeps the lr of
      path a's cosine over 3 steps, so its losses are path a's first 3
      bit for bit): losses finite and falling, the loco kernels launched
      as derived, ``loco/apply``'s device time and the peak memory
      printed;
   losses finite (and falling on a, b and d), every kernel of the path
   launched as often as the code says (counts derived from the parameter
   declarations, the sync plan's encode runs or stage pieces and the
   layer structure, below), split by bit width, and the bucketed sync's
   packed collectives as many as its schedule has groups; each path gives
   the parent tree's losses bit for bit (``PARENT_LOSSES``: the
   tensor-parallel code at tp = 1 moves no bit), and no model-group
   collective or ``replicated_grad_psum`` is called;
3b. checkpoint: path d's command at full width, cut to CKPT_LAYERS layers:
   4 steps; the same 4 steps saving every 2 (``--ckpt-dir``,
   ``--ckpt-every 2``; the same losses); the step-4 file cut short; a new
   process resumes from step 2 and its steps 2-3 give the uninterrupted
   run's losses bit for bit (npz size, save and restore times printed);
4. profile: one more full-width step of paths a, b, d and of path a
   with ``--telemetry`` under torch.profiler: device busy time (kernels,
   memcpys, memsets) by kernel class, the idle share and the ``loco/*``
   ranges, per overlap stage on path d (``loco/encode/g1`` ...); the
   telemetry's cost in busy ms and step time against path a's
   (informational);
5. reference: reduced llama2-400m (loco, onebit, and loco bucketed with
   ``--bucket-mb 0.1 --policy "embed=loco8,min=16384"``) and reduced
   deepseek-v3-moe (loco, block8) train 3 steps on the card and on the CPU
   (plain versions, gloo); the losses agree within 2e-3 relative at step 0
   and 2e-2 at every step; so does reduced llama2-400m at
   ``--global-batch 12 --microbatch 4`` (three microbatches: the step's
   means divide by 3), and reduced llama2-400m with ``--optimizer sgd``,
   ``lamb`` and ``adafactor``, ``--quant-mode fixed`` and
   ``--error-codec bf16``, printed as bit for bit or within the limits;
   the step's divisions (``comm.divide`` at 3 and 6, the accum-3 gradient
   mean) give the CPU's bits on the card.  On
   the card, reduced llama2-400m with
   ``--bucket-mb 0.0625`` under a uniform policy gives the monolithic
   run's losses bit for bit.

Each phase prints its wall time.

The last lines are the card, one ``{"kernels": [...]}`` JSON object and the
``{"ok": true, "device": ...}`` JSON object.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _train_args(arch, sync, steps, *extra):
    return ["--arch", arch, "--sync", sync, "--seq-len", "1024",
            "--global-batch", "8", "--microbatch", "4", "--steps", str(steps),
            "--warmup", "1", "--log-every", "1", *extra]


TRAIN_ARGS = _train_args("llama2-400m", "loco", 6)
MOE_ARGS = _train_args("deepseek-v3-moe", "loco", 6, "--moe-a2a", "block8")
ONEBIT_ARGS = _train_args("llama2-400m", "onebit", 3)
# At dp = 1 a 4 MiB bucket is 1,048,576 elements: the embedding syncs at
# loco8, the 786,432-element tails of the MLP tensors and the 262,144-element
# tails of the embedding and the head ride the fp reduce-scatter, the rest
# is loco4 in fused runs.
BUCKET_ARGS = _train_args("llama2-400m", "loco", 3, "--bucket-mb", "4",
                          "--policy", "embed=loco8,min=1048576")
# The same run on the flat schedule (the overlapped one is the default):
# its losses must be path d's bit for bit.
FLAT_ARGS = BUCKET_ARGS + ["--no-overlap"]
# Paths e-g: the telemetry on paths a and b, and the other optimizers and
# schedules.  Each run adds its --metrics-jsonl / --profile-dir paths.
TELEMETRY_FLAGS = ["--telemetry", "--metrics-every", "1"]
E_ARGS = TRAIN_ARGS + TELEMETRY_FLAGS + ["--profile-steps", "2:2"]
F_ARGS = _train_args("deepseek-v3-moe", "loco", 3, "--moe-a2a",
                     "block8") + TELEMETRY_FLAGS
# name -> (flags, optimizer trees): sgd keeps no moment, adafactor runs as
# adafactor_flat (one), lamb and adam keep two.  Each optimizer takes an
# lr at which its 3 full-width steps fall; on the H100, lamb rose by step
# 2 at lr 2e-3 and above, and adafactor at 1e-4 and above (its first
# updates are sign-like, with no momentum).  wsd keeps Adam, whose
# loco/apply path e profiles, so wsd is not profiled.
G_RUNS = {"sgd": (["--optimizer", "sgd", "--lr", "0.1"], 0),
          "lamb": (["--optimizer", "lamb", "--lr", "1e-3"], 2),
          "adafactor": (["--optimizer", "adafactor", "--lr", "3e-5"], 1),
          "wsd": (["--schedule", "wsd"], 2)}
G_ARGS = {name: _train_args("llama2-400m", "loco", 3, *flags, *(
    () if name == "wsd" else ("--profile-steps", "2:2")))
          for name, (flags, _) in G_RUNS.items()}
# Each MoE layer exchanges its slot buffer twice (dispatch, combine); each
# exchange runs once in the forward, once in the checkpoint's recomputation
# and once in the backward (the cotangent rides the same wire), and calls
# act_encode and act_decode once each time.
EXCHANGES_PER_MOE_LAYER = 2 * 3


def _plan(argv, tp: int = 1):
    """(RunConfig, sync plan at dp = 1) of the training run ``argv`` on a
    rank of a ``tp``-way model group (its TP-local tensors): the
    monolithic plan (one run per LoCo tensor) without --bucket-mb/--policy."""
    import types

    from repro_torch.core import buckets
    from repro_torch.launch import steps, train
    from repro_torch.models.transformer import build_groups

    args = train.build_args(argv)
    run = train.make_run(args)
    groups = build_groups(train.make_cfg(args), tp)
    topo = types.SimpleNamespace(tp=tp, dp=1)
    return run, (steps.build_sync_plan(run, groups, topo)
                 or buckets.monolithic_sync_plan(groups, topo, run.sync))


def sync_units(run, pp) -> list:
    """The encode units of one parameter's sync under ``run``: the stage
    pieces of its overlap schedule when the bucketed sync runs overlapped
    (the default), else its encode runs."""
    from repro_torch.core import wirepack

    if run.wants_buckets() and run.coalesce and run.overlap:
        sched = wirepack.build_overlap_schedule(pp, 1)
        return [p for st in sched.stages for p in st.pieces]
    return list(wirepack.encode_runs(pp))


def sync_runs(argv, tp: int = 1) -> dict[tuple[int, int], int]:
    """(segment length, bits) -> how many stateful encodes one backward of
    the training run ``argv`` hands the gradient codec (fused_compress and
    dequant_mean, or onebit_pack), from the parameter declarations, the
    run's sync plan and, on the overlapped bucketed schedule, the plan's
    overlap schedule (``sync_units``).  At dp = 1 a monolithic run is its
    whole chunk slice: llama2-400m gives 1,048,576 (x96), 2,883,584 (x72)
    and 32,768,000 (x2); deepseek-v3-moe adds 33,554,432 (the 64 x 1024 x
    512 experts), 262,144 (GQA wk, wv) and 65,536 (the router).  The
    bucketed path d gives 2,097,152 (x72, the MLP tensors' two full
    buckets) and 1,048,576 (x96), and its embedding (8 bits) and head (4
    bits) runs of 32,505,856: one encode each on the flat schedule (d'),
    two on the overlapped one (d), cut at bucket 16 into 16,777,216 +
    15,728,640.  ``tp``: the same on one rank of a ``tp``-way model group,
    whose tensors are its TP-local slices (at tp = 2 on llama2-400m 524,288
    for the attention weights, 1,441,792 for the MLP, 16,384,000 for the
    embedding and the head)."""
    run, plan = _plan(argv, tp)
    out: dict[tuple[int, int], int] = {}
    for pp in plan.params:
        for u in sync_units(run, pp):
            if u.sync.needs_state():
                key = (u.chunk_total, u.sync.quant.bits)
                out[key] = out.get(key, 0) + pp.layers
    return dict(sorted(out.items()))


def sync_collectives(argv) -> int:
    """Packed collectives one backward of the training run ``argv`` issues
    through the bucketed sync (``telemetry/wire.plan_launches``: the
    overlap schedule's per-stage groups on path d, 246; the flat groups on
    d', 244; none on the monolithic paths)."""
    from repro_torch.telemetry import wire

    run, plan = _plan(argv)
    if not run.wants_buckets():
        return 0
    return wire.plan_launches(plan)["overlapped" if run.overlap
                                    else "coalesced"]


def loco_sizes(argv, tp: int = 1) -> dict[int, int]:
    """Segment length -> stateful encode runs per backward (``sync_runs``
    summed over bit widths)."""
    sizes: dict[int, int] = {}
    for (n, _), count in sync_runs(argv, tp).items():
        sizes[n] = sizes.get(n, 0) + count
    return sizes


@functools.lru_cache(maxsize=None)
def loco_path_sizes(tp: int = 1) -> list[int]:
    """Every segment length the LoCo paths (llama, deepseek, bucketed
    llama overlapped and flat; the checkpoint phase runs path d) launch
    fused_compress and dequant_mean at, on a rank of a ``tp``-way model
    group."""
    return sorted(set().union(*(loco_sizes(a, tp) for a in (
        TRAIN_ARGS, MOE_ARGS, BUCKET_ARGS, FLAT_ARGS))))


# A tp = 2 rank's shapes at full width: the card has one device, so the
# tp > 1 paths run on CPU gloo groups (tests/test_torch_tp*.py); here each
# kernel is held against its plain version at the shapes such a rank
# gives it.
TP_LOCAL = 2


def kernel_sizes() -> list[int]:
    """The segment lengths of the LoCo paths at tp = 1 and on a tp = 2
    rank."""
    return sorted(set(loco_path_sizes()) | set(loco_path_sizes(TP_LOCAL)))


def size_label(n: int) -> str:
    """Which paths give fused_compress and dequant_mean ``n`` elements."""
    tps = [tp for tp in (1, TP_LOCAL) if n in loco_path_sizes(tp)]
    return f" (tp {' and '.join(map(str, tps))})" if tps else ""

# Device-memory rate by card (NVIDIA data sheets); peak FLOP/s are not
# needed: every kernel does a few flops per byte.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12,
                   "H200": 4.8e12}


def hbm_rate(name: str) -> float:
    for key in sorted(HBM_BYTES_PER_S, key=len, reverse=True):
        if key in name:
            return HBM_BYTES_PER_S[key]
    raise RuntimeError(f"no memory rate on record for card {name!r}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def is_device_work(e) -> bool:
    """A profiler event that is device work: a kernel, memcpy or memset.
    GPU-side user-annotation ranges (``loco/*``) span such work and are
    none of their own."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not e.is_user_annotation


TRACE_TRIES = 3


def device_ms(fn, reps: int = 3, only: str | None = None,
              before=None) -> float:
    """Device time of one ``fn()``: the summed durations of the device work
    it launched (only the kernels whose name holds ``only``, when given),
    seen by torch.profiler over ``reps`` runs, divided by ``reps``.
    ``before()`` runs ahead of each ``fn()`` inside the trace (an L2 flush;
    ``only`` keeps it out of the sum).  A trace that holds no device time
    (the profiler now and then drops a short trace's device events) is
    taken again, up to ``TRACE_TRIES`` times; then ``fn`` is timed with
    CUDA events around each call instead (``event_ms``), and the line says
    so."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRACE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if is_device_work(e) and (only is None or only in e.key))
        if us:
            return us / 1e3 / reps
        print(f"device_ms: a trace held no device time (kernel filter "
              f"{only!r}); tracing again", flush=True)
    ms = event_ms(fn, reps, before)
    print(f"device_ms: {TRACE_TRIES} traces held no device time (kernel "
          f"filter {only!r}); CUDA events around each call give {ms:.4f} ms "
          f"(launch gaps included)", flush=True)
    return ms


def event_ms(fn, reps: int = 3, before=None) -> float:
    """Milliseconds of one ``fn()`` between two CUDA events recorded
    around it (``before()`` outside them), mean of ``reps``."""
    import torch

    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def host_us(fn, calls: int, reps: int = 3) -> float:
    """Host microseconds per call: wall time of ``fn()`` (``calls`` wrapper
    calls, no synchronisation inside) over ``calls``, median of ``reps``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(times) / calls * 1e6


def l2_flush(dev):
    """A callable that overwrites 128 MB (above the 50 MB L2) so the next
    kernel reads its inputs from HBM."""
    import torch

    buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    return lambda: buf.fill_(1)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _grad(n: int, gen, dev):
    """Gradient with a per-block magnitude from 1e-5 to 1 (large blocks push
    e * escale past the f8 bound of 448) and some all-zero blocks."""
    import torch

    blocks = n // 256
    mag = 10.0 ** (-5.0 * torch.rand(blocks, 1, generator=gen, device=dev))
    mag[torch.rand(blocks, 1, generator=gen, device=dev) < 0.01] = 0.0
    g = torch.randn(blocks, 256, generator=gen, device=dev) * mag
    return g.reshape(-1)


def _err(n: int, err: str, gen, dev):
    import torch

    e = torch.randn(n, generator=gen, device=dev)
    if err == "f8":
        return (e * 200.0).clamp(-448, 448).to(torch.float8_e4m3fn)
    return (e * 1e-3).to(torch.bfloat16)


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _same(a, b) -> bool:
    import torch

    if a.dtype in (torch.float8_e4m3fn, torch.bfloat16):
        view = torch.uint8 if a.dtype == torch.float8_e4m3fn else torch.int16
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


COMPRESS_CELLS = (("loco4-f8", 4, "f8", 0.5, 2.0**14),
                  ("loco8-f8", 8, "f8", 0.5, 2.0**14),
                  ("ef4-bf16", 4, "bf16", 1.0, 1.0))
# Off the main path: an error scale that is no power of two and a peer
# count that is none make the kernels divide where they otherwise multiply.
DIVIDE_CELL = ("loco4-f8-escale3000", 4, "f8", 0.5, 3000.0)
DIVIDE_N, DIVIDE_D = 3 * 64 * 512, 3
NEG_ZERO_STRIDE = 331   # g and e both -0.0 here: the table's signed zeros


def _check(name: str, what: str, got, want, worst: dict) -> None:
    worst[name] = max(worst[name], _max_abs(got, want))
    if not _same(got, want):
        raise AssertionError(f"{name} {what}: differs from the plain version "
                             f"(max |diff| {_max_abs(got, want)})")


def check_kernels(LQ, dev) -> dict:
    """Bit-exact comparisons of both kernels with their plain versions on
    the card at every chunk length the llama and deepseek LoCo paths give
    them (``loco_path_sizes``): ``fused_compress`` from an f32 and a bf16
    gradient, with the error written out of place and in place, in each
    error cell; ``dequant_mean`` at D = 1, 2, 4, 8 into f32 and bf16 (the
    bf16 shard must be the plain f32 mean rounded to bf16); then the
    dividing variants (``DIVIDE_CELL``, D = 3) at one small size.  Returns
    the max |difference|."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"fused_compress": 0.0, "dequant_mean": 0.0}
    runs = [(n, COMPRESS_CELLS, (1, 2, 4, 8)) for n in kernel_sizes()]
    runs.append((DIVIDE_N, (DIVIDE_CELL,), (DIVIDE_D,)))
    for n, cells, peers in runs:
        g32 = _grad(n, gen, dev)
        g32[5::NEG_ZERO_STRIDE] = -0.0
        for cell, bits, err, beta, escale in cells:
            e = _err(n, err, gen, dev)
            e[5::NEG_ZERO_STRIDE] = -0.0
            kw = dict(bits=bits, beta=beta, escale=escale, err=err)
            for g in (g32, g32.to(torch.bfloat16)):
                want = LQ.fused_compress_plain(g, e, **kw)
                e_in = e.clone()
                for how, got in (
                        ("out of place", LQ.fused_compress(g, e, **kw)),
                        ("in place", LQ.fused_compress(g, e_in, e_out=e_in,
                                                       **kw))):
                    torch.cuda.synchronize()
                    for k, w, what in zip(got, want,
                                          ("payload", "scales", "e_new")):
                        _check("fused_compress", f"{cell} {g.dtype} g {how} "
                               f"n={n}: {what}", k, w, worst)
                if got[2].data_ptr() != e_in.data_ptr():
                    raise AssertionError("fused_compress: e_out=e did not "
                                         "write the error in place")
            if err != "f8":
                continue
            payload, scales, _ = want
            for D in peers:
                p2, s2 = payload.reshape(D, -1), scales.reshape(D, -1)
                ref = LQ.dequant_mean_plain(p2, s2, bits=bits)
                for dt in (torch.float32, torch.bfloat16):
                    out = LQ.dequant_mean(p2, s2, bits=bits, out_dtype=dt)
                    torch.cuda.synchronize()
                    _check("dequant_mean", f"{bits}-bit D={D} n_chunk="
                           f"{n // D} into {dt}", out, ref.to(dt), worst)
        print(f"kernels: n={n}{size_label(n)} bit-exact (fused_compress: "
              f"{', '.join(c[0] for c in cells)}, f32 and bf16 g, error out "
              f"of place and in place; dequant_mean D="
              f"{','.join(map(str, peers))} into f32 and bf16)", flush=True)
    return worst


def check_piece_views(LQ, dev, worst: dict) -> None:
    """fused_compress on each stage piece that path d's overlap schedule
    cuts from a stateful run past its start (the embedding's and the
    head's second pieces), as the overlapped sync calls it at D = 1: the
    gradient and the error are views into the run's buffers at the
    piece's ``col_off``, the error written in place.  Payload, scales and
    the run's error buffer must equal the whole-run call's slices; the
    columns before the piece stay as they were."""
    import torch

    run, plan = _plan(BUCKET_ARGS)
    gen = torch.Generator(device=dev).manual_seed(4)
    for pp in plan.params:
        for p in sync_units(run, pp):
            if p.whole or not p.sync.needs_state():
                continue
            total, a = p.run_total, p.col_off
            bits = p.sync.quant.bits
            kw = dict(bits=bits, beta=p.sync.beta,
                      escale=p.sync.quant.error_scale, err="f8")
            g = _grad(total, gen, dev).to(torch.bfloat16)
            e = _err(total, "f8", gen, dev)
            whole = LQ.fused_compress(g, e, **kw)
            buf = e.clone()
            view = buf[a:a + p.chunk_total]
            got = LQ.fused_compress(g[a:a + p.chunk_total], view, e_out=view,
                                    **kw)
            torch.cuda.synchronize()
            pb = a // 2 if bits == 4 else a
            what = (f"{pp.qualname} run {p.run_index} piece at col_off {a} "
                    f"of {total}")
            _check("fused_compress", f"{what}: payload", got[0],
                   whole[0][pb:pb + got[0].numel()], worst)
            _check("fused_compress", f"{what}: scales", got[1],
                   whole[1][a // 256:a // 256 + got[1].numel()], worst)
            want = e.clone()
            want[a:a + p.chunk_total] = whole[2][a:a + p.chunk_total]
            _check("fused_compress", f"{what}: e_new in place", buf, want,
                   worst)
            print(f"kernels: {what} ({bits}-bit): in place into the run's "
                  "error view, bit-exact with the whole run", flush=True)


def compress_bytes(n: int, g_bytes: int = 2) -> float:
    """Bytes fused_compress must move at 4 bits with f8 error: g (bf16 by
    default, 4 for the f32 interface) and e f8 read once; payload, e_new
    and scales written once."""
    return n * g_bytes + n + n / 2 + n + n / 256 * 4


def dequant_bytes(n: int, D: int = 1, out_bytes: int = 2) -> float:
    """Bytes dequant_mean must move at 4 bits: D payload rows and scale rows
    read once, the mean (bf16 by default, 4 for f32) written once."""
    return D * (n / 2 + n / 256 * 4) + n * out_bytes


def time_kernels(LQ, dev, rate: float) -> dict:
    """Device time (torch.profiler), host time per call and the HBM bound of
    both kernels on the main path's interface (bf16 g, error in place, D =
    1, bf16 shard), for the calls one llama2-400m LoCo backward makes (170
    tensors, each on its own cold buffers), then per call at every LoCo
    path's shape after an L2 flush, beside the f32 interface and the plain
    version."""
    import torch

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    calls = []
    for n, count in loco_sizes(TRAIN_ARGS).items():
        for _ in range(count):
            g = (torch.randn(n, generator=gen, device=dev) * 1e-3).to(bf16)
            e = torch.zeros(n, dtype=torch.float8_e4m3fn, device=dev)
            calls.append((g, e))
    kw = dict(bits=4, beta=0.5, escale=2.0**14, err="f8")
    wires = [LQ.fused_compress(g, e, **kw)[:2] for g, e in calls]
    recv = [(p.reshape(1, -1), s.reshape(1, -1)) for p, s in wires]
    sizes = [g.numel() for g, _ in calls]

    def compress():
        for g, e in calls:
            LQ.fused_compress(g, e, e_out=e, **kw)

    def compress_plain():
        for g, e in calls:
            LQ.fused_compress_plain(g, e, **kw)

    def dequant():
        for p, s in recv:
            LQ.dequant_mean(p, s, out_dtype=bf16)

    def dequant_plain():
        for p, s in recv:
            LQ.dequant_mean_plain(p, s, out_dtype=bf16)

    out = {
        "fused_compress": dict(
            ms=device_ms(compress, only="fused_compress"),
            host_us=host_us(compress, len(calls)),
            plain_ms=device_ms(compress_plain, reps=1),
            bound_ms=sum(map(compress_bytes, sizes)) / rate * 1e3,
            bound_f32_ms=sum(compress_bytes(n, 4) for n in sizes)
            / rate * 1e3),
        "dequant_mean": dict(
            ms=device_ms(dequant, only="dequant_mean"),
            host_us=host_us(dequant, len(calls)),
            plain_ms=device_ms(dequant_plain, reps=1),
            bound_ms=sum(map(dequant_bytes, sizes)) / rate * 1e3,
            bound_f32_ms=sum(dequant_bytes(n, 1, 4) for n in sizes)
            / rate * 1e3),
    }
    for name, t in out.items():
        print(f"kernels: {name} one backward ({len(calls)} calls, 4-bit f8, "
              f"bf16 g in place / bf16 shard at D=1): device "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.1%} of HBM rate; f32 interface "
              f"bound {t['bound_f32_ms']:.4f} ms); host {t['host_us']:.1f} "
              f"us per call; plain {t['plain_ms']:.4f} ms device",
              flush=True)
    del calls, wires, recv
    flush = l2_flush(dev)
    for n in kernel_sizes():
        g = (torch.randn(n, generator=gen, device=dev) * 1e-3).to(bf16)
        g32 = g.float()
        e = torch.zeros(n, dtype=torch.float8_e4m3fn, device=dev)
        p, s, _ = LQ.fused_compress(g, e, **kw)
        p, s = p.reshape(1, -1), s.reshape(1, -1)
        t = {
            "compress": device_ms(lambda: LQ.fused_compress(g, e, e_out=e,
                                                            **kw),
                                  only="fused_compress", before=flush),
            "compress_f32": device_ms(lambda: LQ.fused_compress(g32, e, **kw),
                                      only="fused_compress", before=flush),
            "compress_plain": device_ms(
                lambda: LQ.fused_compress_plain(g, e, **kw), reps=1),
            "compress_host": host_us(
                lambda: LQ.fused_compress(g, e, e_out=e, **kw), 1, reps=5),
            "dequant": device_ms(lambda: LQ.dequant_mean(p, s, out_dtype=bf16),
                                 only="dequant_mean", before=flush),
            "dequant_f32": device_ms(lambda: LQ.dequant_mean(p, s),
                                     only="dequant_mean", before=flush),
            "dequant_plain": device_ms(
                lambda: LQ.dequant_mean_plain(p, s, out_dtype=bf16), reps=1),
            "dequant_host": host_us(
                lambda: LQ.dequant_mean(p, s, out_dtype=bf16), 1, reps=5),
        }
        us = {k: v * 1e3 for k, v in t.items() if not k.endswith("host")}
        print(f"kernels: n={n}{size_label(n)}: fused_compress device "
              f"{us['compress']:.1f} us "
              f"bf16 g in place (bound {compress_bytes(n) / rate * 1e6:.1f} "
              f"us), {us['compress_f32']:.1f} us f32 g (bound "
              f"{compress_bytes(n, 4) / rate * 1e6:.1f} us), host "
              f"{t['compress_host']:.1f} us, plain "
              f"{us['compress_plain']:.1f} us; dequant_mean device "
              f"{us['dequant']:.1f} us bf16 out (bound "
              f"{dequant_bytes(n) / rate * 1e6:.1f} us), "
              f"{us['dequant_f32']:.1f} us f32 out (bound "
              f"{dequant_bytes(n, 1, 4) / rate * 1e6:.1f} us), host "
              f"{t['dequant_host']:.1f} us, plain "
              f"{us['dequant_plain']:.1f} us", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 2, continued: the activation wire and the onebit wire
# ---------------------------------------------------------------------------

def moe_exchange_rows(tp: int = 1) -> int:
    """Rows of 512 that one deepseek-v3-moe exchange quantizes at seq 1024,
    microbatch 4, on a rank of a ``tp``-way model group (its ``tp`` peer
    rows of El experts x cap slots x d_model): 64 x 640 x 1024 / 512 =
    81,920 at tp = 1; 2 x 32 x 320 x 1024 / 512 = 40,960 at tp = 2."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core import act_comm

    g = act_comm.a2a_geometry(get_arch("deepseek-v3-moe"), 4 * 1024, tp)
    return tp * g["n_pad"] // act_comm.ACT_BLOCK


def _act_input(rows: int, gen, dev):
    """Rows with magnitudes from 1e-5 to 1e3, some all zero (dead slots),
    one with a value near the f32 maximum, some of denormals only."""
    import torch

    h = torch.randn(rows, 512, generator=gen, device=dev)
    h *= 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 8 - 5)
    h[torch.rand(rows, generator=gen, device=dev) < 0.01] = 0.0
    h[7, 300] = 3.0e38
    h[11::997] *= 1e-39
    return h


def act_bytes(rows: int) -> float:
    """Bytes act_encode (and act_decode) must move: f32 rows and int8 rows,
    one read and one written, plus one f32 scale per row."""
    return rows * 512 * (4 + 1) + rows * 4


def onebit_bytes(n: int) -> float:
    """Bytes onebit_pack must move: f32 h read; n/8 sign bytes and the bf16
    error written; one f32 scale read."""
    return n * 4 + n / 8 + n * 2 + 4


def kernel_act(AQ, dev, rate: float, tp: int = 1) -> dict:
    """act_encode / act_decode at the deepseek-v3-moe exchange of a rank of
    a ``tp``-way model group: bit-exact against the plain versions (and
    the decode against ``q / scale``), then timed per call."""
    import torch

    rows = moe_exchange_rows(tp)
    gen = torch.Generator(device=dev).manual_seed(2)
    h = _act_input(rows, gen, dev)
    q, s = AQ.act_encode(h)
    pq, ps = AQ.act_encode_plain(h)
    out = AQ.act_decode(q, s)
    lib = q / s[:, None]
    ref = AQ.act_decode_plain(q, s)
    torch.cuda.synchronize()
    if not (torch.equal(q, pq) and torch.equal(s, ps)):
        raise AssertionError(f"act_encode rows={rows}: differs from the plain "
                             f"version (codes {_max_abs(q, pq)}, scales "
                             f"{_max_abs(s, ps)})")
    if not torch.equal(out, ref):
        raise AssertionError(f"act_decode rows={rows}: differs from the "
                             f"plain version ({_max_abs(out, ref)})")
    if not torch.equal(out, lib):
        raise AssertionError("act_decode: differs from q / scale[:, None] "
                             f"({_max_abs(out, lib)})")
    if not (q[7].abs().max() == 127 and torch.isfinite(out).all()):
        raise AssertionError("act wire: the 3e38 row did not round-trip")
    bound = act_bytes(rows) / rate * 1e3
    calls = 10

    def per_call(fn, *args, only=None, reps=3):
        # device time per call over back-to-back calls (the 168 MB input
        # exceeds L2), and host time per call
        def go():
            for _ in range(calls):
                fn(*args)
        return (device_ms(go, reps, only=only) / calls,
                host_us(go, calls) if only else None)

    res = {}
    for name, fn, plain, args, err in (
            ("act_encode", AQ.act_encode, AQ.act_encode_plain, (h,),
             max(_max_abs(q, pq), _max_abs(s, ps))),
            ("act_decode", AQ.act_decode, AQ.act_decode_plain, (q, s),
             _max_abs(out, ref))):
        ms, host = per_call(fn, *args, only=name)
        res[name] = dict(max_abs_err=err, ms=ms, host_us=host,
                         plain_ms=per_call(plain, *args, reps=1)[0],
                         bound_ms=bound, library_ms=None)
    res["act_decode"]["library_ms"] = per_call(lambda a, b: a / b[:, None],
                                               q, s)[0]
    for name, t in res.items():
        lib_s = (f", q / scale {t['library_ms'] * 1e3:.1f} us"
                 if t["library_ms"] is not None else "")
        print(f"kernels: {name} rows={rows} (tp {tp}) bit-exact; device "
              f"{t['ms'] * 1e3:.1f} us per call, bound "
              f"{t['bound_ms'] * 1e3:.1f} us ({t['bound_ms'] / t['ms']:.1%} "
              f"of HBM rate), host {t['host_us']:.1f} us per call, plain "
              f"{t['plain_ms'] * 1e3:.1f} us{lib_s}", flush=True)
    return res


def kernel_onebit(SP, dev, rate: float) -> dict:
    """onebit_pack at every shape of the onebit path, exact and negative
    zeros included, bit-exact against the plain version; then the calls of
    one backward, each on its own cold buffers."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    sizes = loco_sizes(ONEBIT_ARGS)
    for n in sizes:
        h = torch.randn(n, generator=gen, device=dev) * 1e-3
        h[::97] = 0.0
        h[1::89] = -0.0
        scale = h.abs().mean()
        p, e = SP.onebit_pack(h, scale)
        pp, pe = SP.onebit_pack_plain(h, scale)
        torch.cuda.synchronize()
        worst = max(worst, _max_abs(p, pp), _max_abs(e, pe))
        if not (torch.equal(p, pp) and _same(e, pe)):
            raise AssertionError(f"onebit_pack n={n}: differs from the "
                                 f"plain version")
        print(f"kernels: onebit_pack n={n} bit-exact", flush=True)
    calls = []
    for n, count in sizes.items():
        for _ in range(count):
            h = torch.randn(n, generator=gen, device=dev) * 1e-3
            calls.append((h, h.abs().mean()))

    def run(fn):
        def go():
            for h, sc in calls:
                fn(h, sc)
        return go

    res = dict(max_abs_err=worst,
               ms=device_ms(run(SP.onebit_pack), only="onebit_pack"),
               host_us=host_us(run(SP.onebit_pack), len(calls)),
               plain_ms=device_ms(run(SP.onebit_pack_plain), reps=1),
               bound_ms=sum(onebit_bytes(h.numel()) for h, _ in calls)
               / rate * 1e3, library_ms=None)
    print(f"kernels: onebit_pack one backward ({len(calls)} calls): device "
          f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_ms'] / res['ms']:.1%} of HBM rate), host "
          f"{res['host_us']:.1f} us per call, plain {res['plain_ms']:.4f} ms",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

KERNEL_ROWS = (  # name, CUDA source, the TPU kernel it replaces
    ("fused_compress", "loco_quant.cu", "src/repro/kernels/loco_quant.py:84"),
    ("dequant_mean", "loco_quant.cu", "src/repro/kernels/loco_quant.py:172"),
    ("onebit_pack", "sign_pack.cu", "src/repro/kernels/sign_pack.py:44"),
    ("act_encode", "act_quant.cu", "src/repro/kernels/act_quant.py:50"),
    ("act_decode", "act_quant.cu", "src/repro/kernels/act_quant.py:74"),
)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-only", action="store_true",
                    help="build, then run only phase 4 (print no result)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the package tree to import (with --profile-only: "
                         "another checkout's src/, to compare two commits)")
    opts = ap.parse_args(argv)
    src = Path(opts.src).resolve()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; package {src}", flush=True)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {', '.join(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for b in built.values():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {b.name}: {line.strip()}")
    if opts.profile_only:
        for args in (TRAIN_ARGS, MOE_ARGS):
            profile_phase(args)
        return 0

    from repro_torch.kernels import act_quant as AQ
    from repro_torch.kernels import loco_quant as LQ
    from repro_torch.kernels import sign_pack as SP

    rate = hbm_rate(torch.cuda.get_device_name(0))
    worst = check_kernels(LQ, dev)
    check_piece_views(LQ, dev, worst)
    timing = time_kernels(LQ, dev, rate)
    for name in timing:
        timing[name].update(max_abs_err=worst[name], library_ms=None)
    timing.update(kernel_act(AQ, dev, rate))
    for name, t in kernel_act(AQ, dev, rate, TP_LOCAL).items():
        timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"],
                                          t["max_abs_err"])
    timing["onebit_pack"] = kernel_onebit(SP, dev, rate)
    torch.cuda.empty_cache()
    print(f"kernels: phase done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    launches = train_phase(LQ)
    print(f"train: phase took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    _add(launches, checkpoint_phase(LQ, src))
    print(f"checkpoint: phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    missing = [name for name, _, _ in KERNEL_ROWS if not launches.get(name)]
    if missing:
        raise AssertionError(f"train: kernels never launched: {missing}")
    t0 = time.perf_counter()
    prof = {name: profile_phase(args) for name, args in (
        ("a", TRAIN_ARGS), ("b", MOE_ARGS), ("d", BUCKET_ARGS),
        ("a --telemetry", TRAIN_ARGS + ["--telemetry"]))}
    a, tel = prof["a"], prof["a --telemetry"]
    print(f"profile: telemetry on path a: device busy {tel['busy_ms']:.1f} "
          f"against {a['busy_ms']:.1f} ms ({tel['busy_ms'] / a['busy_ms']:.3f}"
          f"x); step {tel['wall_ms']:.1f} against {a['wall_ms']:.1f} ms "
          f"(information: steps spread 2-2.6x between calls)", flush=True)
    print(f"profile: phase took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    reference_phase()
    print(f"reference: phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    rows = []
    for name, src, replaces in KERNEL_ROWS:
        t = timing[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "host_us": t["host_us"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": "bytes",
                     "library_ms": t["library_ms"]})
    print(f"done: all phases in {time.perf_counter() - t_start:.0f} s",
          flush=True)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 3: the main paths, through the training CLI
# ---------------------------------------------------------------------------

def _backwards(argv, steps: int | None = None) -> int:
    """Microbatch backwards of ``steps`` steps (default: all) of ``argv``."""
    from repro_torch.launch import train

    args = train.build_args(argv)
    steps = args.steps if steps is None else steps
    return steps * (args.global_batch // args.microbatch)


def launches_by_bits(argv, steps: int | None = None) -> dict[int, int]:
    """fused_compress (and dequant_mean) launches of a LoCo training run by
    bit width: its stateful encodes per backward times the backwards."""
    out: dict[int, int] = {}
    for (_, bits), count in sync_runs(argv).items():
        out[bits] = out.get(bits, 0) + count * _backwards(argv, steps)
    return out


def expected_launches(argv, steps: int | None = None) -> dict:
    """Launches each kernel of a training run (of ``steps`` steps, default
    all) must make, from the code: per microbatch backward one
    fused_compress and one dequant_mean per stateful encode of the sync
    (one per LoCo tensor on the monolithic path, one per encode run or, on
    the overlapped bucketed schedule, per stage piece; one onebit_pack
    with --sync onebit), and per MoE layer and microbatch
    EXCHANGES_PER_MOE_LAYER act_encode and act_decode."""
    from repro_torch.launch import train

    args = train.build_args(argv)
    cfg = train.make_cfg(args)
    loco = sum(launches_by_bits(argv, steps).values())
    want = ({"onebit_pack": loco} if args.sync == "onebit" else
            {"fused_compress": loco, "dequant_mean": loco})
    if cfg.family == "moe" and cfg.moe_a2a_codec == "block8":
        acts = EXCHANGES_PER_MOE_LAYER * cfg.n_layers * _backwards(argv,
                                                                   steps)
        want.update(act_encode=acts, act_decode=acts)
    return want


@contextlib.contextmanager
def count_sync_collectives():
    """Count the packed collectives the bucketed sync issues (each stage
    of each sync issues its reduce-scatter, all-to-all and all-gather
    through ``core/comm``'s one issuing method, which is wrapped here)."""
    from repro_torch.core import comm

    issued = [0]
    issue = comm._SyncPass.issue

    def counting(self, gplan, wires, fp_segs):
        inflight = issue(self, gplan, wires, fp_segs)
        issued[0] += len(inflight.works)
        return inflight

    comm._SyncPass.issue = counting
    try:
        yield issued
    finally:
        comm._SyncPass.issue = issue


# torch.distributed's collectives, and core/comm's, which bind theirs when
# the module is imported
DIST_COLLECTIVES = ("all_reduce", "all_to_all_single",
                    "all_gather_into_tensor", "reduce_scatter_tensor",
                    "all_gather", "broadcast", "reduce_scatter", "gather",
                    "scatter", "barrier")
COMM_COLLECTIVES = ("_ALL_GATHER", "_REDUCE_SCATTER")


@contextlib.contextmanager
def count_collectives():
    """Count every collective the run calls, by name."""
    import torch.distributed as dist

    from repro_torch.core import comm

    counts: dict[str, int] = {}

    def counting(name, fn):
        def wrapped(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    saved = [(dist, n, getattr(dist, n)) for n in DIST_COLLECTIVES
             if hasattr(dist, n)]
    saved += [(comm, n, getattr(comm, n)) for n in COMM_COLLECTIVES]
    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_path(LQ, argv, falls: bool) -> tuple[dict, dict]:
    """Train once through the CLI with the launch counters zeroed just
    before and read just after; returns that run's launch counts and its
    result, with every collective it called (``res["collectives"]``).
    Also asserts the bucketed sync's collectives per backward."""
    import torch
    from repro_torch.launch import train

    print(f"train: python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    want = expected_launches(argv)
    want_coll = sync_collectives(argv) * _backwards(argv)
    t0 = time.perf_counter()
    LQ.reset_launches()
    with count_sync_collectives() as issued, count_collectives() as called:
        res = train.main(argv)
    res["collectives"] = called
    res["launches"] = dict(LQ.LAUNCHES)
    launches = dict(LQ.LAUNCHES)
    secs = time.perf_counter() - t0
    losses = res["losses"]
    steps = train.build_args(argv).steps
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: losses not finite: {losses}")
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"train: launches {launches}, want {want} "
                             f"(derived from the code; see expected_launches)")
    if issued[0] != want_coll:
        raise AssertionError(f"train: the bucketed sync issued {issued[0]} "
                             f"collectives, want {want_coll} (sync_"
                             "collectives x backwards)")
    router = (f"; moe_aux {res['moe_aux']}; moe_z {res['moe_z']}"
              if res["moe_aux"] else "")
    bits = ""
    if "fused_compress" in want:
        bits = " by bit width " + ", ".join(
            f"{b}-bit {n}" for b, n in sorted(launches_by_bits(argv).items()))
    coll = (f"; {issued[0]} sync collectives ({want_coll // _backwards(argv)}"
            " per backward, as derived)" if want_coll else "")
    print(f"train: losses {losses}{router}; {res['tok_per_s']:.1f} tok/s "
          f"after the first step; peak device memory "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches} "
          f"(as derived{bits}){coll}; {secs:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return launches, res


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


# What the parent tree (before the TP-aware code) gave on the card, run P
# of PERF.md (H100 80GB HBM3, 700 W): every path's losses.  At tp = 1 the
# TP-aware code must move none of them by a bit.  (Launches and sync
# collectives are held against the counts derived from the code in
# train_path.)
PARENT_LOSSES = {
    "a": [10.68307113647461, 10.063291549682617, 9.444741249084473,
          9.204526901245117, 8.938225746154785, 8.848466873168945],
    "b": [11.144638061523438, 10.528535842895508, 9.801465034484863,
          9.565465927124023, 9.370441436767578, 9.285552978515625],
    "c": [10.68307113647461, 10.269325256347656, 9.74044132232666],
    "d": [10.68307113647461, 10.062225341796875, 9.441856384277344],
    "d'": [10.68307113647461, 10.062225341796875, 9.441856384277344]}
PARENT_CKPT_LOSSES = [10.762600898742676, 9.794729232788086,
                      9.226005554199219, 9.016355514526367]


def check_parent(name: str, res: dict, label: str | None = None) -> None:
    """The run ``label`` (default: path ``name``) gave path ``name``'s
    parent losses bit for bit, as far as it ran."""
    got = res["losses"]
    want = PARENT_LOSSES[name][:len(got)]
    label = label or name
    ok = got == want
    print(f"train: path {label} losses {got} against path {name}'s parent "
          f"{want}: {'bit for bit' if ok else 'MOVED'}", flush=True)
    if not ok:
        raise AssertionError(f"train: path {label}: the losses moved from "
                             f"path {name}'s parent's {want}: {got}")


@contextlib.contextmanager
def count_model_group_calls():
    """Count the calls of the model-group collectives (``sp_gather``,
    ``sp_scatter_sum``, ``psum_tp``, the token all-gather) and of
    ``replicated_grad_psum``: at tp = 1 the model calls none of them."""
    from repro_torch.core import hijack
    from repro_torch.models import common

    calls = [0]
    classes = (common._AllGather, common._ReduceScatter, common._Psum,
               hijack._SumGradsOverModel)
    saved = [cls.apply for cls in classes]

    def counting(apply):
        def wrapped(*args):
            calls[0] += 1
            return apply(*args)
        return wrapped

    for cls, apply in zip(classes, saved):
        cls.apply = counting(apply)
    try:
        yield calls
    finally:
        for cls in classes:
            del cls.apply   # back to torch.autograd.Function's


def train_phase(LQ) -> dict:
    """The main paths a-c, then d and d' (path d on the flat schedule) in
    turns, d d' d' d, so that their throughputs compare within one call;
    every d and d' run must give the same losses bit for bit, and every
    path the parent's losses (``check_parent``), with no model-group
    collective called.  Returns
    every kernel's launches summed over the runs."""
    total: dict[str, int] = {}
    runs: dict[str, list] = {"a": [], "b": [], "d": [], "d'": []}
    with count_model_group_calls() as tp_calls:
        for name, argv, falls in (("a", TRAIN_ARGS, True),
                                  ("b", MOE_ARGS, True),
                                  ("c", ONEBIT_ARGS, False),
                                  ("d", BUCKET_ARGS, True),
                                  ("d'", FLAT_ARGS, True),
                                  ("d'", FLAT_ARGS, True),
                                  ("d", BUCKET_ARGS, True)):
            launches, res = train_path(LQ, argv, falls)
            check_parent(name, res)
            _add(total, launches)
            if name in runs:
                runs[name].append(res)
        _add(total, telemetry_paths(LQ, runs["a"][0], runs["b"][0]))
        _add(total, optimizer_paths(LQ, runs["a"][0]))
    print(f"train: model-group collectives and replicated_grad_psum called "
          f"{tp_calls[0]} times at tp = 1", flush=True)
    if tp_calls[0]:
        raise AssertionError("train: a tp = 1 path called a model-group "
                             "collective")
    over = [r["tok_per_s"] for r in runs["d"]]
    flat = [r["tok_per_s"] for r in runs["d'"]]
    print(f"train: path d overlapped {over} tok/s, d' flat {flat} tok/s "
          f"(runs in the order d d' d' d); mean ratio d/d' "
          f"{statistics.mean(over) / statistics.mean(flat):.3f}", flush=True)
    losses = [r["losses"] for k in ("d", "d'") for r in runs[k]]
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"train: the overlapped and the flat schedule's "
                             f"losses differ: {losses}")
    return total


# ---------------------------------------------------------------------------
# phase 3, paths e-g: telemetry, the other optimizers and schedules
# ---------------------------------------------------------------------------

def check_stream(path: str, steps: int, moe: bool) -> list[dict]:
    """The telemetry stream of a ``steps``-step monolithic run: valid
    (``validate_stream``), a header (with the MoE activation-wire report
    iff ``moe``), one step record per step whose metrics are all finite
    and carry ``err_norm``, ``sat_rate`` and ``update_ratio``, a summary,
    no warning.  Returns the step records."""
    from repro_torch.telemetry import sink

    res = sink.validate_stream(path)
    want = {"header": 1, "step": steps, "summary": 1}
    if res["errors"] or res["kinds"] != want:
        raise AssertionError(f"telemetry: stream {res}, want kinds {want}")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    if ("moe_a2a" in recs[0]) != moe:
        raise AssertionError(f"telemetry: header keys {sorted(recs[0])}")
    out = [r for r in recs if r["kind"] == "step"]
    for r in out:
        m = r["metrics"]
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or not all(m.get(k, 0) > 0 for k in ("err_norm", "sat_rate",
                                                    "update_ratio")):
            raise AssertionError(f"telemetry: step {r['step']}: not finite "
                                 f"{bad}, or a health metric missing")
        print(f"telemetry: step {r['step']}: {len(m)} metrics, err_norm "
              f"{m['err_norm']:.4f} sat_rate {m['sat_rate']:.4f} "
              f"update_ratio {m['update_ratio']:.3e} nonfinite "
              f"{m['nonfinite']:.0f}", flush=True)
    return out


def _trace_line(res: dict) -> str:
    t = res["trace"]
    if not t or not os.path.exists(t["path"]):
        raise AssertionError(f"telemetry: no trace file written ({t})")
    ranges = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
        t["ranges"].items()) if k in ("loco/apply", "loco/metrics"))
    return (f"trace of step 2 {os.path.getsize(t['path']):,} bytes; device "
            f"busy {t['device_busy_ms']:.1f} ms, {t['device_launches']} "
            f"launches; {ranges}")


def telemetry_paths(LQ, a: dict, b: dict) -> dict:
    """Paths e and f: telemetry on paths a and b moves no loss bit, no
    kernel launch and no collective, and streams valid, finite records.
    Returns their launches."""
    import tempfile

    total: dict[str, int] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tel_") as tmp:
        out = ["--metrics-jsonl", os.path.join(tmp, "e.jsonl"),
               "--profile-dir", tmp]
        from repro_torch.telemetry import profiler

        with timed_calls(profiler.TraceSession, "stop") as stop_s:
            launches, e = train_path(LQ, E_ARGS + out, True)
        _add(total, launches)
        check_parent("a", e, "e")
        if e["launches"] != a["launches"]:
            raise AssertionError(f"telemetry: path e launched "
                                 f"{e['launches']}, path a {a['launches']}")
        if e["collectives"] != a["collectives"]:
            raise AssertionError(f"telemetry: path e called "
                                 f"{e['collectives']}, path a "
                                 f"{a['collectives']}")
        check_stream(out[1], 6, moe=False)
        print(f"telemetry: path e: collectives {e['collectives']} as path "
              f"a's; {e['tok_per_s']:.1f} tok/s (path a {a['tok_per_s']:.1f}"
              f", information: the trace of step 2 is inside e's clock, "
              f"and stopping it took {max(stop_s):.1f} s); {_trace_line(e)}",
              flush=True)
        path = os.path.join(tmp, "f.jsonl")
        launches, f = train_path(LQ, F_ARGS + ["--metrics-jsonl", path],
                                 True)
        _add(total, launches)
        check_parent("b", f, "f")
        steps_b, steps_f = len(b["losses"]), len(f["losses"])
        per_b = {k: v / steps_b for k, v in b["collectives"].items()}
        per_f = {k: v / steps_f for k, v in f["collectives"].items()}
        if per_b != per_f:
            raise AssertionError(f"telemetry: path f called {per_f} per "
                                 f"step, path b {per_b}")
        check_stream(path, steps_f, moe=True)
        print(f"telemetry: path f: collectives per step {per_f} as path "
              f"b's; {f['tok_per_s']:.1f} tok/s (path b "
              f"{b['tok_per_s']:.1f})", flush=True)
    return total


@contextlib.contextmanager
def optimizer_trees():
    """Record how many optimizer trees each train state the CLI builds
    holds."""
    from repro_torch.launch import train

    make_init, seen = train.make_init, []

    def recording(*args, **kw):
        ts = make_init(*args, **kw)
        seen.append(len(ts.opt))
        return ts

    train.make_init = recording
    try:
        yield seen
    finally:
        train.make_init = make_init


def optimizer_paths(LQ, a: dict) -> dict:
    """Path g: full-width llama2-400m under sgd, lamb, adafactor and the
    wsd schedule.  Returns their launches."""
    import tempfile

    total: dict[str, int] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_opt_") as tmp:
        for name, (_, trees) in G_RUNS.items():
            with optimizer_trees() as seen:
                launches, res = train_path(
                    LQ, G_ARGS[name] + ["--profile-dir", tmp], True)
            _add(total, launches)
            if seen != [trees]:
                raise AssertionError(f"optimizer: {name} kept {seen} "
                                     f"optimizer trees, want {trees}")
            if name == "wsd":
                check_parent("a", res, "g wsd")
            print(f"optimizer: {name}: losses {res['losses']}; {trees} "
                  f"optimizer trees; peak device memory "
                  f"{res['peak_mem_bytes'] / 2**30:.2f} GiB (path a "
                  f"{a['peak_mem_bytes'] / 2**30:.2f})"
                  + (f"; {_trace_line(res)}" if res["trace"] else ""),
                  flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 3b: checkpoint and resume in a new process
# ---------------------------------------------------------------------------

# llama2-400m at full width on path d's policy, cut to CKPT_LAYERS layers
# (dataclasses.replace on the config, here only): the full depth's npz
# (f32 chunks, two Adam moments, f8 errors) is about 5 GB per save.
CKPT_LAYERS = 4
CKPT_ARGS = _train_args("llama2-400m", "loco", 4, "--bucket-mb", "4",
                        "--policy", "embed=loco8,min=1048576")


@contextlib.contextmanager
def cut_depth(layers: int):
    """Train (and derive counts for) ``layers`` layers of the CLI's model."""
    import dataclasses

    from repro_torch.launch import train

    make_cfg = train.make_cfg
    train.make_cfg = lambda args: dataclasses.replace(make_cfg(args),
                                                      n_layers=layers)
    try:
        yield
    finally:
        train.make_cfg = make_cfg


@contextlib.contextmanager
def timed_calls(module, name: str):
    """Record the wall time of each call of ``module.name``."""
    fn, times = getattr(module, name), []

    def timed(*args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            times.append(time.perf_counter() - t)

    setattr(module, name, timed)
    try:
        yield times
    finally:
        setattr(module, name, fn)


def resume_run(argv) -> None:
    """A new process's side of the checkpoint phase: train ``argv`` (which
    restores from its --ckpt-dir) at CKPT_LAYERS layers; print one JSON
    line with the losses, the restored step, the launches, the sync's
    collectives and the restore time."""
    from repro_torch.checkpoint import checkpoint as CKPT
    from repro_torch.kernels import loco_quant as LQ
    from repro_torch.launch import train

    with cut_depth(CKPT_LAYERS), timed_calls(CKPT, "resume") as restore_s, \
            count_sync_collectives() as issued:
        LQ.reset_launches()
        res = train.main(argv)
    print(json.dumps({"losses": res["losses"], "start": res["start"],
                      "launches": dict(LQ.LAUNCHES), "collectives": issued[0],
                      "restore_s": restore_s}))


def checkpoint_phase(LQ, src: Path) -> dict:
    """4 steps uninterrupted (the parent's losses bit for bit); the same 4
    steps saving every 2 (the losses must not move); the step-4 file then cut short, as a save killed by
    preemption leaves it; a new process with the same --ckpt-dir falls
    back to step 2, restores it and trains steps 2-3, whose losses must be
    the uninterrupted run's bit for bit.  Returns the launches of all
    three runs (each asserted as derived)."""
    import tempfile

    from repro_torch.checkpoint import checkpoint as CKPT

    total: dict[str, int] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp, \
            cut_depth(CKPT_LAYERS):
        argv = CKPT_ARGS + ["--ckpt-dir", tmp]
        print(f"checkpoint: {CKPT_LAYERS} of llama2-400m's 24 layers at "
              "full width", flush=True)
        launches, full = train_path(LQ, CKPT_ARGS, True)
        print(f"checkpoint: losses {full['losses']} against the parent's "
              f"{PARENT_CKPT_LOSSES}", flush=True)
        if full["losses"] != PARENT_CKPT_LOSSES:
            raise AssertionError("checkpoint: the losses moved from the "
                                 "parent's")
        _add(total, launches)
        with timed_calls(CKPT, "save_train_state") as save_s:
            launches, saved = train_path(LQ, argv + ["--ckpt-every", "2"],
                                         True)
        _add(total, launches)
        if saved["losses"] != full["losses"]:
            raise AssertionError("checkpoint: saving moved the losses: "
                                 f"{saved['losses']} vs {full['losses']}")
        files = sorted(Path(tmp).glob("ckpt_*.npz"))
        sizes = [f.stat().st_size for f in files]
        if [f.name for f in files] != ["ckpt_00000002.npz",
                                       "ckpt_00000004.npz"]:
            raise AssertionError(f"checkpoint: files {files}")
        with open(files[-1], "r+b") as f:
            f.truncate(sizes[-1] // 2)
        code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
                "import chip_smoke; chip_smoke.resume_run(sys.argv[3:])")
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(src),
                              *argv], capture_output=True, text=True,
                             timeout=600)
        child_s = time.perf_counter() - t
        if out.returncode:
            raise AssertionError(f"checkpoint: the resumed process failed "
                                 f"(rc {out.returncode}):\n{out.stderr[-4000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        want = expected_launches(argv, steps=2)
        want_coll = sync_collectives(argv) * _backwards(argv, 2)
    print(f"checkpoint: npz {sizes[0]:,} bytes per save; saves "
          f"{', '.join(f'{x:.2f}' for x in save_s)} s; restore "
          f"{got['restore_s'][0]:.2f} s in a new process ({child_s:.1f} s "
          f"for the process); restored step {got['start']}; losses "
          f"{got['losses']} vs uninterrupted {full['losses'][2:]}",
          flush=True)
    if got["start"] != 2 or got["losses"] != full["losses"][2:]:
        raise AssertionError("checkpoint: the resumed run's losses differ "
                             "from the uninterrupted run's steps 2-3")
    if got["launches"] != want or got["collectives"] != want_coll:
        raise AssertionError(f"checkpoint: the resumed run launched "
                             f"{got['launches']} and {got['collectives']} "
                             f"collectives, want {want} and {want_coll}")
    _add(total, got["launches"])
    return total


KERNEL_NAMES = tuple(name for name, _, _ in KERNEL_ROWS)


def _kernel_class(name: str) -> str:
    low = name.lower()
    if any(k in low for k in KERNEL_NAMES):
        return "kernels (this repo)"
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas")):
        return "matmul (cuBLAS)"
    if "copy" in low or low.startswith("memcpy"):
        return "dtype copies and memcpy"
    return "other (elementwise, reductions, fills)"


def profile_phase(argv) -> None:
    """Where one full-width step spends device time: median wall time of
    two unprofiled steps, then one step under torch.profiler.  Device busy
    time is the sum of its kernels, memcpys and memsets (``is_device_work``);
    the GPU-side ``loco/*`` annotation ranges span that work, so they are
    printed apart, with the sum that also counted them.  Informational: an
    empty trace is reported, not failed.  Returns the step's ``wall_ms``
    and ``busy_ms``."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.flatparam import MeshTopo
    from repro_torch.data.synthetic import DataConfig, make_batch_fn
    from repro_torch.launch import mesh, steps, train

    args = train.build_args(argv)
    cfg, run = train.make_cfg(args), train.make_run(args)
    dev = torch.device("cuda", 0)
    shape = ShapeConfig("smoke", args.seq_len, args.global_batch, "train")
    batch_fn = make_batch_fn(DataConfig(cfg.vocab, args.seq_len,
                                        args.global_batch, args.seed))
    tag = (f"profile[{cfg.name}{' bucketed' if run.wants_buckets() else ''}"
           f"{' telemetry' if run.telemetry else ''}]")
    with mesh.dp_group(dev) as group:
        topo = MeshTopo.from_group(group, model=mesh.model_group())
        ts = steps.make_init(cfg, run, topo, dev, args.seed)
        step_fn = steps.make_train_step(cfg, run, topo, dev, shape)
        walls = []
        for s in range(3):
            t = time.perf_counter()
            float(step_fn(ts, s, batch_fn(s))["loss"])
            walls.append(time.perf_counter() - t)
        wall_ms = statistics.median(walls[1:]) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            float(step_fn(ts, 3, batch_fn(3))["loss"])
        del ts
    torch.cuda.empty_cache()
    events = prof.key_averages()
    work = [e for e in events if is_device_work(e)]
    annotations = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in work) / 1e3
    counted_ms = busy_ms + sum(e.self_device_time_total
                               for e in annotations) / 1e3
    print(f"{tag}: step {wall_ms:.1f} ms unprofiled (median of 2, "
          f"{args.global_batch * args.seq_len / wall_ms * 1e3:.0f} tok/s); "
          f"device busy {busy_ms:.1f} ms in the profiled step "
          f"({sum(e.count for e in work)} kernels, memcpys and memsets); "
          f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}; a sum "
          f"that also counts the GPU-side annotation ranges gives "
          f"{counted_ms:.1f} ms", flush=True)
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms}
    if not work:
        print(f"{tag}: the profiler saw no device time", flush=True)
        return out
    by_class: dict[str, list] = {}
    for e in work:
        c = by_class.setdefault(_kernel_class(e.key), [0.0, 0])
        c[0] += e.self_device_time_total / 1e3
        c[1] += e.count
    for c, (ms, count) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"{tag}: {c}: {ms:.1f} ms x{count} ({ms / busy_ms:.1%} of "
              f"busy)")
    for e in sorted(work, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"{tag}: kernel {e.key[:90]} x{e.count}: "
              f"{e.self_device_time_total / 1e3:.2f} ms")
    for e in work:
        if any(k in e.key.lower() for k in KERNEL_NAMES):
            print(f"{tag}: kernel {e.key[:60]} x{e.count}: "
                  f"{e.self_device_time_total / 1e3:.2f} ms")
    for e in events:
        if not e.key.startswith("loco/"):
            continue
        if e.device_type == DeviceType.CUDA:
            print(f"{tag}: annotation {e.key} x{e.count}: GPU-side span "
                  f"{e.device_time_total / 1e3:.1f} ms (not device work)")
        else:
            print(f"{tag}: range {e.key} x{e.count}: host "
                  f"{e.cpu_time_total / 1e3:.1f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on small models
# ---------------------------------------------------------------------------

def _ref_args(arch, sync, *extra):
    return ["--arch", arch, "--reduced", "--sync", sync, "--seq-len", "32",
            "--global-batch", "8", "--microbatch", "2", "--steps", "3",
            "--warmup", "2", "--lr", "2e-3", "--log-every", "1", *extra]


# The reduced model's own mix: at dp = 1 a 0.1 MiB bucket is 26,112
# elements, so every tensor keeps one fp tail (13,312 elements for the
# attention weights, 512 for the MLP, the embedding and the head) and the
# embedding runs at loco8 (path d's min=1048576 would send every bucket of
# the reduced model to fp).
REF_RUNS = {"llama2-400m loco": _ref_args("llama2-400m", "loco"),
            "deepseek-v3-moe loco block8": _ref_args(
                "deepseek-v3-moe", "loco", "--moe-a2a", "block8"),
            "llama2-400m onebit": _ref_args("llama2-400m", "onebit"),
            "llama2-400m loco bucketed mix": _ref_args(
                "llama2-400m", "loco", "--bucket-mb", "0.1", "--policy",
                "embed=loco8,min=16384"),
            **{f"llama2-400m loco {' '.join(flags)}": _ref_args(
                "llama2-400m", "loco", *flags) for flags in (
                    ("--optimizer", "sgd"), ("--optimizer", "lamb"),
                    ("--optimizer", "adafactor"), ("--quant-mode", "fixed"),
                    ("--error-codec", "bf16"))}}
REF_STEP0_RTOL, REF_ATOL = 2e-3, 2e-2
UNIFORM_BUCKETS = ["--bucket-mb", "0.0625"]
# three microbatches per step: the step's gradient and loss means divide
# by 3, which torch on CUDA would compute as a multiply by 1/3
ACCUM3_ARGS = _ref_args("llama2-400m", "loco") + ["--global-batch", "12",
                                                  "--microbatch", "4"]


def check_divisions() -> None:
    """The step's divisions on the card give the CPU's bits: ``comm.divide``
    at 3 and 6 (the dp x tp loss divisor, the clip's ``s2 / tp``) and
    ``steps._grads`` at accum 3 (the microbatch mean).  A multiply by the
    inverse, what torch on CUDA makes of a division by a Python scalar,
    must differ there, or this check could not see the fault."""
    import torch
    from repro_torch.core.comm import divide
    from repro_torch.core.flatparam import ParamGroup, ParamInfo
    from repro_torch.launch.steps import _grads

    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(3))
    xc = x.cuda()
    for n in (3, 6):
        got = divide(xc, n)
        if not torch.equal(got.cpu(), divide(x, n)):
            raise AssertionError(f"reference: divide by {n} on the card is "
                                 "not the CPU's")
        if torch.equal(xc / n, got):
            raise AssertionError(f"reference: x / {n} on the card already "
                                 "gives IEEE division; the check sees "
                                 "nothing")
    groups = [ParamGroup("block", (ParamInfo("w", (8, 512)),), n_layers=2),
              ParamGroup("embed", (ParamInfo("tok", (8, 512)),))]

    def leaves(device):
        out, rows = {}, iter(x[:3 * 4096].reshape(3, 4096))
        for g in groups:
            ts = [torch.zeros(4096, device=device, requires_grad=True)
                  for _ in range(g.n_layers or 1)]
            for t in ts:
                t.grad = next(rows).to(device)
            out[g.name] = {g.infos[0].name: ts if g.stacked else ts[0]}
        return out

    cpu, card = _grads(leaves("cpu"), groups, 3), _grads(leaves("cuda"),
                                                         groups, 3)
    same = all(torch.equal(card[g][k].cpu(), cpu[g][k])
               for g in cpu for k in cpu[g])
    print(f"reference: divide at 3 and 6 and the accum-3 gradient mean on "
          f"the card: {'bit for bit with the CPU' if same else 'DIFFER'}; "
          f"a multiply by the inverse differs", flush=True)
    if not same:
        raise AssertionError("reference: the accum-3 gradient mean on the "
                             "card is not the CPU's")


def reference_phase() -> None:
    """Same seed, same batches, same weights (the init draws on the CPU):
    the card's run (CUDA kernels, NCCL, cuBLAS) must track the CPU run
    (plain versions, gloo) within the port's model-level tolerance; and on
    the card, the bucketed sync under a uniform policy must give the
    monolithic run's losses bit for bit."""
    from repro_torch.launch import train

    check_divisions()
    mono = train.main(REF_RUNS["llama2-400m loco"]
                      + ["--device", "cuda"])["losses"]
    buck = train.main(REF_RUNS["llama2-400m loco"] + UNIFORM_BUCKETS
                      + ["--device", "cuda"])["losses"]
    print(f"reference: reduced llama2-400m loco on the card, "
          f"{' '.join(UNIFORM_BUCKETS)} uniform {buck} vs monolithic {mono}",
          flush=True)
    if buck != mono:
        raise AssertionError("reference: the uniform bucketed run's losses "
                             "differ from the monolithic run's on the card")
    for label, argv in {**REF_RUNS, "llama2-400m loco, accum 3":
                        ACCUM3_ARGS}.items():
        gpu = (mono if label == "llama2-400m loco" else
               train.main(argv + ["--device", "cuda"])["losses"])
        cpu = train.main(argv + ["--device", "cpu"])["losses"]
        gaps = [abs(a - b) for a, b in zip(gpu, cpu)]
        print(f"reference: reduced {label}, card {gpu} vs cpu {cpu}; "
              f"gaps {gaps}; "
              f"{'bit for bit' if gpu == cpu else 'within the loss limits'}",
              flush=True)
        if not (gaps[0] <= REF_STEP0_RTOL * abs(cpu[0])
                and max(gaps) <= REF_ATOL):
            raise AssertionError(f"reference: {label}: the card's losses "
                                 f"left the CPU run's (step 0 rtol "
                                 f"{REF_STEP0_RTOL}, all steps atol "
                                 f"{REF_ATOL})")


if __name__ == "__main__":
    sys.exit(main())
