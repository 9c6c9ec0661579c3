#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card; all phases
    python3 chip_smoke.py --profile-only [--src OTHER/src]   # traces only
    python3 chip_smoke.py --serve-only [v,w,x]   # serving (or paths v-x)

Phases, in order; any failure exits non-zero and prints no result:

1. print the card (``nvidia-smi`` name and power limit) and build every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` with nvcc (one process per
   source, all at once);
2. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit: ``fused_compress``/``dequant_mean`` at every segment length
   the llama2-400m, deepseek-v3-moe and bucketed llama2-400m LoCo backwards
   and those of paths k-o give them (derived from the parameter
   declarations, the sync plans and the overlap schedules, ``sync_runs``;
   262,144 to 469,762,048 elements on k and l, 163,840 to 128,716,800 on
   m-o) in every variant of their
   interface (f32 or bf16 gradient, error out of place or in place, f32 or
   bf16 shard, D = 1, 2, 4, 8), ``fused_compress`` in place into the run
   error views of path d's stage pieces, ``act_encode``/``act_decode`` at the
   deepseek-v3-moe and qwen3-moe-30b-a3b exchanges (81,920 rows of 512
   both, ``act_row_counts``) and at path u's prefill and decode-step
   exchanges (163,840 and 256 rows), ``onebit_pack`` at the
   onebit path's shapes; all of the LoCo and activation kernels also at
   the TP-local shapes a rank of a tp = 2 model group gives them at full
   width (from ``build_groups(cfg, 2)`` and the sync plans: 524,288,
   1,441,792 and 16,384,000 elements on llama2-400m, 131,072 and
   16,777,216 on deepseek-v3-moe; 40,960 rows of the exchange), which the
   one card cannot train; then each kernel's
   device time (torch.profiler)
   and host time per call beside its HBM bound, the plain version's device
   time and, for ``act_decode``, the one PyTorch call that computes the same
   function; the attention kernels (``attention_fwd``, ``attention_bwd_dq``,
   ``attention_bwd_dkdv``) at h2o-danube-1.8b's and mixtral-8x7b's training
   attention shapes (ATTN_SHAPES): output and gradients against the plain
   path within ATTN_PLAIN_RTOL, each kernel's device and host time beside
   its bound (operations at the bf16 peak), its plain version's time and
   ``scaled_dot_product_attention``'s (the yardstick; the port never calls
   it);
3. train, the main paths through ``repro_torch.launch.train`` on a
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
   h. full-width llama2-400m, ``--sync topk`` (1% of each 512-block, no
      kernel: plain torch ops), 3 steps, profiled at step 2: losses
      finite, no loco kernel launched, ``loco/encode``'s device time and
      the peak memory printed;
   h'. full-width llama2-400m bucketed with ragged top-k buckets,
      ``--bucket-mb 4 --policy "embed=loco8,body=loco4+topk1%,
      min=1048576" --no-overlap``, 3 steps: the ragged leaves through the
      coalesced packing, ``fused_compress`` launched by bit width as the
      plan derives it;
   i. path a's command with ``--fidelity-every 3 --metrics-jsonl``
      (probes at steps 2 and 5): path a's losses bit for bit; its
      launches and collectives, less the probes' derived ones (per probe
      backward and LoCo tensor one more ``fused_compress``, two more
      ``dequant_mean`` and one reference reduce-scatter), path a's; two
      ``fidelity`` records with
      finite global cosine, relative L2 and compensation gain, printed
      with the peak memory, the unprofiled probe step's time against the
      other steps' and the device busy time and launches of probe step
      5, traced;
   j. path b's command with ``--moe-a2a block8+ef`` (the combine's error
      feedback), 3 steps: losses finite and falling, step 0 within 2e-3
      relative of path b's (its second microbatch reads the first's
      residual), ``act_encode`` and ``act_decode`` launched as derived
      (the residual's local decode twice more per layer and microbatch),
      the peak memory printed;
   k. qwen3-moe-30b-a3b at full width (d_model 2048, 32 x 128 heads over 4
      kv heads, qk-norm, 128 experts of d_ff 768 top-8, ``ep_a2a``, vocab
      151,936), 2 of 48 layers, ``--sync loco --moe-a2a block8``,
      microbatch 2, 3 steps, step 2 traced;
   l. mixtral-8x7b at full width (d_model 4096, GQA 32/8, 8 experts of
      d_ff 14,336 top-2, ``tp_dense``, sliding window 4,096, which seq 1024
      does not cut), 1 of 32 layers, ``--sync loco``, microbatch 2, 3
      steps, step 2 traced;
   m. mamba2-2.7b at full width (d_model 2,560, d_inner 5,120, 80 heads
      of 64, state 128, conv 4, vocab 50,280), M_LAYERS of 64 layers,
      ``--sync loco``, microbatch 4, 3 steps, step 2 traced;
   n. zamba2-2.7b at full width (state 64, a shared block of 32 heads and
      d_ff 10,240 after every 6 mamba layers), 12 of 54 layers: two
      super-blocks, so the shared block's gradient sums over two
      applications before its one sync per microbatch; as m otherwise;
   o. whisper-small whole (12 + 12 layers, d_model 768, vocab 51,865) on
      1,500 frames (its 30 s window) and 512 decoder tokens, as m
      otherwise; k-o print their parameters, peak memory (under
      WIDE_PEAK_GIB), tok/s (o: decoder tokens, and frames/s), step 2's
      device busy time and the idle share;
   losses finite (and falling on a, b, d, k-o), every kernel of the path
   launched as often as the code says (counts derived from the parameter
   declarations, the sync plan's encode runs or stage pieces and the
   layer structure, below; the attention kernels per attention layer,
   ``attention_calls``), split by bit width, and the bucketed sync's
   packed collectives as many as its schedule has groups; each path gives
   its recorded losses bit for bit (``PARENT_LOSSES``, recorded on the
   card once Adam divided and took its root as the CPU does, and once
   the GQA kv expansion's backward was deterministic), and no
   model-group collective or ``replicated_grad_psum`` is called;
3b. checkpoint: path d's command at full width, cut to CKPT_LAYERS layers:
   4 steps; the same 4 steps saving every 2 (``--ckpt-dir``,
   ``--ckpt-every 2``; the same losses); the step-4 file cut short; a new
   process resumes from step 2 and its steps 2-3 give the uninterrupted
   run's losses bit for bit (npz size, save and restore times printed);
3c. hierarchical: ``comm.hierarchical_sync`` called on the card directly
   over size-1 ``(pod, data)`` and ``(wan, pod, data)`` groups (NCCL puts
   no two ranks on one card, so ``--pods 2`` cannot launch here), at path
   a's largest LoCo length (32,768,000) and at a tp = 2 rank's
   (16,384,000), for four schedules: loco4 -> naive8 (``hierarchical``),
   loco4 -> naive4 (``+hier4``), loco8 -> naive8 -> topk 25% (3 tiers)
   and onebit -> naive8, each also with the fidelity probe at the
   smaller length; every shard,
   new state and reference stack bit for bit with the same call on the
   CPU (plain versions, gloo), and each kernel launched as often as the
   schedule's legs (and the probe's roundtrips) derive;
3d. serve: ``python -m repro_torch.launch.serve`` at full width and
   depth, random weights from seed 0, greedy, the KV caches sized to the
   whole generation, decode step 3 traced, the launch counters zeroed
   just before each path and read just after:
   p. llama2-400m, batch 8 x prompt 1,024, 128 decode steps (dense KV);
   q. mamba2-2.7b, all 64 layers, 8 x 1,024, 128 (conv and SSM states);
   r. h2o-danube-1.8b, 2 x 4,096, 64: its 4,096-token sliding window,
      whose ring wraps from the first decoded token (checked);
   s. whisper-small, 12 + 12 layers, 8 x 1,500 frames, 128 (the encoder
      once, then self-attention KV and cross-attention);
   t. zamba2-2.7b, all 54 layers, 8 x 1,024, 128 (9 shared-block KV
      caches beside 54 conv/SSM states);
   u. deepseek-v3-moe, all 12 layers, its ``block8`` wire, 8 x 1,024,
      128: ``act_encode`` and ``act_decode`` on every dispatch and combine,
      launched 2 x 12 times per prefill and per decode step as derived
      (``serve_expected_launches``);
   q', t'. q and t cut to 4 and 6 layers (one super-block) at full width,
      where the rounding has fewer mixers to grow through;
   v. llama2-400m, batch 1 x prompt 32,768 (the reference's prefill_32k
      length), 16 decode steps: the prefill in query tiles of 512-key
      blocks (``common.prefill_attention``);
   w. gemma2-27b at full width cut to W_LAYERS = 4 layers (two 4,096-token
      windows, two global; soft cap 50, GQA 32/16), as v otherwise;
   x. mamba2-2.7b, all 64 layers, as v otherwise: the SSD scan in groups
      of 16 chunks of 256 steps, the conv caches their own (1, 3, ch);
   v and w hold (a) layer 0's attention over the 32,768 keys, in query
      tiles, to the untiled call bit for bit (both timed) and at its last
      LONG_ROWS query rows to the one-block formula within ATTN_RTOL of
      their mean |output|, that formula with one 512-key block left out
      beyond it; (b) the run's own prefill and 16 decode steps to one
      prefill over the prompt and the generated tokens within
      LONG_DECODE_LIMIT (largest and mean gap), one more step from the
      final caches with their position one stale beyond the mean's
      limit; (c) their peak memory to their
      prefill's dry run (phase 5 (d)); (d) their tokens to
      ``PARENT_TOKENS``; each prints the card beside its times and peak;
   x holds (a) layer 0's SSD scan over the prompt, in groups, to the
      whole form (every chunk in one group) within SCAN_RTOL of the mean
      |Y|, both timed with their peaks, one group from a zero state beyond
      it; (b) its 16 decode steps to one prefill of the generated tokens
      from a copy of a fresh prefill's caches (the continuation), within
      q's limits on their floor (the continuation with the scan in chunks
      of one step), and a first step from conv contexts one token stale
      beyond the median's; (c) every conv cache, after the prefill and
      after the decode, owns only its (B, K-1, ch) storage; (d) and its
      peak and tokens as v's;
   on p-t the uncached forward over the prompt and the generated tokens
   (teacher-forced) gives every decoded position's logits within
   SERVE_FWD_LIMIT on p and r, and on s, q, t, q' and t', the largest
   within SERVE_FLOOR_FACTOR and the median step within
   SERVE_MEDIAN_FACTOR times the forward's own rounding floor at those
   shapes (the forward over a shorter sequence against the forward over
   the longer one; argmax agreement printed, not asserted: random
   weights give near ties); on q, t, q' and t' a first decode step whose
   conv contexts are one token stale leaves the forward by more than the
   median's limit (the check sees a wrong cache); every path's tokens
   in range and equal to
   its recorded ones (``PARENT_TOKENS``, a digest); no model-group
   collective called; each prints its parameters, peak memory, prefill
   time and tok/s, decode tok/s and median ms per step, and the traced
   step's device busy time, launches and idle share;
4. reference: reduced llama2-400m (loco, onebit, and loco bucketed with
   ``--bucket-mb 0.1 --policy "embed=loco8,min=16384"``) and reduced
   deepseek-v3-moe (loco, block8) train 3 steps on the card and on the CPU
   (plain versions, gloo); the losses agree within 2e-3 relative at step 0
   and 2e-2 at every step; so does reduced llama2-400m at
   ``--global-batch 12 --microbatch 4`` (three microbatches: the step's
   means divide by 3), and reduced llama2-400m with ``--optimizer sgd``,
   ``lamb`` and ``adafactor``, ``--quant-mode fixed`` and
   ``--error-codec bf16``, reduced llama2-400m ``--sync topk``, reduced
   llama2-400m ``--fidelity-every 1`` (whose fidelity metrics must also
   agree: the global cosine within 1e-4, the others within 5e-2
   relative) and
   reduced deepseek-v3-moe ``--moe-a2a block8+ef``, and the pool's other
   attention decoders reduced (mixtral-8x7b, qwen3-moe-30b-a3b with
   block8, gemma2-27b, minicpm-2b, h2o-danube-1.8b, command-r-35b,
   chameleon-34b; seq 128 for the windowed ones, so the window cuts),
   and the state-space, hybrid and audio families reduced (mamba2-2.7b
   and zamba2-2.7b at seq 32 and at seq 128, one SSD chunk of 128 steps,
   whose gradient only the exp masked before it keeps finite;
   whisper-small at 32 frames and 32 decoder tokens), printed as bit for
   bit or within the limits (and for gemma2, minicpm
   and command-r whether step 0 is bit for bit); their scales and soft
   caps give the CPU's bits on the card (``check_scales_exact``);
   reduced deepseek-v3-moe at one microbatch
   per step gives block8's step-0 loss under block8+ef bit for bit;
   lamb, adafactor and adafactor_flat updates and the step's gradient
   norm and clip scale give the CPU's bits on the card;
   the step's divisions (``comm.divide`` at 3 and 6, the accum-3 gradient
   mean) give the CPU's bits on the card; gemma2's decode-step soft cap on
   bf16 logits gives the CPU's bits; reduced llama2-400m, gemma2-27b,
   h2o-danube-1.8b (prompt 64 into its 64-token window: the ring wraps),
   deepseek-v3-moe, mamba2-2.7b, zamba2-2.7b and whisper-small serve a
   prompt and 8 decode steps on the CPU and, teacher-forced on the CPU's
   tokens, on the card: every step's logits within SERVE_REF_ATOL, and
   the card's greedy token the CPU's wherever the CPU's top-2 margin
   exceeds it.  The CPU's side of these runs goes to worker processes
   (``cpu_pool``) while the main process drives the card's.  On
   the card, reduced llama2-400m with
   ``--bucket-mb 0.0625`` under a uniform policy gives the monolithic
   run's losses bit for bit.
5. dryrun: two spawned worker processes, started once the train phase
   is done (a fake CUDA tensor creates its process's CUDA context, for
   which paths k-m leave no room), run ``launch/dryrun``'s
   ``dryrun_one`` on fake tensors while the main process drives the
   card; the phase reads them after the reference phase and checks the
   card's total memory against ``analysis/roofline.HBM_BYTES``: (a)
   path a's command on fake CUDA tensors predicts path a's run: its
   kernel launches and collectives per step exactly, its peak memory
   within DRYRUN_PEAK_RTOL of ``max_memory_allocated``, and a roofline
   bound (H100 constants) no longer than the traced step's device busy
   time, its dispatched ops printed beside the trace's launches; (b) the
   reference dry run's cells llama2-400m ``train_4k`` at 16 x 16 and
   mixtral-8x7b ``train_4k`` at 2 x 16 x 16 with ``--fidelity-every 4``
   (qwen3-moe-30b-a3b's takes twice as long, MOE_DRYRUN) finish on fake
   CUDA tensors with ``torch.cuda.memory_allocated()`` moved by under 1
   MiB, their record lines printed; (c) path a's command on fake CPU
   tensors gives (a)'s ops, FLOPs, bytes, collectives and kernels; (d)
   the prefill of serve paths v, w and x (their model, batch and prompt
   at world 1) on fake CUDA tensors predicts each path's peak memory
   within DRYRUN_PEAK_RTOL (``--serve-only`` runs these dry runs beside
   the serve phase; ``--serve-only v,w,x`` runs only those paths).

Where the time goes is read from traces inside the train phase, not from
models built to profile: paths a, b and the first d trace step 2 (as e,
k-o do) and print its device busy time by kernel class, the longest
kernels, the idle share against the unprofiled steps and the ``loco/*``
ranges (per overlap stage on d); e's traced step against a's gives the
telemetry's cost; the exact gradient norm's device time on path b's
shapes follows the paths.  ``--profile-only`` builds the kernels and runs
paths a and b for 3 steps, step 2 traced, from ``--src`` (to compare two
commits in one call).  Each phase prints its wall time, and the last
``done:`` line all of them.

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


def _train_args(arch, sync, steps, *extra, micro: int = 4):
    return ["--arch", arch, "--sync", sync, "--seq-len", "1024",
            "--global-batch", "8", "--microbatch", str(micro),
            "--steps", str(steps), "--warmup", "1", "--log-every", "1",
            *extra]


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
# Paths h and h': the top-k codec (no kernel), flat and as ragged buckets
# beside loco8 ones on the coalesced flat schedule (top-k buckets cannot
# ride the pipelined one).
H_ARGS = _train_args("llama2-400m", "topk", 3, "--profile-steps", "2:2")
H2_ARGS = _train_args("llama2-400m", "loco", 3, "--bucket-mb", "4",
                      "--policy", "embed=loco8,body=loco4+topk1%,"
                      "min=1048576", "--no-overlap")
# Path i: path a's command (6 steps: the cosine schedule spans --steps, so
# a shorter run's learning rates are not path a's) with a fidelity probe
# at steps 2 and 5 (the stream adds a fidelity record per probe; step 5 is
# traced); path j: path b's command with the combine's error feedback, 3
# steps.
I_ARGS = TRAIN_ARGS + ["--fidelity-every", "3", "--metrics-every", "1",
                       "--profile-steps", "5:5"]
J_ARGS = _train_args("deepseek-v3-moe", "loco", 3, "--moe-a2a", "block8+ef")
# Paths e-g: the telemetry on paths a and b, and the other optimizers and
# schedules.  Each run adds its --metrics-jsonl / --profile-dir paths.
TELEMETRY_FLAGS = ["--telemetry", "--metrics-every", "1"]
# Paths a, b and the first d trace step 2 (the breakdown of where the time
# goes, ``print_trace``), as e and k-o do.
PROFILE_FLAGS = ["--profile-steps", "2:2"]
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
# Paths k and l: the pool's two other MoEs at full width, cut in depth
# (``cut_depth``: dataclasses.replace on the CLI's config), microbatch 2
# (the 151,936-token vocabulary's f32 logits are 1.2 GB per 2,048 tokens);
# step 2 traced.  qwen3-moe-30b-a3b: 2 of 48 layers, 1,868,573,184
# parameters, qk-norm, 128 experts top-8 on the block8 wire; mixtral-8x7b:
# 1 of 32 layers, 1,713,418,240 parameters, 8 experts top-2 (tp_dense),
# sliding window 4,096 (which seq 1024 does not cut; the reference phase
# runs it where it cuts).
# Paths m-o: the state-space, hybrid and audio families at full
# width, microbatch 4, 3 steps, step 2 traced.  mamba2-2.7b: M_LAYERS of 64
# layers (40,211,184 parameters each, 6 LoCo tensors), the deepest cut
# whose peak stays under 72 GiB; zamba2-2.7b: 12 of 54 layers, two
# super-blocks of 6, so the shared attention block is applied, and its
# gradient summed, twice before its one sync; whisper-small whole (12 + 12
# layers) on 1,500 frames (its 30 s window) and dec_len 512 tokens.  m's
# peak grows 1.58 GiB per layer from 8.95 GiB (run AP, 12 and 30 layers):
# 39 layers peaked at 70.61 GiB (AS), 40 would pass 72.
M_LAYERS = 39
WIDE_PATHS = {
    "k": (_train_args("qwen3-moe-30b-a3b", "loco", 3, "--moe-a2a", "block8",
                      "--profile-steps", "2:2", micro=2), 2),
    "l": (_train_args("mixtral-8x7b", "loco", 3, "--profile-steps", "2:2",
                      micro=2), 1),
    "m": (_train_args("mamba2-2.7b", "loco", 3, "--profile-steps", "2:2"),
          M_LAYERS),
    "n": (_train_args("zamba2-2.7b", "loco", 3, "--profile-steps", "2:2"),
          12),
    "o": (_train_args("whisper-small", "loco", 3, "--profile-steps", "2:2",
                      "--seq-len", "1500"), None)}
# Each MoE layer exchanges its slot buffer twice (dispatch, combine); each
# exchange runs once in the forward, once in the checkpoint's recomputation
# and once in the backward (the cotangent rides the same wire), and calls
# act_encode and act_decode once each time.
EXCHANGES_PER_MOE_LAYER = 2 * 3
# block8+ef: the combine's forward and its recomputation also decode the
# local codes once each for the residual
EF_DECODES_PER_MOE_LAYER = EXCHANGES_PER_MOE_LAYER + 2


def _plan(argv, tp: int = 1):
    """(RunConfig, sync plan at dp = 1) of the training run ``argv`` on a
    rank of a ``tp``-way model group (its TP-local tensors): the
    monolithic plan (one run per LoCo tensor) without --bucket-mb/--policy."""
    import types

    from repro_torch.core import buckets
    from repro_torch.launch import steps, train

    args = train.build_args(argv)
    run = train.make_run(args)
    groups = steps.model_groups(train.make_cfg(args), tp)
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
    embedding and the head).  Top-k runs are not counted: that codec has
    no kernel."""
    run, plan = _plan(argv, tp)
    out: dict[tuple[int, int], int] = {}
    for pp in plan.params:
        for u in sync_units(run, pp):
            # top-k encodes with plain torch ops: no kernel
            if u.sync.needs_state() and u.sync.strategy != "topk":
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
    llama overlapped and flat; the checkpoint phase runs path d; at tp =
    1 also paths k-o) launch fused_compress and dequant_mean at, on a
    rank of a ``tp``-way model group.  (A length does not depend on the
    depth that paths k-n cut.)"""
    paths = [TRAIN_ARGS, MOE_ARGS, BUCKET_ARGS, FLAT_ARGS]
    if tp == 1:
        paths += [argv for argv, _ in WIDE_PATHS.values()]
    return sorted(set().union(*(loco_sizes(a, tp) for a in paths)))


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
    # D peers of n / D elements each, where a dp = D run's chunks would
    # be that long (a multiple of 512)
    runs = [(n, COMPRESS_CELLS, tuple(D for D in (1, 2, 4, 8)
                                      if n % (D * 512) == 0))
            for n in kernel_sizes()]
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

def moe_exchange_rows(argv, tp: int = 1) -> int:
    """Rows of 512 that one exchange of the MoE training run ``argv``
    quantizes on a rank of a ``tp``-way model group (its ``tp`` peer rows
    of El experts x cap slots x d_model, for microbatch x seq tokens):
    deepseek-v3-moe (path b, microbatch 4) 64 x 640 x 1024 / 512 = 81,920
    at tp = 1, 2 x 32 x 320 x 1024 / 512 = 40,960 at tp = 2;
    qwen3-moe-30b-a3b (path k, microbatch 2) 128 x 160 x 2048 / 512 =
    81,920 too."""
    from repro_torch.core import act_comm
    from repro_torch.launch import train

    args = train.build_args(argv)
    g = act_comm.a2a_geometry(train.make_cfg(args),
                              args.microbatch * args.seq_len, tp)
    return tp * g["n_pad"] // act_comm.ACT_BLOCK


def act_row_counts() -> dict[tuple[int, int], list[str]]:
    """(rows, tp) -> the block8 exchanges of that size: paths b and k at
    tp = 1, path b on a tp = 2 rank, path u's prefill and decode step."""
    out: dict[tuple[int, int], list[str]] = {}
    for label, argv, tp in (("deepseek-v3-moe", MOE_ARGS, 1),
                            ("qwen3-moe-30b-a3b", WIDE_PATHS["k"][0], 1),
                            ("deepseek-v3-moe", MOE_ARGS, TP_LOCAL)):
        out.setdefault((moe_exchange_rows(argv, tp), tp), []).append(label)
    for label, prefill in (("path u prefill", True),
                           ("path u decode step", False)):
        rows = serve_exchange_rows(SERVE_PATHS["u"], prefill)
        out.setdefault((rows, 1), []).append(label)
    return out


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


def kernel_act(AQ, dev, rate: float, rows: int, tp: int,
               label: str) -> dict:
    """act_encode / act_decode at an exchange of ``rows`` rows of 512 (the
    MoE models ``label`` on a rank of a ``tp``-way model group):
    bit-exact against the plain versions (and the decode against ``q /
    scale``), then timed per call."""
    import torch

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
        print(f"kernels: {name} rows={rows} ({label}, tp {tp}) bit-exact; "
              f"device "
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


# the benchmark's training attention shapes (B, S, H, hd, window); the
# first gives the JSON row's times
ATTN_SHAPES = {"h2o-danube-1.8b": (4, 2048, 32, 80, 4096),
               "mixtral-8x7b": (2, 1024, 32, 128, 4096)}
# the kernels' output and gradients against the plain path's, relative L2
# (0.6-3.7e-3 measured on unit-normal inputs, PERF.md)
ATTN_PLAIN_RTOL = 1e-2
PEAK_FLOPS = 989.4e12   # bf16, dense: analysis/roofline.py, bench/peaks.json


def kernel_attention(dev) -> dict:
    """The attention kernels at ATTN_SHAPES: the output and dq, dk, dv of
    a forward and backward against the plain path's (blockwise attention
    with every key in one block, differentiated by autograd) within
    ATTN_PLAIN_RTOL; then per kernel its device time per call
    (torch.profiler), host time per call, bound (its operations at the
    bf16 peak: 4, 6 and 8 hd per visible pair), its plain version's
    device time, and as the yardstick the port never calls, PyTorch's
    ``scaled_dot_product_attention``: its forward beside attention_fwd, its
    whole backward beside attention_bwd_dq (the two backward kernels
    together do that work)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as KA

    out = {}
    for label, (B, S, H, hd, w) in ATTN_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(4)
        q, k, v, g = (torch.randn(B, S, H, hd, generator=gen, device=dev,
                                  dtype=torch.bfloat16) for _ in range(4))
        res = []
        for fn in (KA.attention, KA.attention_plain):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            o = fn(*xs, w)
            o.backward(g)
            res.append([o.detach()] + [x.grad for x in xs])
        torch.cuda.synchronize()
        errs = {n: float((a.float() - b.float()).norm() / b.float().norm())
                for n, a, b in zip(("out", "dq", "dk", "dv"), *res)}
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(*res))
        del res
        if max(errs.values()) > ATTN_PLAIN_RTOL:
            raise AssertionError(f"kernels: attention at {label}'s shape "
                                 f"against the plain path: {errs}")
        o, lse = KA.attention_fwd(q, k, v, w)
        dq, dsum, qs = KA.attention_bwd_dq(q, k, v, o, lse, g, w)
        calls = {
            "attention_fwd": (lambda: KA.attention_fwd(q, k, v, w),
                              lambda: KA.attention_fwd_plain(q, k, v, w)),
            "attention_bwd_dq": (
                lambda: KA.attention_bwd_dq(q, k, v, o, lse, g, w),
                lambda: KA.bwd_dq_plain(q, k, v, o, g, w)),
            "attention_bwd_dkdv": (
                lambda: KA.attention_bwd_dkdv(q, qs, k, v, lse, dsum, g, w),
                lambda: KA.bwd_dkdv_plain(q, k, v, g, w))}
        qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))

        def sdpa(backward: bool):
            xs = [x.detach().requires_grad_(backward) for x in (qt, kt, vt)]
            y = F.scaled_dot_product_attention(*xs, is_causal=True)
            if backward:
                y.backward(gt)

        sdpa_fwd = device_ms(lambda: sdpa(False))
        library = {"attention_fwd": sdpa_fwd,
                   "attention_bwd_dq": device_ms(lambda: sdpa(True))
                   - sdpa_fwd, "attention_bwd_dkdv": None}
        line, ms = [], {}
        for name, (kernel, plain) in calls.items():
            flops = KA.flops(name, q.shape, w)
            t = dict(ms=device_ms(kernel, reps=10, only=name),
                     host_us=host_us(kernel, 1, reps=5),
                     plain_ms=device_ms(plain, reps=1),
                     bound_ms=flops / PEAK_FLOPS * 1e3,
                     library_ms=library[name], max_abs_err=worst)
            line.append(f"{name} {t['ms']:.3f} ms ({flops / t['ms'] / 1e9:.1f}"
                        f" TFLOP/s, bound {t['bound_ms']:.3f} ms), host "
                        f"{t['host_us']:.1f} us, plain {t['plain_ms']:.2f} ms")
            ms[name] = t["ms"]
            out.setdefault(name, t)
        fwd = ms["attention_fwd"]
        bwd = ms["attention_bwd_dq"] + ms["attention_bwd_dkdv"]
        pairs = KA.pairs(S, w) * B * H
        print(f"kernels: attention at {label}'s shape ({B} x {S}, {H} "
              f"heads of {hd}): out, dq, dk, dv against the plain path "
              + ", ".join(f"{e:.2e}" for e in errs.values())
              + " (relative L2); " + "; ".join(line)
              + f"; forward {4 * hd * pairs / fwd / 1e9:.1f} TFLOP/s, "
              f"backward {10 * hd * pairs / bwd / 1e9:.1f} TFLOP/s (4 and "
              f"10 hd per visible pair); sdpa forward {sdpa_fwd:.3f} ms, "
              f"backward {library['attention_bwd_dq']:.3f} ms", flush=True)
        del q, k, v, g, o, lse, dq, dsum, qs, calls
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

KERNEL_ROWS = (  # name, CUDA source, the TPU kernel it replaces, bound
    ("fused_compress", "loco_quant.cu", "src/repro/kernels/loco_quant.py:84",
     "bytes"),
    ("dequant_mean", "loco_quant.cu", "src/repro/kernels/loco_quant.py:172",
     "bytes"),
    ("onebit_pack", "sign_pack.cu", "src/repro/kernels/sign_pack.py:44",
     "bytes"),
    ("act_encode", "act_quant.cu", "src/repro/kernels/act_quant.py:50",
     "bytes"),
    ("act_decode", "act_quant.cu", "src/repro/kernels/act_quant.py:74",
     "bytes"),
    ("attention_fwd", "attention.cu", None, "flops"),
    ("attention_bwd_dq", "attention.cu", None, "flops"),
    ("attention_bwd_dkdv", "attention.cu", None, "flops"),
)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-only", action="store_true",
                    help="build, then run only phase 4 (print no result)")
    ap.add_argument("--serve-only", nargs="?", const="", default=None,
                    metavar="P,Q",
                    help="build, then run only the serve phase (or its "
                         "paths P,Q) and the reference phase's serving runs "
                         "(print no result)")
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
        profile_only(src)
        return 0
    if opts.serve_only is not None:
        from repro_torch.kernels import loco_quant as LQ

        names = opts.serve_only.split(",") if opts.serve_only else None
        t0 = time.perf_counter()
        with dryrun_pool(src) as pool:
            dry = {label: pool.apply_async(_dryrun, (kw,))
                   for label, kw in long_dryrun_jobs(names).items()}
            _, peaks = serve_phase(LQ, names)
            check_long_peaks({label: _dryrun_result(label, fut, t0)
                              for label, fut in dry.items()}, peaks)
        print(f"serve: phase took {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        with cpu_pool(src) as pool:
            serve_reference_runs(submit_serve_cpu(pool))
        print(f"reference: serve runs took {time.perf_counter() - t0:.1f} s",
              flush=True)
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
    acts = {key: kernel_act(AQ, dev, rate, *key, " and ".join(labels))
            for key, labels in act_row_counts().items()}
    # the JSON row's times: path b's exchange
    timing.update(acts[(moe_exchange_rows(MOE_ARGS), 1)])
    for res in acts.values():
        for name, t in res.items():
            timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"],
                                              t["max_abs_err"])
    timing["onebit_pack"] = kernel_onebit(SP, dev, rate)
    timing.update(kernel_attention(dev))
    torch.cuda.empty_cache()
    phase_s = {"build and kernels": time.perf_counter() - t_start}
    print(f"kernels: phase done at {phase_s['build and kernels']:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    launches, path_a = train_phase(LQ)
    time_grad_norm(dev, rate)
    phase_s["train"] = time.perf_counter() - t0
    print(f"train: phase took {phase_s['train']:.1f} s", flush=True)
    with dryrun_pool(src) as pool:
        # the dry runs are host work on fake tensors, in worker processes
        # while the main process drives the card; they start after the
        # train phase because a fake CUDA tensor creates its process's
        # CUDA context, which paths k-m leave no room for
        dry = {label: pool.apply_async(_dryrun, (kw,))
               for label, kw in dryrun_jobs().items()}
        return _late_phases(LQ, dev, src, card, t_start, phase_s, launches,
                            timing, path_a, dry)


def _late_phases(LQ, dev, src, card, t_start, phase_s, launches, timing,
                 path_a, dry) -> int:
    import torch

    t0 = time.perf_counter()
    _add(launches, checkpoint_phase(LQ, src))
    phase_s["checkpoint"] = time.perf_counter() - t0
    print(f"checkpoint: phase took {phase_s['checkpoint']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    _add(launches, hierarchical_phase(LQ, dev))
    phase_s["hierarchical"] = time.perf_counter() - t0
    print(f"hierarchical: phase took {phase_s['hierarchical']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    serve_launches, long_peaks = serve_phase(LQ)
    _add(launches, serve_launches)
    phase_s["serve"] = time.perf_counter() - t0
    print(f"serve: phase took {phase_s['serve']:.1f} s", flush=True)
    missing = [row[0] for row in KERNEL_ROWS if not launches.get(row[0])]
    if missing:
        raise AssertionError(f"train: kernels never launched: {missing}")
    t0 = time.perf_counter()
    reference_phase(src)
    phase_s["reference"] = time.perf_counter() - t0
    print(f"reference: phase took {phase_s['reference']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    dryrun_phase(dry, path_a, long_peaks)
    phase_s["dryrun"] = time.perf_counter() - t0
    print(f"dryrun: phase took {phase_s['dryrun']:.1f} s (waiting for its "
          "worker processes included)", flush=True)

    rows = []
    for name, src, replaces, bound_by in KERNEL_ROWS:
        t = timing[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "host_us": t["host_us"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": bound_by,
                     "library_ms": t["library_ms"]})
    print(f"done: all phases in {time.perf_counter() - t_start:.0f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()) + " s)",
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


def probe_backwards(argv, steps: int | None = None) -> int:
    """Microbatch backwards of the fidelity-probe steps (``step % N == N -
    1`` under ``--fidelity-every N``) among the first ``steps`` steps."""
    from repro_torch.launch import train

    args = train.build_args(argv)
    n, steps = args.fidelity_every, args.steps if steps is None else steps
    probes = sum(1 for s in range(steps) if n and s % n == n - 1)
    return probes * (args.global_batch // args.microbatch)


def expected_launches(argv, steps: int | None = None) -> dict:
    """Launches each kernel of a training run (of ``steps`` steps, default
    all) must make, from the code: per microbatch backward one
    fused_compress and one dequant_mean per stateful encode of the sync
    (one per LoCo tensor on the monolithic path, one per encode run or, on
    the overlapped bucketed schedule, per stage piece; one onebit_pack
    with --sync onebit); on a fidelity-probe step's backward, per such
    encode also the counterfactual's encode from a zero state (one more
    fused_compress or onebit_pack) and the live and counterfactual
    decodes at D = 1 (two more dequant_mean; onebit decodes with plain
    ops); per MoE layer and microbatch EXCHANGES_PER_MOE_LAYER act_encode
    and act_decode, and under block8+ef EF_DECODES_PER_MOE_LAYER
    act_decode; per microbatch two attention_fwd (the forward and its
    remat), one attention_bwd_dq and one attention_bwd_dkdv for each of
    :func:`attention_calls`."""
    from repro_torch.launch import train

    args = train.build_args(argv)
    cfg = train.make_cfg(args)
    loco = sum(launches_by_bits(argv, steps).values())
    per = sum(n for (_, _), n in sync_runs(argv).items())
    probe = per * probe_backwards(argv, steps)
    want = ({"onebit_pack": loco + probe} if args.sync == "onebit" else
            {"fused_compress": loco + probe, "dequant_mean": loco + 2 * probe})
    if cfg.family == "moe" and cfg.moe_a2a_codec in ("block8", "block8+ef"):
        mb = cfg.n_layers * _backwards(argv, steps)
        dec = (EF_DECODES_PER_MOE_LAYER if cfg.moe_a2a_codec == "block8+ef"
               else EXCHANGES_PER_MOE_LAYER)
        want.update(act_encode=EXCHANGES_PER_MOE_LAYER * mb,
                    act_decode=dec * mb)
    att = attention_calls(cfg) * _backwards(argv, steps)
    want.update(attention_fwd=2 * att, attention_bwd_dq=att,
                attention_bwd_dkdv=att)
    return {k: v for k, v in want.items() if v}


def attention_calls(cfg) -> int:
    """Calls of ``common.attention`` that take the attention kernels in one
    microbatch's forward: one per attention layer (a hybrid's per
    application of its shared block, an encoder-decoder's per decoder
    layer: its causal self-attention; the encoder's and the
    cross-attention see every key), where the config's attention has no
    soft cap and a head dim of ``kernels/attention.HEAD_DIMS``.  The
    layer's remat runs each forward again in the backward, and the
    backward runs the dq and the dk/dv kernel once each."""
    from repro_torch.kernels import attention as KA

    if (cfg.family == "ssm" or cfg.attn_softcap is not None
            or cfg.hd not in KA.HEAD_DIMS):
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


@contextlib.contextmanager
def count_sync_collectives():
    """Count the packed collectives the bucketed sync issues (each stage
    of each sync issues its reduce-scatter, all-to-all and all-gather
    through ``core/comm``'s one issuing method, which is wrapped here)."""
    from repro_torch.core import comm

    issued = [0]
    issue = comm._SyncPass.issue

    def counting(self, gplan, wires, fp_segs, **kw):
        inflight = issue(self, gplan, wires, fp_segs, **kw)
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


# What the card gave on every path once Adam divided and took its square
# root as the CPU does (run AD of PERF.md, H100 80GB HBM3, 700 W), b and c
# once the clip's norm summed in f64 and took its root as the CPU does
# (run AG; a, d and the checkpoint run did not move), and b, k and l once
# the GQA kv expansion's backward summed each kv head's gradient in one
# reduction instead of with atomics (run AM; before it, k and l gave other
# losses from step 1 on in every run), and m-o as they first ran (n in run
# AP, m and o in AS, once o's position table folded its constants as XLA
# does), and every path with attention layers (all but m) once training's
# attention took the fused kernels of kernels/attention (run p3): the
# losses each later run must give bit for bit.  (Launches and sync
# collectives are held against the counts derived from the code in
# train_path.)
PARENT_LOSSES = {
    "a": [10.683156967163086, 10.063125610351562, 9.4444580078125,
          9.20425796508789, 8.937742233276367, 8.847794532775879],
    "b": [11.144514083862305, 10.528319358825684, 9.800716400146484,
          9.565072059631348, 9.370445251464844, 9.285581588745117],
    "k": [12.531232833862305, 10.805893898010254, 11.068824768066406],
    "l": [10.823051452636719, 9.44326400756836, 8.813516616821289],
    "m": [11.368759155273438, 11.360269546508789, 11.350048065185547],
    "n": [10.8277006149292, 10.796977996826172, 10.784919738769531],
    "o": [11.149742126464844, 10.374359130859375, 9.83842945098877],
    "c": [10.683156967163086, 10.26899528503418, 9.740604400634766],
    "d": [10.683156967163086, 10.062057495117188, 9.442174911499023],
    "d'": [10.683156967163086, 10.062057495117188, 9.442174911499023]}
PARENT_CKPT_LOSSES = [10.762544631958008, 9.79535961151123,
                      9.225868225097656, 9.016066551208496]


def check_parent(name: str, res: dict, label: str | None = None,
                 want: list | None = None) -> None:
    """The run ``label`` (default: path ``name``) gave path ``name``'s
    parent losses (or ``want``) bit for bit, as far as it ran."""
    got = res["losses"]
    if want is None and name not in PARENT_LOSSES:
        raise AssertionError(f"train: path {name} has no PARENT_LOSSES "
                             f"record; its losses were {got}")
    want = (PARENT_LOSSES[name] if want is None else want)[:len(got)]
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
    every kernel's launches summed over the runs, and path a's result."""
    import tempfile

    total: dict[str, int] = {}
    runs: dict[str, list] = {"a": [], "b": [], "d": [], "d'": []}
    with count_model_group_calls() as tp_calls, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        traced = PROFILE_FLAGS + ["--profile-dir", tmp]
        for name, argv, falls in (("a", TRAIN_ARGS + traced, True),
                                  ("b", MOE_ARGS + traced, True),
                                  ("c", ONEBIT_ARGS, False),
                                  ("d", BUCKET_ARGS + traced, True),
                                  ("d'", FLAT_ARGS, True),
                                  ("d'", FLAT_ARGS, True),
                                  ("d", BUCKET_ARGS, True)):
            launches, res = train_path(LQ, argv, falls)
            check_parent(name, res)
            _add(total, launches)
            if name in runs:
                runs[name].append(res)
            if "--profile-steps" in argv:
                print_trace(f"train[{name}]", res["trace"],
                            unprofiled_wall_ms(res))
        _add(total, telemetry_paths(LQ, runs["a"][0], runs["b"][0]))
        _add(total, optimizer_paths(LQ, runs["a"][0]))
        _add(total, topk_paths(LQ, runs["a"][0]))
        _add(total, fidelity_paths(LQ, runs["a"][0]))
        _add(total, ef_path(LQ, runs["b"][0]))
        _add(total, wide_paths(LQ))
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
    return total, runs["a"][0]


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


def _trace_line(res: dict, step: int = 2) -> str:
    t = res["trace"]
    if not t or not os.path.exists(t["path"]):
        raise AssertionError(f"telemetry: no trace file written ({t})")
    ranges = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
        t["ranges"].items()) if k in ("loco/apply", "loco/metrics"))
    return (f"trace of step {step} {os.path.getsize(t['path']):,} bytes; "
            f"device "
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
        ta, te = a["trace"]["device_busy_ms"], e["trace"]["device_busy_ms"]
        wa, we = unprofiled_wall_ms(a), unprofiled_wall_ms(e)
        print(f"telemetry: its cost on path a: traced step 2 device busy "
              f"{te:.1f} against {ta:.1f} ms ({te / ta:.3f}x); unprofiled "
              f"step {we:.1f} against {wa:.1f} ms (information: steps "
              f"spread 2-2.6x between calls)", flush=True)
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


def topk_paths(LQ, a: dict) -> dict:
    """Paths h and h': the top-k codec flat (no kernel launched; its
    encode's device time from the trace of step 2) and as ragged buckets
    beside loco8 ones (fused_compress by bit width as derived).  Returns
    their launches."""
    import tempfile

    total: dict[str, int] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_topk_") as tmp:
        launches, h = train_path(LQ, H_ARGS + ["--profile-dir", tmp], False)
        _add(total, launches)
        enc = h["trace"]["ranges"].get("loco/encode") if h["trace"] else None
        if enc is None:
            raise AssertionError(f"topk: no loco/encode range in the trace "
                                 f"of step 2 ({h['trace']})")
        print(f"topk: path h: losses {h['losses']} (path a {a['losses'][:3]}"
              f"); loco/encode GPU-side span {enc:.2f} ms per step; peak "
              f"device memory {h['peak_mem_bytes'] / 2**30:.2f} GiB (path a "
              f"{a['peak_mem_bytes'] / 2**30:.2f}); {_trace_line(h)}",
              flush=True)
    launches, h2 = train_path(LQ, H2_ARGS, False)
    _add(total, launches)
    print(f"topk: path h': losses {h2['losses']}; fused_compress by bit "
          f"width {launches_by_bits(H2_ARGS)} as derived", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 3, paths i and j: the fidelity probe and the MoE wire's EF
# ---------------------------------------------------------------------------

def fidelity_paths(LQ, a: dict) -> dict:
    """Path i: path a's command, probes at steps 2 and 5.  Its losses are
    path a's bit for bit; its launches and collectives less the probes'
    (derived: per probe backward and LoCo tensor one fused_compress, two
    dequant_mean and one reference reduce-scatter) are path a's, so the
    other steps are path a's steps; the stream holds 2 fidelity records
    with
    finite ``fidelity/cos``, ``rel_l2`` and ``comp_gain``, which the
    port's validator accepts.  Prints their values, the peak memory, the
    unprofiled probe step 2's time against the other steps' and the
    trace of probe step 5 (device busy time, launches, ``loco/probe``'s
    span).  Returns its launches."""
    import tempfile

    from repro_torch.telemetry import sink

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fid_") as tmp:
        path = os.path.join(tmp, "i.jsonl")
        launches, i = train_path(LQ, I_ARGS + ["--metrics-jsonl", path,
                                               "--profile-dir", tmp], True)
        trace = _trace_line(i, 5)
        check_parent("a", i, "i")
        res = sink.validate_stream(path)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    want_kinds = {"header": 1, "step": 6, "fidelity": 2, "summary": 1}
    if res["errors"] or res["kinds"] != want_kinds:
        raise AssertionError(f"fidelity: stream {res}, want {want_kinds}")
    n_a, n_i = len(a["losses"]), len(i["losses"])
    tensors = sum(n for n in sync_runs(I_ARGS).values())
    probe_bw = probe_backwards(I_ARGS)
    extra_l = {"fused_compress": tensors * probe_bw,
               "dequant_mean": 2 * tensors * probe_bw}
    extra_c = {"_REDUCE_SCATTER": tensors * probe_bw}
    for what, got, per_a, extra in (
            ("launches", launches, a["launches"], extra_l),
            ("collectives", i["collectives"], a["collectives"], extra_c)):
        base = {k: v - extra.get(k, 0) for k, v in got.items()}
        want = {k: v // n_a * n_i for k, v in per_a.items()}
        if {k: v for k, v in base.items() if v} != want or any(
                v % n_a for v in per_a.values()):
            raise AssertionError(f"fidelity: path i {what} {got} less the "
                                 f"probes' {extra} != path a's {want}")
    fids = [r for r in recs if r["kind"] == "fidelity"]
    steps = {r["step"]: r["step_ms"] for r in recs if r["kind"] == "step"}
    for r in fids:
        m = r["metrics"]
        keys = ("fidelity/cos", "fidelity/rel_l2", "fidelity/comp_gain")
        if not all(math.isfinite(m[k]) for k in keys) or not all(
                math.isfinite(v) for v in m.values()):
            raise AssertionError(f"fidelity: step {r['step']}: {m}")
        print(f"fidelity: path i step {r['step']}: "
              + ", ".join(f"{k} {m[k]:.6f}" for k in keys)
              + f"; {len(m)} keys", flush=True)
    if [r["step"] for r in fids] != [2, 5]:
        raise AssertionError(
            f"fidelity: probes at {[r['step'] for r in fids]}")
    probe_span = i["trace"]["ranges"].get("loco/probe", 0.0)
    print(f"fidelity: path i: losses path a's; launches and collectives "
          f"path a's plus {extra_l} and {extra_c}; peak device memory "
          f"{i['peak_mem_bytes'] / 2**30:.2f} GiB (path a "
          f"{a['peak_mem_bytes'] / 2**30:.2f}); step ms: probe step 2 "
          f"{steps[2]:.1f}, the others "
          + ", ".join(f"{steps[k]:.1f}" for k in (1, 3, 4))
          + f"; {trace}; loco/probe GPU-side span "
          f"{probe_span:.2f} ms", flush=True)
    return launches


def ef_path(LQ, b: dict) -> dict:
    """Path j: path b's command with ``--moe-a2a block8+ef``, 3 steps.
    Losses finite and falling; step 0 within the MoE limit (2e-3
    relative) of path b's: its first microbatch is block8's (a zero
    residual), its second reads the first's residual, so the step's mean
    moves; act_encode and act_decode launched as derived.  Prints the
    peak memory against path b's.  Returns its launches."""
    launches, j = train_path(LQ, J_ARGS, True)
    gap = abs(j["losses"][0] - b["losses"][0])
    print(f"ef: path j losses {j['losses']} (path b {b['losses'][:3]}); "
          f"step-0 gap {gap:.3e}; moe_aux {j['moe_aux']}; peak device "
          f"memory {j['peak_mem_bytes'] / 2**30:.2f} GiB (path b "
          f"{b['peak_mem_bytes'] / 2**30:.2f})", flush=True)
    if gap > REF_STEP0_RTOL * abs(b["losses"][0]):
        raise AssertionError(f"ef: path j's step 0 left path b's: {gap}")
    return launches


# ---------------------------------------------------------------------------
# phase 3, paths k-o: the pool's other families at full width
# ---------------------------------------------------------------------------

def tokens_per_step(argv) -> int:
    """Tokens one step of ``argv`` trains on: an encoder-decoder's decoder
    tokens (its frames are ``frames_per_step``)."""
    from repro_torch.launch import train

    args = train.build_args(argv)
    cfg = train.make_cfg(args)
    return args.global_batch * (cfg.dec_len if cfg.enc_dec
                                else args.seq_len)


def frames_per_step(argv) -> int:
    from repro_torch.launch import train

    args = train.build_args(argv)
    return args.global_batch * args.seq_len


# the peak device memory paths k-o must stay under (of the card's 80 GB)
WIDE_PEAK_GIB = 72.0


def wide_paths(LQ) -> dict:
    """Paths k (qwen3-moe-30b-a3b, 2 layers), l (mixtral-8x7b, 1 layer),
    m (mamba2-2.7b, M_LAYERS layers), n (zamba2-2.7b, 12 layers) and o
    (whisper-small, whole) at full width: losses finite and falling and
    the recorded ones bit for bit (``check_parent``), every kernel
    launched as derived (``train_path``, under the depth cut), the peak
    under WIDE_PEAK_GIB.  Prints the parameters, the peak memory, tok/s
    (and frames/s for whisper), step 2's device busy time and launches
    (traced), and the idle share of the unprofiled step 1 (1 - busy /
    wall).  Returns their launches."""
    import tempfile

    from repro_torch.configs.base import get_arch
    from repro_torch.launch import steps, train

    total: dict[str, int] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_") as tmp:
        for name, (argv, layers) in WIDE_PATHS.items():
            with cut_depth(layers):
                cfg = train.make_cfg(train.build_args(argv))
                launches, res = train_path(
                    LQ, argv + ["--profile-dir", tmp], True)
            check_parent(name, res)
            _add(total, launches)
            n = sum(math.prod(i.shape) * (g.n_layers or 1)
                    for g in steps.model_groups(cfg, 1) for i in g.infos)
            t = res["trace"]
            if not t or not t["device_busy_ms"]:
                raise AssertionError(f"wide: path {name}: the trace of "
                                     f"step 2 holds no device time ({t})")
            wall = res["step_ms"][0]
            depth = (f"{layers} of {get_arch(cfg.name).n_layers} layers"
                     if layers else f"whole ({cfg.enc_layers} + "
                     f"{cfg.n_layers} layers)" if cfg.enc_dec else "whole")
            frames = (f", {frames_per_step(argv) / wall * 1e3:.1f} frames/s"
                      if cfg.enc_dec else "")
            peak = res["peak_mem_bytes"] / 2**30
            print(f"wide: path {name}: {cfg.name}, {depth} at full "
                  f"width, {n:,} parameters; losses {res['losses']}; "
                  f"{res['tok_per_s']:.1f} tok/s after the first step "
                  f"(the traced step 2 included), "
                  f"{tokens_per_step(argv) / wall * 1e3:.1f} tok/s{frames} "
                  f"on step 1 ({wall:.1f} ms, unprofiled); peak device "
                  f"memory {peak:.2f} GiB "
                  f"({res['peak_mem_bytes'] / n:.2f} B per parameter); "
                  f"step 2 traced: device "
                  f"busy {t['device_busy_ms']:.1f} ms in "
                  f"{t['device_launches']} launches; idle share "
                  f"{max(0.0, 1 - t['device_busy_ms'] / wall):.1%} (step 2's "
                  f"busy over step 1's wall)", flush=True)
            print_trace(f"wide[{name}]", t, wall)
            if peak > WIDE_PEAK_GIB:
                raise AssertionError(f"wide: path {name} peaked at "
                                     f"{peak:.2f} GiB, over {WIDE_PEAK_GIB}")
    return total


# ---------------------------------------------------------------------------
# phase 3c: the hierarchical exchange on size-1 mesh axes
# ---------------------------------------------------------------------------

def hier_schedules() -> dict:
    """name -> (SyncConfig, number of dp mesh axes): the four schedules
    of the hierarchical phase."""
    import dataclasses

    from repro_torch.core.loco import SyncConfig, SyncTier
    from repro_torch.core.quantizer import QuantConfig

    loco4, loco8 = SyncConfig(), SyncConfig(quant=QuantConfig(bits=8))
    naive = {b: SyncConfig(strategy="naive4", quant=QuantConfig(bits=b))
             for b in (4, 8)}
    return {
        "loco4 -> naive8": (dataclasses.replace(loco4, hierarchical=True), 2),
        "loco4 -> naive4 (+hier4)": (dataclasses.replace(
            loco4, hierarchical=True, stage2=naive[4]), 2),
        "loco8 -> naive8 -> topk 25%": (dataclasses.replace(
            loco8, hierarchical=True, tiers=(
                SyncTier(naive[8]), SyncTier(SyncConfig(
                    strategy="topk", topk_frac=0.25)))), 3),
        "onebit -> naive8": (SyncConfig(strategy="onebit",
                                        hierarchical=True), 2),
    }


def hier_expected(cfg, probe: bool = False) -> dict:
    """Kernel launches of one ``hierarchical_sync`` call, from its legs:
    stage 1 encodes with the bucket's codec (``fused_compress`` for loco,
    ``onebit_pack`` for onebit) and every block-quantized leg decodes with
    ``dequant_mean``; naive4 encodes and top-k and onebit decode with
    plain ops.  A ``probe`` call also encodes stage 1's segment from a
    zero state and decodes it and the live wire at D = 1."""
    from repro_torch.core.loco import sync_schedule

    want: dict[str, int] = {}

    def add(name, n=1):
        want[name] = want.get(name, 0) + n

    for i, c in enumerate([cfg] + [t.sync for t in sync_schedule(cfg)]):
        if c.strategy == "onebit":
            add("onebit_pack", 1 + (probe and i == 0))
        elif c.strategy in ("loco", "naive4") and c.quant.mode == "block":
            if i == 0 and c.strategy == "loco":
                add("fused_compress", 1 + probe)
                add("dequant_mean", 2 * probe)
            add("dequant_mean")
    return want


def hierarchical_phase(LQ, dev) -> dict:
    """``comm.hierarchical_sync`` on the card over size-1 mesh axes (built
    by ``launch.mesh.mesh_axes``), at path a's largest LoCo length and a
    tp = 2 rank's, for every schedule of ``hier_schedules``: each kernel
    launched as ``hier_expected`` derives, and the shard and the new state
    bit for bit with the same call on the CPU (the plain versions); and
    the same call with the fidelity probe, whose reference stack too is
    the CPU's bit for bit (on size-1 axes every mean is one value, exact).
    Returns the card's launches."""
    import torch

    from repro_torch.core import codec as codec_lib
    from repro_torch.core import comm
    from repro_torch.launch import mesh

    sizes = (max(loco_sizes(TRAIN_ARGS)), max(loco_sizes(TRAIN_ARGS,
                                                         TP_LOCAL)))
    cases = [(name, cfg, axes, n) for name, (cfg, axes) in
             hier_schedules().items() for n in sizes]

    def inputs(cfg, n):
        gen = torch.Generator(device=dev).manual_seed(n % 9973)
        g = _grad(n, gen, dev).to(torch.bfloat16)
        err = "f8" if codec_lib.get_codec(cfg).state_dtype() == \
            torch.float8_e4m3fn else "bf16"
        return g, _err(n, err, gen, dev)

    def run(device, record):
        out = {}
        with mesh.dp_group(device) as world:
            axes = {2: mesh.mesh_axes(world, 1, pods=1),
                    3: mesh.mesh_axes(world, 1, pods=1, wans=1)}
            for name, cfg, k, n in cases:
                # the probe at a tp = 2 rank's length (the smaller)
                for probe in (False, True)[:1 + (n == min(sizes))]:
                    g, st = inputs(cfg, n)
                    if device.type == "cpu":
                        g, st = g.cpu(), st.cpu()
                    LQ.reset_launches()
                    t = time.perf_counter()
                    got = comm.hierarchical_sync(g, st, cfg, axes[k],
                                                 probe=probe, group=world)
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    secs = time.perf_counter() - t
                    record(name, n, cfg, probe, dict(LQ.LAUNCHES), secs)
                    out[name, n, probe] = tuple(x.cpu() for x in got)
                    del g, st, got
        return out

    total: dict[str, int] = {}

    def on_card(name, n, cfg, probe, launches, secs):
        want = hier_expected(cfg, probe)
        print(f"hierarchical: {name} at {n:,}{' probe' if probe else ''} "
              f"on the card: launches {launches} (derived {want}); "
              f"{secs * 1e3:.1f} ms host wall", flush=True)
        if launches != want:
            raise AssertionError(f"hierarchical: {name} at {n:,} launched "
                                 f"{launches}, want {want}")
        _add(total, launches)

    card = run(dev, on_card)
    torch.cuda.empty_cache()
    cpu = run(torch.device("cpu"), lambda *a: None)
    for key, got in card.items():
        shard, new = got[:2]
        want_shard, want_new = cpu[key][:2]
        ok = all(_same(x, y) for x, y in zip(got, cpu[key]))
        refs = (f", reference stack {tuple(got[2].shape)}"
                if len(got) > 2 else "")
        print(f"hierarchical: {key[0]} at {key[1]:,}: shard {shard.dtype} "
              f"{tuple(shard.shape)}, state {new.dtype}{refs}: "
              f"{'bit for bit with the CPU' if ok else 'DIFFERS'} (max |d| "
              f"shard {_max_abs(shard, want_shard):.3e})", flush=True)
        if not ok:
            raise AssertionError(f"hierarchical: {key} differs from the CPU")
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
def cut_depth(layers: int | None, cli=None):
    """Train (and derive counts for) ``layers`` layers of the CLI's model
    (None: its whole depth); ``cli`` the CLI module (default
    ``launch.train``; ``launch.serve`` serves so).  A hybrid's cut must be
    whole super-blocks (``build_groups`` refuses any other)."""
    import dataclasses

    if cli is None:
        from repro_torch.launch import train as cli
    if layers is None:
        yield
        return
    make_cfg = cli.make_cfg
    cli.make_cfg = lambda args: dataclasses.replace(make_cfg(args),
                                                    n_layers=layers)
    try:
        yield
    finally:
        cli.make_cfg = make_cfg


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
        check_parent("checkpoint", full, want=PARENT_CKPT_LOSSES)
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


KERNEL_NAMES = tuple(row[0] for row in KERNEL_ROWS)


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


def time_grad_norm(dev, rate: float) -> None:
    """Device time of the step's exact gradient norm (the per-leaf f64 sums
    of ``steps.grad_norm``, ``comm.sum_f64``) over path b's gradient
    shapes (1.34B f32 elements, random), beside the f32 ``torch.sum(x *
    x)`` per leaf that it replaced; the total is checked against the f32
    form's.  Printed, not gated."""
    import torch

    from repro_torch.core.comm import sum_f64
    from repro_torch.launch import train
    from repro_torch.models.transformer import build_groups

    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = [torch.randn(math.prod(i.shape) * (g.n_layers or 1),
                          device=dev, generator=gen)
              for g in build_groups(train.make_cfg(
                  train.build_args(MOE_ARGS)), 1) for i in g.infos]
    exact = device_ms(lambda: sum(sum_f64(x, x) for x in leaves).float())
    plain = device_ms(lambda: sum(torch.sum(x * x) for x in leaves))
    got = float(sum(sum_f64(x, x) for x in leaves))
    want = float(sum(torch.sum(x * x) for x in leaves))
    if abs(got - want) > 1e-4 * want:
        raise AssertionError(f"grad norm: f64 sum {got} against f32 {want}")
    n = sum(x.numel() for x in leaves)
    print(f"grad norm: {n:,} f32 elements in {len(leaves)} leaves (path "
          f"b's): f64 sums {exact:.3f} ms against f32 sums {plain:.3f} ms; "
          f"HBM bound {4 * n / rate * 1e3:.3f} ms", flush=True)
    del leaves
    torch.cuda.empty_cache()


def print_trace(tag: str, t: dict, wall_ms: float) -> None:
    """Where one traced training step spends device time
    (``profiler.window_summary`` of the run's ``--profile-steps`` window,
    ``t``): busy time (kernels, memcpys and memsets) by kernel class, the
    ten longest kernels, this repo's kernels, the idle share against the
    unprofiled step wall time ``wall_ms``, and each ``loco/*`` range's
    GPU-side span (not device work of its own) and host time.
    Informational."""
    busy = t["device_busy_ms"]
    print(f"{tag}: traced step: device busy {busy:.1f} ms in "
          f"{t['device_launches']} kernels, memcpys and memsets; "
          f"unprofiled step {wall_ms:.1f} ms; device idle share "
          f"{max(0.0, 1 - busy / wall_ms):.1%}", flush=True)
    kernels = t.get("kernels") or {}
    if not busy or not kernels:
        print(f"{tag}: the trace holds no device time by kernel", flush=True)
        return
    by_class: dict[str, list] = {}
    for key, (ms, count) in kernels.items():
        c = by_class.setdefault(_kernel_class(key), [0.0, 0])
        c[0] += ms
        c[1] += count
    for c, (ms, count) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"{tag}: {c}: {ms:.1f} ms x{count} ({ms / busy:.1%} of busy)")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for key, (ms, count) in ranked[:10]:
        print(f"{tag}: kernel {key[:90]} x{count}: {ms:.2f} ms")
    for key, (ms, count) in ranked:
        if any(k in key.lower() for k in KERNEL_NAMES):
            print(f"{tag}: kernel {key[:60]} x{count}: {ms:.2f} ms")
    for key, ms in sorted(t["ranges"].items()):
        print(f"{tag}: annotation {key}: GPU-side span {ms:.1f} ms (not "
              "device work)")
    for key, ms in sorted((t.get("host_ranges") or {}).items()):
        print(f"{tag}: range {key}: host {ms:.1f} ms", flush=True)


def unprofiled_wall_ms(res: dict, traced: int = 2) -> float:
    """Median wall time of a run's steps after the first but the traced
    one (``res["step_ms"][0]`` is step 1)."""
    walls = [ms for i, ms in enumerate(res["step_ms"], 1) if i != traced]
    return statistics.median(walls)


def profile_only(src: Path) -> None:
    """``--profile-only``: paths a and b, 3 steps each, step 2 traced,
    from the package tree ``src`` (another checkout's, to compare two
    commits in one call); prints ``print_trace``'s breakdown."""
    import tempfile

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as tmp:
        for name, argv in (("a", TRAIN_ARGS), ("b", MOE_ARGS)):
            argv = argv + ["--steps", "3"] + PROFILE_FLAGS + [
                "--profile-dir", tmp]
            res = train.main(argv)
            print(f"profile[{name}] {src}: losses {res['losses']}",
                  flush=True)
            print_trace(f"profile[{name}]", res["trace"] or {
                "device_busy_ms": 0.0, "device_launches": 0, "ranges": {}},
                        unprofiled_wall_ms(res))


# ---------------------------------------------------------------------------
# phase 3d: serving, through the serve CLI
# ---------------------------------------------------------------------------

def _serve_args(arch, batch: int, prompt: int, steps: int, *extra):
    return ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--decode-steps", str(steps), "--seed", "0",
            *extra]


# Paths p-u: the serve CLI at full width and depth, random weights from
# seed 0, greedy; whisper's prompt is 1,500 frames (its 30 s window).
SERVE_PATHS = {
    "p": _serve_args("llama2-400m", 8, 1024, 128),
    "q": _serve_args("mamba2-2.7b", 8, 1024, 128),
    "r": _serve_args("h2o-danube-1.8b", 2, 4096, 64),
    "s": _serve_args("whisper-small", 8, 1500, 128),
    "t": _serve_args("zamba2-2.7b", 8, 1024, 128),
    "u": _serve_args("deepseek-v3-moe", 8, 1024, 128),
}
# the decode step each path traces
SERVE_TRACED_STEP = 3
# How far a path's decode logits may leave the uncached forward over the
# prompt and the generated tokens on the card (u has no such check: the
# MoE capacity depends on the tokens per call, so a decode step drops
# other tokens than the forward).  The paths are deterministic, so each
# run gives the same gaps.  The forward's own rounding floor at these
# shapes (``teacher_forced_gaps``: the forward over a shorter sequence
# against the forward over the longer one, where they share positions;
# no serving code) is 0 on p and r: there each row's logits do not
# depend on the sequence length, and the decode's gap (0.0898 and
# 0.0869 at most in runs AV-BA, H100 80GB HBM3, 700 W) comes from its
# 8-row matmuls alone; their limits are 1.5 times it.  On s, q, t, q'
# and t' the floor is not 0 (run BA: largest 0.0234, 2.891, 3.309,
# 0.195, 0.742; median position 0.0215, 1.748, 2.344, 0.047, 0.141): the
# random-weight mamba2 and zamba2 amplify every rounding through their
# mixers, the more the deeper, and the decode's gaps have the same
# distribution (largest 0.0273, 2.594, 3.742, 0.297, 0.564; median step
# 0.0234, 1.664, 2.396, 0.047, 0.141).  There the largest gap may reach
# SERVE_FLOOR_FACTOR times the floor's largest (measured at most 1.52x,
# q'), and the median decode step SERVE_MEDIAN_FACTOR times the floor's
# median (at most 1.09x, s).  A wrong cache shows in the median, even
# at full depth: a first decode step whose conv contexts are one token
# stale leaves the forward by 6.34, 6.23, 5.33 and 5.83 on q, t, q' and
# t' (BA), 1.8-76x their median limits, which that control must exceed.
# Path x holds its decode to a continuation (long_ssm_checks) under the
# same factors; its floor, the continuation with the scan in chunks of one
# step, was 0.768 at most and 0.410 at the median position in runs BP and
# BQ (H100 80GB HBM3, 700 W), the decode's gaps 0.928 and 0.590 (1.21x
# and 1.44x), the stale control 5.75.
SERVE_FWD_LIMIT = {"p": 0.135, "r": 0.13}
SERVE_FLOOR_FACTOR, SERVE_MEDIAN_FACTOR = 2.0, 1.5
# sha256 (first 16 hex digits) of each path's generated tokens, (batch,
# 1 + steps) int64, as two processes gave them in run AV (s) and in run
# AW (q), and in runs BI and BK (p, r, t, u, whose prefills cross 512
# keys, re-recorded once the prefill took 512-key blocks; v, w; H100
# 80GB HBM3, 700 W), in runs BP and BQ (s, re-recorded once its serving
# encoder took three 512-key blocks over the 1,500 frames; x): what every
# later run must give bit for bit.
PARENT_TOKENS = {"p": "148d4562033affca", "q": "8888dcc10b3880ba",
                 "r": "9def73e86cff5bc4", "s": "442c5782b09562f4",
                 "t": "d38d4a0f5437e913", "u": "44357edd34485bfb",
                 "v": "09aae1d2e965aee6", "w": "453d788e2c2ff408",
                 "x": "1de1979ebf3bc99c"}
# q and t cut to their first layers at full width (zamba2: one
# super-block), where the rounding has few layers to grow through, so
# the floor and the limit are tight (their tokens are not recorded).
SERVE_CUT_PATHS = {"q'": ("q", 4), "t'": ("t", 6)}
# Paths v and w: the reference's prefill_32k sequence length at batch 1,
# 16 decode steps; w is gemma2-27b at full width cut to W_LAYERS layers,
# two of its 4,096-window layers and two global ones.  Their tokens are
# recorded in PARENT_TOKENS as the other paths'.
LONG_PROMPT, LONG_STEPS, W_LAYERS = 32768, 16, 4
# Path x: mamba2-2.7b at full width and depth, as v otherwise: its SSD scan
# in groups of ssm.GROUP chunks and its conv caches of their own storage
# (long_ssm_checks).
LONG_PATHS = {
    "v": (_serve_args("llama2-400m", 1, LONG_PROMPT, LONG_STEPS), None),
    "w": (_serve_args("gemma2-27b", 1, LONG_PROMPT, LONG_STEPS), W_LAYERS),
    "x": (_serve_args("mamba2-2.7b", 1, LONG_PROMPT, LONG_STEPS), None),
}
# (a) layer 0's last LONG_ROWS query rows over all 32,768 keys: the
# prefill's blockwise attention against the one-block formula
# (``one_block_attention``), its largest gap within ATTN_RTOL of the mean
# |output| of those rows: 1.5 times the largest in run BN (v 2.44e-4 of a
# mean 8.65e-3, 0.0282; w 4.88e-4 of 2.14e-2, 0.0228; H100 80GB HBM3,
# 700 W).  The control, the formula with the 512 keys before those rows
# left out (every row sees them), must exceed it: BN gave 1.68 and 5.15
# of the mean.
LONG_ROWS = 1024
ATTN_RTOL = 0.0423
# (b) the serve run's own logits (its prefill's last position, then its 16
# decode steps) against one prefill over the prompt and the generated
# tokens at those positions; per step the largest logit gap and the mean
# one; their limits are 1.5 times the largest of each in run BN (v: 0.0972
# and 0.0162; w: 0.0625 and 0.00673; the prefill's own position 0 on
# both; the paths are deterministic).  The control, one more decode step
# from the run's final caches with their position one stale (the step's
# token written over the newest position and roped there), must exceed
# the mean's limit: BN gave 0.148 on v, 0.0126 on w (largest 0.801 and
# 0.0781).  Single slots cannot be seen: with random weights over 32,768
# keys the attention is near uniform, and emptying the newest slot or
# shifting every slot's keys and values by one position moved a first
# step by no more than its rounding (run BJ: v 0.0859 and 0.0898, w
# 0.0625 both, largest gaps).
LONG_DECODE_LIMIT = {"v": (0.1458, 0.0243), "w": (0.09375, 0.010095)}
# x's (a): layer 0's SSD scan over the prompt, in groups, against the
# whole form (every chunk in one group, the scan as it was before the
# groups) on the same inputs: the largest gap of Y relative to the mean
# |Y| within SCAN_RTOL (0: bit for bit).  The control, group
# SCAN_DROP_GROUP run from a zero state instead of the one entering it,
# must exceed it.  Runs BP and BQ (H100 80GB HBM3, 700 W): bit for bit,
# the control 24.3 times the mean |Y|.
SCAN_RTOL = 0.0
SCAN_DROP_GROUP = 4


def serve_param_count(cfg) -> int:
    from repro_torch.launch import steps

    return sum(math.prod(i.shape) * (g.n_layers or 1)
               for g in steps.model_groups(cfg, 1) for i in g.infos)


def serve_expected_launches(argv) -> tuple[dict, dict]:
    """This repo's kernels per prefill and per decode step of the serve
    run ``argv``, from the code: a MoE model on a block8 wire quantizes
    and dequantizes each layer's dispatch and combine once per forward
    call (``moe_block``: one ``a2a_exchange`` each; ``block8+ef`` serves
    stateless); nothing else launches a kernel of this repo."""
    from repro_torch.launch import serve

    cfg = serve.make_cfg(serve.build_args(argv))
    if cfg.family == "moe" and cfg.moe_a2a_codec in ("block8", "block8+ef"):
        n = 2 * cfg.n_layers
        per = {"act_encode": n, "act_decode": n}
        return per, per
    return {}, {}


def serve_exchange_rows(argv, prefill: bool) -> int:
    """Rows of 512 that one MoE exchange of the serve run ``argv``
    quantizes: its prefill's batch x prompt tokens or a decode step's
    batch tokens (tp = 1)."""
    from repro_torch.core import act_comm
    from repro_torch.launch import serve

    args = serve.build_args(argv)
    n = args.batch * (args.prompt_len if prefill else 1)
    g = act_comm.a2a_geometry(serve.make_cfg(args), n, 1)
    return g["n_pad"] // act_comm.ACT_BLOCK


def tokens_digest(tokens) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.asarray(tokens, np.int64).tobytes()
                          ).hexdigest()[:16]


def teacher_forced_gaps(cfg, res, argv, control: bool = False) -> dict:
    """The uncached forward over the prompt and the generated tokens (an
    encoder-decoder: the encoder, then the decoder over its start token
    and the generated ones) against the serve run's logits.  Returns
    ``gaps`` (per step, the prefill's last position first, the largest
    gap; the decode steps' forward soft-capped as the decode caps it),
    ``agree`` (the share of decoded tokens that are the forward's argmax)
    and ``floor``: the forward's own rounding at these shapes, with no
    serving code, the largest gap per position between the forward over
    a shorter sequence (the prompt; an encoder-decoder, the first half of
    its decoder tokens) and this forward at the last positions they share,
    as many as the decode compares.  With ``control``, ``stale``: the gap
    of a first decode step whose every conv context is one token stale
    (its newest input dropped, its oldest repeated) after a fresh
    prefill: what a wrong cache gives against the same limit."""
    import torch

    from repro_torch.core import flatparam as FP
    from repro_torch.launch import serve, steps
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T

    def gap(a, b):  # the largest gap per position of (B, S, V) logits
        return (a.float() - b.float()).abs().amax(dim=(0, 2)).tolist()

    args = serve.build_args(argv)
    model = steps.build_model(cfg, 1)
    store = FP.ServeStore(model.groups(), res["params"])
    dev = res["logits"][0].device
    gen = torch.tensor(res["tokens"], device=dev)
    n = args.decode_steps
    out = {}
    with torch.inference_mode():
        if cfg.enc_dec:
            memory = model.encode(store, res["batch"]["frames"].to(dev),
                                  remat=False)
            toks = torch.cat([torch.zeros_like(gen[:, :1]), gen[:, :n]], 1)
            full = model.decode_seq(store, memory, toks, remat=False)
            k = (n + 1) // 2
            out["floor"] = gap(model.decode_seq(store, memory, toks[:, :k],
                                                remat=False), full[:, :k])
            del memory
        else:
            prompt = res["batch"]["tokens"].to(dev)
            P = prompt.shape[1]
            toks = torch.cat([prompt, gen[:, :n]], 1)
            full = model.forward(store, toks, remat=False)[0]
            k = min(n + 1, P)
            out["floor"] = gap(model.forward(store, prompt, remat=False)[0]
                               [:, P - k:], full[:, P - k:P])
            if control:
                state = T.init_decode_state(cfg, 1, prompt.shape[0],
                                            res["window"], dev)
                model.prefill(store, prompt, state)
                for mc in state.mamba:
                    mc.conv = tuple(torch.cat([c[:, :1], c[:, :-1]], 1)
                                    for c in mc.conv)
                got = model.decode_step(store, state, gen[:, :1])[0]
                out["stale"] = max(gap(got, full[:, P:P + 1]))
                del state, got
            full = full[:, -(n + 1):]
        gaps, agree = [], 0
        for i, got in enumerate(res["logits"]):
            want = full[:, i]
            if i and cfg.final_softcap:
                want = C.soft_cap(want, cfg.final_softcap)
            gaps.append(float((got - want.float()).abs().max()))
            if i < n:
                agree += int((want.float().argmax(-1) == gen[:, i]).sum())
        del full
    out.update(gaps=gaps, agree=agree / (gen.shape[0] * n))
    return out


def serve_path(LQ, name: str, argv, tmp: str, cut: int | None = None
               ) -> tuple[dict, int]:
    """One path through ``repro_torch.launch.serve.main`` with the launch
    counters zeroed just before and read just after: tokens in range and
    their digest against ``PARENT_TOKENS``, kernel launches per prefill
    and per decode step as derived, decode against the uncached forward
    (p-t) or checks (a) and (b) (the long paths v and w,
    :func:`long_checks`; x, :func:`long_ssm_checks`), and the path's
    metrics printed.  With ``cut`` the model keeps its first ``cut``
    layers and the tokens are not checked (but on w).  Returns its
    launches and its peak memory above what was allocated before it."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.transformer import vocab_padded

    args = serve.build_args(argv)
    long = name in LONG_PATHS
    with cut_depth(cut, serve):
        cfg = serve.make_cfg(args)
        per_pre, per_step = serve_expected_launches(argv)
        print(f"serve: path {name}: python -m repro_torch.launch.serve "
              f"{' '.join(argv)}" + (f" at {cut} layers" if cut else ""),
              flush=True)
        base = torch.cuda.memory_allocated()
        LQ.reset_launches()
        t0 = time.perf_counter()
        res = serve.main(argv + ["--profile-steps", str(SERVE_TRACED_STEP),
                                 "--profile-dir", tmp], keep=True)
    launches = dict(LQ.LAUNCHES)
    secs = time.perf_counter() - t0
    want = {k: per_pre[k] + per_step[k] * args.decode_steps for k in per_pre}
    got_split = res["launches"]
    if (launches != want or got_split["prefill"] != per_pre
            or got_split["decode"] != {k: v * args.decode_steps
                                       for k, v in per_step.items()}):
        raise AssertionError(f"serve: path {name}: launches {launches} "
                             f"(prefill {got_split['prefill']}, decode "
                             f"{got_split['decode']}), want {want} "
                             f"({per_pre} per prefill, {per_step} per "
                             "decode step; serve_expected_launches)")
    toks = np.asarray(res["tokens"])
    if (toks.shape != (args.batch, args.decode_steps + 1)
            or toks.min() < 0 or toks.max() >= vocab_padded(cfg, 1)):
        raise AssertionError(f"serve: path {name}: tokens {toks.shape} "
                             f"out of [0, {vocab_padded(cfg, 1)})")
    if not all(bool(torch.isfinite(lg).all()) for lg in res["logits"]):
        raise AssertionError(f"serve: path {name}: logits not finite")
    state = res["state"]
    if name == "r":
        # the ring wrapped: position 0 left every layer's window
        kv = state.kv[0]
        if not (kv.window == cfg.window
                and int(kv.pos.min()) == args.prompt_len
                + args.decode_steps - cfg.window):
            raise AssertionError(f"serve: path r's ring did not wrap "
                                 f"(window {kv.window}, least position "
                                 f"{int(kv.pos.min())})")
        print(f"serve: path r: the {kv.window}-slot ring wrapped; the "
              f"oldest cached position is {int(kv.pos.min())}", flush=True)
    digest = tokens_digest(toks)
    check, limits, gaps, stale = "", None, [], None
    if long and cfg.family != "ssm":
        gaps, stale = long_checks(cfg, res, args, name)
        state = res["state"] = None
        lim_max, lim_mean = LONG_DECODE_LIMIT[name]
        limits = [(max(g for g, _ in gaps), lim_max),
                  (max(m for _, m in gaps), lim_mean)]
        check = (f"; (b) against one prefill of the prompt and its tokens: "
                 f"largest gap {limits[0][0]:.4f} and mean {limits[1][0]:.5f} "
                 f"(limits {lim_max} and {lim_mean}), the control's mean "
                 f"{stale:.5f}")
        gaps = [g for g, _ in gaps]
    elif name != "u":
        tf = (long_ssm_checks(cfg, res, args, name) if long else
              teacher_forced_gaps(cfg, res, argv,
                                  control=cfg.family in ("ssm", "hybrid")))
        gaps, stale = tf["gaps"], tf.get("stale")
        floor, floor_med = max(tf["floor"]), statistics.median(tf["floor"])
        med = statistics.median(gaps[1:])
        # (largest gap, its limit), (median decode step, its limit)
        limits = ([(max(gaps), SERVE_FWD_LIMIT[name])]
                  if name in SERVE_FWD_LIMIT else
                  [(max(gaps), SERVE_FLOOR_FACTOR * floor),
                   (med, SERVE_MEDIAN_FACTOR * floor_med)])
        scale = max(float(lg.abs().max()) for lg in res["logits"])
        ref = "continuation" if long else "forward"
        check = (f"; against the {'' if long else 'uncached '}{ref}: "
                 f"largest gap {max(gaps):.4f} (prefill {gaps[0]:.4f}, "
                 f"median decode step {med:.4f}; limits "
                 f"{' and '.join(f'{lim:.4f}' for _, lim in limits)}; "
                 f"logits up to {scale:.2f}); the {ref}'s own rounding "
                 f"floor {floor:.4f} (median position {floor_med:.4f})"
                 + (f"; a first decode step with one-token-stale conv "
                    f"contexts {stale:.4f}" if stale is not None else "")
                 + f"; argmax agreement {tf['agree']:.1%}")
    t = res["trace"]
    if not t or not t["device_busy_ms"]:
        raise AssertionError(f"serve: path {name}: the trace of decode "
                             f"step {SERVE_TRACED_STEP} holds no device "
                             f"time ({t})")
    walls = [ms for i, ms in enumerate(res["step_ms"])
             if i != SERVE_TRACED_STEP]
    wall = statistics.median(walls)
    depth = (f"{cut} of {get_arch(args.arch).n_layers} layers" if cut
             else "whole")
    peak = (res["peak_mem_bytes"] or 0) - base
    print(f"serve: path {name}: {cfg.name} {depth}, "
          f"{serve_param_count(cfg):,} parameters; batch {args.batch} x "
          f"prompt {args.prompt_len}, {args.decode_steps} steps, KV window "
          f"{res['window']}; prefill {res['prefill_s'] * 1e3:.1f} ms "
          f"({res['prefill_tok_per_s']:,.0f} "
          f"{'frames' if cfg.enc_dec else 'tok'}/s); decode "
          f"{res['decode_tok_per_s']:,.1f} tok/s, median {wall:.2f} ms per "
          f"step; peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak:,} B)"
          + (f" on {nvidia_smi()}" if long else "")
          + f"; decode step {SERVE_TRACED_STEP} traced: device busy "
          f"{t['device_busy_ms']:.2f} ms in {t['device_launches']} "
          f"launches, idle share "
          f"{max(0.0, 1 - t['device_busy_ms'] / wall):.1%}; launches "
          f"{launches or 'none of this repo'} (as derived){check}; tokens "
          f"{digest}; {secs:.1f} s", flush=True)
    print(f"serve: path {name}: sample row {toks[0].tolist()[:24]}",
          flush=True)
    print_trace(f"serve[{name}]", t, wall)
    print(f"serve: path {name}: per-step gaps "
          f"{[round(g, 4) for g in gaps]}", flush=True)
    for got, lim in limits or ():
        if not got <= lim:
            raise AssertionError(f"serve: path {name}: decode left the "
                                 f"uncached forward ({got:.4f}, limit "
                                 f"{lim:.4f})")
    if stale is not None and not stale > limits[-1][1]:
        raise AssertionError(f"serve: path {name}: the stale control "
                             f"({stale:.4f}) stays within the limit "
                             f"{limits[-1][1]:.4f}: the check cannot see "
                             "it")
    want_digest = PARENT_TOKENS.get(name)
    del res, state
    torch.cuda.empty_cache()
    if (long or not cut) and want_digest != digest:
        raise AssertionError(
            f"serve: path {name}: tokens {digest}, parent "
            f"{want_digest or 'not recorded'}: the tokens moved")
    return launches, peak


def one_block_attention(q, k, v, keep, softcap):
    """The one-block formula, apart from the port's blockwise loop: q (B,
    Sq, H, hd) scaled by 1/sqrt(hd) and rounded to its dtype, f32 scores
    over every key of k, v (B, Sk, H, hd), ``softcap`` before the mask
    ``keep`` (Sq, Sk), ``exp(s - max)`` rounded to v's dtype before the
    value product -> (B, Sq, H, hd) in q's dtype."""
    from repro_torch.models import common as C

    qs = (q.float() / math.sqrt(q.shape[-1])).to(q.dtype).transpose(1, 2)
    s = qs.float() @ k.transpose(1, 2).float().transpose(-1, -2)
    if softcap is not None:
        s = C.soft_cap(s, softcap)
    s.masked_fill_(~keep, C.NEG_INF)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    acc = p.to(v.dtype).float() @ v.transpose(1, 2).float()
    return (acc / p.sum(dim=-1, keepdim=True)).transpose(1, 2).to(q.dtype)


def long_checks(cfg, res, args, name) -> tuple[list, float]:
    """Checks (a) and (b) of a long path on the serve run ``res`` (its
    weights, prompt, per-step logits and final caches); returns (b)'s
    (largest, mean) gaps per step and its control's mean gap, raises if
    (a) fails.  (a): layer 0's q, k and v over the prompt; the prefill's
    attention (``prefill_attention``: query tiles of 512-key blocks),
    timed beside the untiled 512-key call and equal to it bit for bit, at
    the last LONG_ROWS rows against :func:`one_block_attention` over
    every key within ATTN_RTOL of the mean |output| of those rows; the
    control, the formula with one 512-key block every such row sees left
    out, must exceed that limit.  (b): one prefill over the prompt and the
    generated tokens, its last positions' logits (soft-capped, as a
    decode step caps them, but the first), against the serve run's own
    logits (the prefill's last position, then each decode step's); per
    step the largest and the mean gap.  The control: one more step from
    the run's final caches with their position one stale (the newest
    token's key and value overwritten), against the prefill's next
    position."""
    import torch

    from repro_torch.core import flatparam as FP
    from repro_torch.launch import steps
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T

    model = steps.build_model(cfg, 1)
    store = FP.ServeStore(model.groups(), res["params"])
    dev = res["logits"][0].device
    prompt = res["batch"]["tokens"].to(dev)
    B, S = prompt.shape
    n = args.decode_steps
    lay = model._lay
    with torch.inference_mode():
        t0 = time.perf_counter()
        x, _ = model._embed(store, prompt)
        p = store.layer("block", 0)
        pos = torch.arange(S, device=dev)
        q, k, v = T._qkv(p, C.norm(cfg.norm, x, p["norm1"]), lay, cfg, pos)
        del x
        if not lay.kv_identity:
            runs = lay.kv_runs(0)
            k, v = C.expand_kv(k, runs), C.expand_kv(v, runs)
        window = T.layer_window(cfg, 0)
        kw = dict(window=window, softcap=cfg.attn_softcap)

        def timed(fn, *args, **more):  # (its output, its ms)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kw, **more)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t1) * 1e3

        got, tiled_ms = timed(C.prefill_attention, q, k, v, pos)
        out, untiled_ms = timed(C.blockwise_attention, q, k, v, pos, pos,
                                block_k=C.PREFILL_BLOCK_K)
        same = torch.equal(got, out)
        tiles = C.query_tiles(S, window)
        visits = sum(-(-(k1 - k0) // C.PREFILL_BLOCK_K)
                     for _, _, k0, k1 in tiles)
        print(f"serve: path {name}: (a) layer 0's prefill attention: "
              f"{len(tiles)} query tiles, {visits} block visits, "
              f"{tiled_ms:.1f} ms; untiled ({-(-S // C.PREFILL_BLOCK_K)} "
              f"blocks) {untiled_ms:.1f} ms; every row bit for bit the "
              f"untiled call's: {same}", flush=True)
        if not same:
            raise AssertionError(f"serve: path {name}: (a) the query tiles "
                                 "left the untiled call's bits")
        got = got[:, -LONG_ROWS:].float()
        del out
        qr, qp = q[:, -LONG_ROWS:], pos[-LONG_ROWS:, None]
        keep = pos[None] <= qp
        if window is not None:
            keep &= pos[None] > qp - window
        want = one_block_attention(qr, k, v, keep, cfg.attn_softcap).float()
        typical = float(want.abs().mean())
        attn_gap = float((got - want).abs().max())
        del want
        lo = S - LONG_ROWS - C.PREFILL_BLOCK_K
        keep[:, lo:lo + C.PREFILL_BLOCK_K] = False
        dropped = float((got - one_block_attention(
            qr, k, v, keep, cfg.attn_softcap).float()).abs().max())
        del q, k, v, got, qr, keep
        torch.cuda.synchronize()
        limit = ATTN_RTOL * typical
        print(f"serve: path {name}: (a) layer 0 (window {window}, soft cap "
              f"{cfg.attn_softcap}) over {S:,} keys, its last {LONG_ROWS} "
              f"rows (mean |output| {typical:.4e}): the prefill's blockwise "
              f"attention against the one-block formula, largest gap "
              f"{attn_gap:.4e} ({attn_gap / typical:.4f} of the mean; limit "
              f"{ATTN_RTOL}: {limit:.4e}); the control, keys "
              f"[{lo}, {lo + C.PREFILL_BLOCK_K}) left out, "
              f"{dropped:.4e} ({dropped / typical:.4f} of the mean); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not attn_gap <= limit:
            raise AssertionError(f"serve: path {name}: (a) the blockwise "
                                 f"attention left the one-block formula "
                                 f"({attn_gap:.4e} > {limit:.4e})")
        if not dropped > limit:
            raise AssertionError(f"serve: path {name}: (a) the control "
                                 f"({dropped:.4e}) stays within the limit "
                                 f"{limit:.4e}: the check cannot see it")
        t0 = time.perf_counter()
        gen = torch.tensor(res["tokens"], device=dev)       # (B, 1 + n)
        toks = torch.cat([prompt, gen], 1)
        state = T.init_decode_state(cfg, 1, B, toks.shape[1], dev)
        want = model.prefill(store, toks, state, last=n + 2)[0]
        del state
        if cfg.final_softcap:
            want[:, 1:] = C.soft_cap(want[:, 1:], cfg.final_softcap)

        def gap(got, i):  # the largest and the mean logit gap at step i
            d = (got.float().reshape(B, -1) - want[:, i].float()).abs()
            return float(d.max()), float(d.mean())

        gaps = [gap(lg, i) for i, lg in enumerate(res["logits"])]
        stale = res["state"]
        stale.pos -= 1
        stale_gap = gap(model.decode_step(store, stale, gen[:, n:])[0],
                        n + 1)
        del stale, want
        torch.cuda.synchronize()
        print(f"serve: path {name}: (b) against one prefill of the "
              f"{toks.shape[1]:,} tokens, per step (the prefill's last "
              f"position first) the largest and the mean logit gap "
              f"{[(round(g, 4), round(m, 5)) for g, m in gaps]}; the control "
              f"(the final caches' position one stale) {stale_gap[0]:.4f} "
              f"and {stale_gap[1]:.5f}; {time.perf_counter() - t0:.1f} s",
              flush=True)
    return gaps, stale_gap[1]


def fork_state(state):
    """A copy of a state-space model's serving caches (no KV caches)."""
    from repro_torch.models import transformer as T

    assert not state.kv
    return T.DecodeState(kv=[], mamba=[
        T.MambaCache(tuple(c.clone() for c in m.conv), m.ssm.clone())
        for m in state.mamba], pos=state.pos)


def conv_cache_excess(cfg, state) -> list:
    """(c): every conv cache of ``state`` whose storage is not its own
    (B, K-1, ch) bf16 elements: (layer, shape, storage bytes)."""
    bad = []
    for l, m in enumerate(state.mamba):
        for c in m.conv:
            want = c.shape[0] * (cfg.d_conv - 1) * c.shape[2] * 2
            if (c.shape[1] != cfg.d_conv - 1 or c.dtype.itemsize != 2
                    or c.untyped_storage().nbytes() != want):
                bad.append((l, tuple(c.shape),
                            c.untyped_storage().nbytes()))
    return bad


def long_ssm_checks(cfg, res, args, name) -> dict:
    """Checks (a) and (c) of a state-space long path on the serve run
    ``res``, and (b)'s gaps, raising if (a) or (c) fails.  (a): layer 0's
    SSD scan inputs over the prompt, the scan in groups of ssm.GROUP
    chunks against the whole form (GROUP patched to hold every chunk:
    the scan before the groups, op for op), each timed with its peak
    memory, within SCAN_RTOL of the mean |Y|; the control, one group from
    a zero state, beyond it.  (c): after a fresh prefill of the prompt and
    after the run's decode steps, every conv cache owns its (B, K-1, ch)
    storage alone.  (b): from a copy of that prefill's caches, one prefill
    of the first ``decode_steps`` generated tokens (the continuation)
    against the run's decode steps, per step the largest logit gap, the
    fresh prefill's last logits against the run's first; ``floor``, the
    continuation's own rounding, per position: the same prefill from
    another copy with the scan in chunks of one step (``ssm.CHUNK``
    patched; the decode's recurrence in the scan's arithmetic) against it;
    ``stale``, a first decode step from a copy whose conv contexts are
    one token stale, against the continuation.  Returns ``gaps``,
    ``floor``, ``stale`` and ``agree`` (the share of decoded tokens that
    are the continuation's argmax), as ``teacher_forced_gaps`` does."""
    from unittest import mock

    import torch

    from repro_torch.core import flatparam as FP
    from repro_torch.launch import steps
    from repro_torch.models import common as C
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T

    class Captured(Exception):
        pass

    def capture(*a, **kw):
        scan.extend(a)
        raise Captured

    def timed(group, reps: int = 3):  # (Y, S), median ms, peak bytes
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        with mock.patch.object(SSM, "GROUP", group):
            for _ in range(reps):
                t1 = time.perf_counter()
                out = SSM.ssd_chunked(*scan)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
        return out, statistics.median(ms), \
            torch.cuda.max_memory_allocated() - base

    model = steps.build_model(cfg, 1)
    store = FP.ServeStore(model.groups(), res["params"])
    dev = res["logits"][0].device
    prompt = res["batch"]["tokens"].to(dev)
    B, S = prompt.shape
    n = args.decode_steps
    failed = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        scan: list = []
        x, _ = model._embed(store, prompt)
        p = store.layer("block", 0)
        with mock.patch.object(SSM, "ssd_chunked", capture):
            try:
                SSM.mamba2_mixer(C.norm("rmsnorm", x, p["normm"]), p, cfg)
            except Captured:
                pass
        del x
        Q = SSM.chunk_len(S)
        nc = S // Q
        (Yg, Sg), g_ms, g_peak = timed(SSM.GROUP)
        (Yw, Sw), w_ms, w_peak = timed(nc)
        same = torch.equal(Yg, Yw) and torch.equal(Sg, Sw)
        typical = float(Yw.abs().mean())
        scan_gap = float((Yg - Yw).abs().max()) / typical
        state_gap = float((Sg - Sw).abs().max() / Sw.abs().mean())
        X, dt, A, Bm, Cm = scan
        span = SSM.GROUP * SSM.CHUNK
        rows = slice(SCAN_DROP_GROUP * span, (SCAN_DROP_GROUP + 1) * span)
        y_bad, _ = SSM._ssd_group(X[:, rows], dt[:, rows], A, Bm[:, rows],
                                  Cm[:, rows], torch.zeros_like(Sg), Q)
        dropped = float((y_bad - Yg[:, rows]).abs().max()) / typical
        del scan[:], X, dt, A, Bm, Cm, Yg, Yw, Sg, Sw, y_bad
        print(f"serve: path {name}: (a) layer 0's SSD scan over {S:,} "
              f"steps ({nc} chunks of {Q}, groups of {span // Q}): grouped "
              f"{g_ms:.1f} ms, peak {g_peak / 2**30:.3f} GiB; whole form "
              f"{w_ms:.1f} ms, peak {w_peak / 2**30:.3f} GiB; bit for bit: "
              f"{same}; largest gap of Y {scan_gap:.3e} of its mean "
              f"|Y| {typical:.4e} (limit {SCAN_RTOL}), of the final "
              f"state {state_gap:.3e} of its mean; the control (group "
              f"{SCAN_DROP_GROUP} from a zero state) {dropped:.3e}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not scan_gap <= SCAN_RTOL or not state_gap <= SCAN_RTOL:
            failed.append(f"(a) the grouped scan left the whole form "
                          f"({scan_gap:.3e}, {state_gap:.3e} > {SCAN_RTOL})")
        if not dropped > SCAN_RTOL:
            failed.append(f"(a) the control ({dropped:.3e}) stays within "
                          f"the limit {SCAN_RTOL}")

        t0 = time.perf_counter()
        gen = torch.tensor(res["tokens"], device=dev)       # (B, 1 + n)
        state = T.init_decode_state(cfg, 1, B, res["window"], dev)
        first = model.prefill(store, prompt, state, last=1)[0][:, -1]
        excess = conv_cache_excess(cfg, state) + conv_cache_excess(
            cfg, res["state"])
        conv_bytes = sum(c.untyped_storage().nbytes()
                         for m in state.mamba for c in m.conv)
        print(f"serve: path {name}: (c) the {3 * len(state.mamba)} conv "
              f"caches after a fresh prefill hold {conv_bytes:,} B of "
              f"storage; any beyond their own (B, K-1, ch), after it or "
              f"after the run's decode steps: {excess or 'none'}",
              flush=True)
        if excess:
            failed.append(f"(c) conv caches keep larger storages: "
                          f"{excess[:3]}")
        want = model.prefill(store, gen[:, :n], fork_state(state))[0]
        with mock.patch.object(SSM, "CHUNK", 1):
            ones = model.prefill(store, gen[:, :n], fork_state(state))[0]
        floor = (ones.float() - want.float()).abs().amax(dim=(0, 2)).tolist()
        stale = fork_state(state)
        for mc in stale.mamba:
            mc.conv = tuple(torch.cat([c[:, :1], c[:, :-1]], 1)
                            for c in mc.conv)
        stale_gap = float((model.decode_step(store, stale, gen[:, :1])[0]
                           [:, 0].float() - want[:, 0].float()).abs().max())
        gaps = [float((res["logits"][0].float() - first.float()).abs().max())]
        gaps += [float((lg.float() - want[:, i].float()).abs().max())
                 for i, lg in enumerate(res["logits"][1:])]
        agree = float((want.float().argmax(-1) == gen[:, 1:]).float().mean())
        del state, stale, want, ones
        torch.cuda.synchronize()
        print(f"serve: path {name}: (b) a continuation of the prompt's "
              f"caches over the {n} generated tokens against the decode "
              f"steps: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"serve: path {name}: " + "; ".join(failed))
    return dict(gaps=gaps, floor=floor, stale=stale_gap, agree=agree)


def serve_phase(LQ, names=None) -> tuple[dict, dict]:
    """Paths p-x (``SERVE_PATHS``, ``SERVE_CUT_PATHS``, ``LONG_PATHS``; or
    those of ``names``), no model-group collective called at tp = 1;
    every path runs before a failure is raised, so each prints its
    tokens' digest.  Returns the kernels' launches summed, and the long
    paths' peak memory (``max_memory_allocated`` above what was allocated
    before the run)."""
    import tempfile

    total: dict[str, int] = {}
    peaks: dict[str, int] = {}
    failed = []
    with count_model_group_calls() as tp_calls, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        runs = [(name, argv, None) for name, argv in SERVE_PATHS.items()]
        runs += [(name, SERVE_PATHS[of], cut)
                 for name, (of, cut) in SERVE_CUT_PATHS.items()]
        runs += [(name, argv, cut)
                 for name, (argv, cut) in LONG_PATHS.items()]
        for name, argv, cut in runs:
            if names is not None and name not in names:
                continue
            try:
                launches, peak = serve_path(LQ, name, argv, tmp, cut)
                _add(total, launches)
                if name in LONG_PATHS:
                    peaks[name] = peak
            except AssertionError as e:
                print(f"serve: FAILED: {e}", flush=True)
                failed.append(str(e))
    print(f"serve: model-group collectives called {tp_calls[0]} times at "
          "tp = 1", flush=True)
    if tp_calls[0]:
        failed.append("a tp = 1 serve path called a model-group collective")
    if failed:
        raise AssertionError("serve: " + "; ".join(failed))
    return total, peaks


# The reduced serving runs card against CPU: prefill and SERVE_REF_STEPS
# decode steps, the card teacher-forced on the CPU's tokens.
SERVE_REF_STEPS = 8
SERVE_REF_RUNS = {arch: ["--arch", arch, "--reduced", "--batch", "4",
                         "--prompt-len", str(prompt), "--decode-steps",
                         str(SERVE_REF_STEPS)]
                  for arch, prompt in (("llama2-400m", 32),
                                       ("gemma2-27b", 32),
                                       # its reduced window is 64: wraps
                                       ("h2o-danube-1.8b", 64),
                                       ("deepseek-v3-moe", 32),
                                       ("mamba2-2.7b", 32),
                                       ("zamba2-2.7b", 32),
                                       ("whisper-small", 32))}
# The largest logit gap card vs CPU on those runs: 0.094 (zamba2), 0.047
# (deepseek-v3-moe), 0.031 (llama2-400m), 0.023 (h2o-danube), 0.016
# (mamba2), 0.010 (whisper), 0.008 (gemma2) in run AY (H100 80GB HBM3,
# 700 W); the port against the reference on the CPU, 0.148 at most
# (tests/test_torch_decode.py).  About 1.5 times the card's largest:
SERVE_REF_ATOL = 0.15


def serve_on_card(argv, tokens, dev=None) -> list:
    """The serve run ``argv`` on the card (or ``dev``), its decode
    teacher-forced on ``tokens`` (the CPU run's, (B, 1 + steps)): the
    prefill's last logits, then each step's, f32 on the host."""
    import torch

    from repro_torch.core import flatparam as FP
    from repro_torch.core.flatparam import MeshTopo
    from repro_torch.launch import mesh, serve, steps

    args = serve.build_args(argv)
    cfg = serve.make_cfg(args)
    dev = dev or torch.device("cuda", 0)
    with mesh.dp_group(dev):
        topo = MeshTopo.from_group(*mesh.mesh_groups(1))
        params = FP.init_serve_params(steps.model_groups(cfg, 1), 1, 0, dev,
                                      args.seed)
        prefill = steps.make_prefill_step(
            cfg, topo, dev, batch=args.batch,
            window=steps.serve_window(cfg, args.prompt_len,
                                      args.decode_steps))
        decode = steps.make_decode_step(cfg, topo, dev)
        logits, state = prefill(params, serve.make_batch(cfg, args))
        out = [logits.float().cpu()]
        toks = torch.tensor(tokens, device=dev)
        for i in range(args.decode_steps):
            _, logits, state = decode(params, state, toks[:, i:i + 1])
            out.append(logits.float().cpu())
    return out


def serve_reference_runs(cpu: dict, dev=None) -> None:
    """Each ``SERVE_REF_RUNS`` run on the CPU (``cpu[arch]``, a future of
    :func:`_cpu_serve`: its own greedy tokens) and on the card
    teacher-forced on them: every step's logits within SERVE_REF_ATOL, and
    the card's argmax the CPU's token wherever the CPU's top-2 margin
    exceeds SERVE_REF_ATOL."""
    import torch

    worst = 0.0
    for arch, argv in SERVE_REF_RUNS.items():
        c_res = cpu[arch].result()
        card = serve_on_card(argv, c_res["tokens"], dev)
        toks = torch.tensor(c_res["tokens"])
        gaps, checked, agree = [], 0, 0
        for i, (g, c) in enumerate(zip(card, c_res["logits"])):
            c = torch.from_numpy(c)
            gaps.append(float((g - c).abs().max()))
            top2 = c.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > SERVE_REF_ATOL
            checked += int(sure.sum())
            agree += int((g.argmax(-1) == toks[:, i])[sure].sum())
        worst = max(worst, max(gaps))
        print(f"reference: serve reduced {arch}: prefill and "
              f"{SERVE_REF_STEPS} decode steps, card vs cpu logit gaps "
              f"{[round(x, 4) for x in gaps]}; greedy tokens agree on "
              f"{agree} of the {checked} the CPU's top-2 margin decides",
              flush=True)
        if max(gaps) > SERVE_REF_ATOL or agree != checked:
            raise AssertionError(f"reference: serve {arch}: the card left "
                                 f"the CPU (limit {SERVE_REF_ATOL})")
    print(f"reference: serve runs, largest card vs cpu logit gap "
          f"{worst:.4f}", flush=True)


# The reference phase's CPU runs go to REF_CPU_WORKERS spawned processes
# of REF_CPU_THREADS threads each, submitted when the phase starts, so
# that they run while the main process drives the card's side.
REF_CPU_WORKERS, REF_CPU_THREADS = 3, 2


def _cpu_worker_init(src: str) -> None:
    import torch

    sys.path.insert(0, src)
    torch.set_num_threads(REF_CPU_THREADS)


def _cpu_train(argv) -> dict:
    """The training run ``argv`` on the CPU, in a worker (its output
    dropped): its losses and fidelity records."""
    import io

    from repro_torch.launch import train

    with contextlib.redirect_stdout(io.StringIO()):
        res = train.main(argv + ["--device", "cpu"])
    return {"losses": res["losses"], "fidelity": res["fidelity"]}


def _cpu_serve(argv) -> dict:
    """The serve run ``argv`` on the CPU, in a worker (its output
    dropped): its tokens and its per-step logits as numpy arrays."""
    import io

    from repro_torch.launch import serve

    with contextlib.redirect_stdout(io.StringIO()):
        res = serve.main(argv + ["--device", "cpu"], keep=True)
    return {"tokens": res["tokens"],
            "logits": [lg.numpy() for lg in res["logits"]]}


@contextlib.contextmanager
def cpu_pool(src: Path):
    """The reference phase's CPU workers; pending runs are cancelled and
    every worker stopped on the way out."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        REF_CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init, initargs=(str(src),))
    try:
        yield pool
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def submit_serve_cpu(pool) -> dict:
    return {arch: pool.submit(_cpu_serve, argv)
            for arch, argv in SERVE_REF_RUNS.items()}


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
                    ("--error-codec", "bf16"))},
            "llama2-400m topk": _ref_args("llama2-400m", "topk"),
            "llama2-400m loco --fidelity-every 1": _ref_args(
                "llama2-400m", "loco", "--fidelity-every", "1"),
            "deepseek-v3-moe loco block8+ef": _ref_args(
                "deepseek-v3-moe", "loco", "--moe-a2a", "block8+ef"),
            # the pool's other attention decoders; seq 128 where the
            # reduced 64-token window must cut
            **{f"{arch} loco": _ref_args(arch, "loco", *extra)
               for arch, extra in (
                   ("mixtral-8x7b", ("--seq-len", "128")),
                   ("qwen3-moe-30b-a3b", ("--moe-a2a", "block8")),
                   ("gemma2-27b", ("--seq-len", "128")),
                   ("minicpm-2b", ()),
                   ("h2o-danube-1.8b", ("--seq-len", "128")),
                   ("command-r-35b", ()),
                   ("chameleon-34b", ()))},
            # the state-space, hybrid and audio families; mamba2
            # and zamba2 also at seq 128, one SSD chunk of 128 steps, where
            # only the exp masked before it keeps the gradient finite.
            # zamba2 at lr 1e-3: at 2e-3 its step-2 loss is chaotic at the
            # limit's scale (the CPU alone moves it by 0.0125 between 1 and
            # 4 threads; the card was 0.0205 and 0.0212 from the CPU, run
            # AQ), as the mixer's bf16 gradient is 65% from its f32 one in
            # both packages (PERF.md); at 1e-3 the CPU's spread is
            # 0.0044 (seq 32) and 0 (seq 128)
            **{f"{arch} loco{tag}": _ref_args(arch, "loco", *extra, *(
                ("--lr", "1e-3") if arch == "zamba2-2.7b" else ()))
               for arch in ("mamba2-2.7b", "zamba2-2.7b")
               for tag, extra in (("", ()),
                                  (" seq 128", ("--seq-len", "128")))},
            "whisper-small loco": _ref_args("whisper-small", "loco")}
# The scaled, tied and soft-capped configs: their step-0 loss on the card
# against the CPU's is printed (bit for bit or the gap); their scales and
# soft caps are held to the CPU's bits (check_scales_exact).
SCALED = ("gemma2-27b", "minicpm-2b", "command-r-35b")
# The probe's fidelity metrics, card against CPU: the global cosine within
# FID_COS_ATOL, a unit's cosine within UNIT_COS_ATOL, every other value
# within FID_RTOL (the synced gradients differ by the bf16 backward's
# rounding, as between the port and the reference on the CPU: 9e-6,
# 6.7e-5 and 2.6e-2 at most there, while a unit built from unaccumulated
# or misaligned rows reads 0.16 off or more,
# tests/test_torch_fidelity_train.py).
FID_COS_ATOL, UNIT_COS_ATOL, FID_RTOL = 1e-4, 1e-3, 5e-2
# One microbatch per step: block8+ef's residual is zero when the step's
# only microbatch reads it, so its step-0 loss is block8's bit for bit.
EF_ACCUM1 = {codec: _ref_args("deepseek-v3-moe", "loco", "--moe-a2a", codec,
                              "--global-batch", "2", "--steps", "1")
             for codec in ("block8", "block8+ef")}
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


def check_optimizers_exact() -> None:
    """lamb, adafactor (factored, a 1024 x 1024 leaf) and adafactor_flat
    updates of a 2^20-element leaf at steps 0-2, and the step's
    ``grad_norm`` and ``clip_scale`` (at clip 1.0 and 0.37), give the
    CPU's bits on the card: roots correctly rounded, reciprocal roots
    divided, norms and means summed in f64 and rounded once."""
    import torch

    from repro_torch.core.flatparam import MeshTopo, ParamGroup, ParamInfo
    from repro_torch.launch import mesh, steps
    from repro_torch.optim import optimizers as OPT

    gen = torch.Generator().manual_seed(19)
    shape = (1024, 1024)
    p, g = (torch.randn(shape, generator=gen) for _ in range(2))
    v = torch.randn(shape, generator=gen).abs() * 1e-2
    m = torch.randn(shape, generator=gen) * 1e-2
    lr = torch.tensor(1e-3)
    results = {}

    def tree(x, dev, flat):
        return {"g": {"w": (x.reshape(-1) if flat else x).to(dev)}}

    def leaves(x):
        if isinstance(x, dict):
            return [t for v in x.values() for t in leaves(v)]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in leaves(v)]
        return [x]

    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        out = []
        for step in range(3):
            for name, flat, state in (
                    ("lamb", True, lambda d: (tree(m, d, True),
                                              tree(v, d, True))),
                    ("adafactor_flat", True, lambda d: (tree(v, d, True),)),
                    ("adafactor", False, lambda d: (
                        (v[:, 0].to(d), v[0].to(d)),))):
                opt = OPT.OPTIMIZERS[name]()
                new, st = opt.update(tree(g, dev, flat), state(dev),
                                     tree(p, dev, flat), torch.tensor(step),
                                     lr, {"g": {"w": 1.0}})
                out += leaves(new) + leaves(st)
        groups = [ParamGroup("g", (ParamInfo("w", shape),), n_layers=None)]
        with mesh.dp_group(dev) as world:
            gn = steps.grad_norm(tree(g, dev, True), groups,
                                 MeshTopo.from_group(world), dev)
        out += [gn, OPT.clip_scale(gn, 1.0), OPT.clip_scale(gn, 0.37)]
        results[dev.type] = [x.cpu() for x in out]
    same = all(_same(a, b) for a, b in zip(results["cuda"],
                                           results["cpu"]))
    print(f"reference: lamb, adafactor, adafactor_flat at steps 0-2, the "
          f"step's gnorm {float(results['cuda'][-3]):.6f} and clip scales "
          f"on the card: {'bit for bit with the CPU' if same else 'DIFFER'}",
          flush=True)
    if not same:
        raise AssertionError("reference: an optimizer or the clip is not "
                             "the CPU's bits on the card")


def check_scales_exact() -> None:
    """gemma2's, minicpm's and command-r's embedding, residual and logit
    scales (``scale_by`` and the residual add on bf16) and soft caps
    (``soft_cap`` at 50 and 30, forward and backward, f32) give the CPU's
    bits on the card on the same inputs.  The unrounded scale and torch's
    tanh on the card must differ, or this check could not see the
    faults it guards against."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T

    gen = torch.Generator().manual_seed(20)
    x, d, g = (torch.randn(1 << 20, generator=gen) for _ in range(3))
    out = {}
    for dev in ("cuda", "cpu"):
        res = []
        xb, db = (x * 4).bfloat16().to(dev), d.bfloat16().to(dev)
        for arch in SCALED:
            cfg = get_arch(arch)
            for s in (cfg.emb_scale, cfg.logit_scale):
                if s:
                    res.append(C.scale_by(xb, s))
            if cfg.residual_scale:
                res.append(T._res(cfg, xb, db))
            for cap in (cfg.attn_softcap, cfg.final_softcap):
                if cap:
                    xf = (x * 20).to(dev).requires_grad_()
                    y = C.soft_cap(xf, cap)
                    y.backward(g.to(dev))
                    res += [y.detach(), xf.grad]
            if cfg.final_softcap:
                # the decode step's cap on its bf16 logits
                res.append(C.soft_cap((x * 20).bfloat16().to(dev),
                                      cfg.final_softcap))
        out[dev] = [r.cpu() for r in res]
    same = all(_same(a, b) for a, b in zip(out["cuda"], out["cpu"]))
    xb = (x * 4).bfloat16()
    s = get_arch("gemma2-27b").emb_scale
    raw = (xb.cuda() * s).cpu()
    tanh = (50.0 * torch.tanh(x.cuda() * 20 / 50.0)).cpu()
    seen = (not torch.equal(raw, C.scale_by(xb, s))
            and not torch.equal(tanh, C.soft_cap(x * 20, 50.0)))
    print(f"reference: {len(out['cpu'])} scale and soft-cap outputs of "
          f"{', '.join(SCALED)} on the card: "
          f"{'bit for bit with the CPU' if same else 'DIFFER'}; the "
          f"unrounded scale and torch's tanh "
          f"{'differ' if seen else 'DO NOT differ'}", flush=True)
    if not (same and seen):
        raise AssertionError("reference: a scale or soft cap on the card is "
                             "not the CPU's bits (or the check sees nothing)")


def check_fidelity(label, gpu: list, cpu: list) -> None:
    """The probe steps' fidelity metrics, card against CPU (``FID_*``)."""
    if len(gpu) != len(cpu) or not gpu or any(
            sorted(a) != sorted(b) for a, b in zip(gpu, cpu)):
        raise AssertionError(f"reference: {label}: fidelity keys differ")
    worst = {}
    for a, b in zip(gpu, cpu):
        for k in a:
            if not math.isfinite(a[k]):
                raise AssertionError(f"reference: {label}: {k} = {a[k]}")
            if k == "fidelity/cos":
                ok = abs(a[k] - b[k]) <= FID_COS_ATOL
            elif k.endswith("/fid_cos"):
                ok = abs(a[k] - b[k]) <= UNIT_COS_ATOL
            else:
                ok = abs(a[k] - b[k]) <= FID_RTOL * abs(b[k]) + 1e-6
            if not ok:
                raise AssertionError(f"reference: {label}: {k} card {a[k]} "
                                     f"cpu {b[k]}")
            kind = k if k.startswith("fidelity/") else k.rsplit("/", 1)[1]
            worst[kind] = max(worst.get(kind, 0.0), abs(a[k] - b[k]))
    first = {k: v for k, v in gpu[0].items() if k.startswith("fidelity/")}
    print(f"reference: {label}: fidelity metrics of {len(gpu)} probes "
          f"within the limits; largest gaps (a unit's: the largest of its "
          f"kind) {worst}; card step 0 "
          f"{first}", flush=True)


def reference_phase(src: Path) -> None:
    """Same seed, same batches, same weights (the init draws on the CPU):
    the card's run (CUDA kernels, NCCL, cuBLAS) must track the CPU run
    (plain versions, gloo; in :func:`cpu_pool`'s workers) within the
    port's model-level tolerance; and on the card, the bucketed sync under
    a uniform policy must give the monolithic run's losses bit for bit."""
    runs = {**REF_RUNS, "llama2-400m loco, accum 3": ACCUM3_ARGS}
    with cpu_pool(src) as pool:
        serve_cpu = submit_serve_cpu(pool)
        train_cpu = {label: pool.submit(_cpu_train, argv)
                     for label, argv in runs.items()}
        reference_card_side(serve_cpu, train_cpu)


def reference_card_side(serve_cpu: dict, train_cpu: dict) -> None:
    from repro_torch.launch import train

    check_divisions()
    check_optimizers_exact()
    check_scales_exact()
    serve_reference_runs(serve_cpu)
    ef = {c: train.main(a + ["--device", "cuda"])["losses"]
          for c, a in EF_ACCUM1.items()}
    print(f"reference: reduced deepseek-v3-moe, one microbatch, step 0 on "
          f"the card: block8 {ef['block8']}, block8+ef {ef['block8+ef']}",
          flush=True)
    if ef["block8"] != ef["block8+ef"]:
        raise AssertionError("reference: block8+ef's first microbatch is "
                             "not block8's")
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
    for label, fut in train_cpu.items():
        argv = REF_RUNS.get(label, ACCUM3_ARGS)
        g_res = (None if label == "llama2-400m loco" else
                 train.main(argv + ["--device", "cuda"]))
        gpu = mono if g_res is None else g_res["losses"]
        c_res = fut.result()
        cpu = c_res["losses"]
        if "--fidelity-every" in argv:
            check_fidelity(label, g_res["fidelity"], c_res["fidelity"])
        gaps = [abs(a - b) for a, b in zip(gpu, cpu)]
        step0 = (f"; step 0 {'bit for bit' if gaps[0] == 0 else 'differs'}"
                 if label.split()[0] in SCALED else "")
        print(f"reference: reduced {label}, card {gpu} vs cpu {cpu}; "
              f"gaps {gaps}; "
              f"{'bit for bit' if gpu == cpu else 'within the loss limits'}"
              f"{step0}", flush=True)
        if not (gaps[0] <= REF_STEP0_RTOL * abs(cpu[0])
                and max(gaps) <= REF_ATOL):
            raise AssertionError(f"reference: {label}: the card's losses "
                                 f"left the CPU run's (step 0 rtol "
                                 f"{REF_STEP0_RTOL}, all steps atol "
                                 f"{REF_ATOL})")


# ---------------------------------------------------------------------------
# phase 6: the dry run (launch/dryrun) against path a, and at the
# production meshes
# ---------------------------------------------------------------------------

# (a)'s limit on the dry run's predicted peak memory against path a's
# torch.cuda.max_memory_allocated(), relative, set before the first run
# (PERF.md section 6): the prediction counts every storage the step's ops
# create, rounded to the caching allocator's 512 bytes, and not cuBLAS's
# workspace or the allocator's own rounding of large blocks.
DRYRUN_PEAK_RTOL = 0.10
# (b): cells of the reference dry run, on fake CUDA tensors.  The MoE
# cell is mixtral-8x7b's: qwen3-moe-30b-a3b's (two steps of 8
# microbatches of 48 MoE layers) takes some 8 minutes of host time, which
# the script's budget does not hold; mixtral-8x7b's some 4
MOE_DRYRUN = "mixtral-8x7b"
PRODUCTION_DRYRUNS = {
    "llama2-400m train_4k 16x16": dict(arch="llama2-400m",
                                       shape_name="train_4k"),
    f"{MOE_DRYRUN} train_4k 2x16x16 --fidelity-every 4": dict(
        arch=MOE_DRYRUN, shape_name="train_4k", multi_pod=True,
        run_overrides={"fidelity_every": 4}),
}
DRYRUN_WORKERS = 2
# core/comm's and torch.distributed's collective calls (count_collectives)
# by the dry run's kind
COLLECTIVE_KINDS = {"all_reduce": "all-reduce",
                    "all_to_all_single": "all-to-all",
                    "_ALL_GATHER": "all-gather",
                    "all_gather_into_tensor": "all-gather",
                    "all_gather": "all-gather",
                    "_REDUCE_SCATTER": "reduce-scatter",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "reduce_scatter": "reduce-scatter"}


def long_dryrun_jobs(names=None) -> dict:
    """(d): each long serve path's prefill (or those of ``names``), its
    model (w cut to W_LAYERS layers) at its batch and prompt at world 1,
    on fake CUDA tensors."""
    return {f"path {name}, fake cuda": dict(serve=argv, cut=cut,
                                            device="cuda")
            for name, (argv, cut) in LONG_PATHS.items()
            if names is None or name in names}


def dryrun_jobs() -> dict:
    """The dry runs, longest first: the two production cells (b), path
    a's command on fake CUDA (a) and fake CPU tensors (c), and the long
    serve paths' prefills (d)."""
    jobs = {label: dict(kw, device="cuda")
            for label, kw in PRODUCTION_DRYRUNS.items()}
    for dev in ("cuda", "cpu"):
        jobs[f"path a, fake {dev}"] = dict(cli=TRAIN_ARGS, device=dev)
    jobs.update(long_dryrun_jobs())
    return jobs


def _dryrun_worker_init(src: str) -> None:
    import torch

    sys.path.insert(0, src)
    torch.set_num_threads(1)


def _dryrun(kw: dict) -> dict:
    """One dry run, in a worker: its record, its printed line, its host
    seconds, and ``torch.cuda.memory_allocated()`` before and after it
    (0 while the process has not initialized CUDA, which a dry run never
    needs) with whether it had."""
    import dataclasses
    import io

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train

    kw = dict(kw)
    cli = kw.pop("cli", None)
    serve_cli, cut = kw.pop("serve", None), kw.pop("cut", None)
    if serve_cli is not None:
        # a serve CLI command's prefill at world 1
        from repro_torch.launch import serve

        args = serve.build_args(serve_cli)
        cfg = serve.make_cfg(args)
        if cut:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        kw.update(arch=args.arch, shape_name="prefill_32k", cfg=cfg,
                  shape=ShapeConfig("prefill_32k", args.prompt_len,
                                    args.batch, "prefill"),
                  world=DR.parse_world("1x1"))
    if cli is not None:
        # a train CLI command at dp 1: its config, shape and RunConfig
        args = train.build_args(cli)
        run = train.make_run(args)
        kw.update(arch=args.arch, shape_name="cli", cfg=train.make_cfg(args),
                  shape=ShapeConfig("cli", args.seq_len, args.global_batch,
                                    "train"),
                  world=DR.parse_world("1x1"),
                  run_overrides={f.name: getattr(run, f.name)
                                 for f in dataclasses.fields(run)})
    m0 = torch.cuda.memory_allocated()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rec = DR.dryrun_one(**kw)
    return {"rec": rec, "line": out.getvalue().strip(),
            "s": time.perf_counter() - t0,
            "mem": (m0, torch.cuda.memory_allocated()),
            "cuda_init": torch.cuda.is_initialized()}


@contextlib.contextmanager
def dryrun_pool(src: Path):
    """The dry runs' worker processes (spawned); terminated on the way
    out, finished or not."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(
        DRYRUN_WORKERS, initializer=_dryrun_worker_init, initargs=(str(src),))
    try:
        yield pool
    finally:
        pool.terminate()
        pool.join()


def _dryrun_result(label: str, fut, t_phase: float) -> dict:
    res = fut.get()
    rec = res["rec"]
    print(f"dryrun: {label}: {res['line']}", flush=True)
    print(f"dryrun: {label}: {res['s']:.1f} s of host time in its worker "
          f"(trace {rec.get('trace_s')} s); collected "
          f"{time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)
    if rec["status"] != "ok":
        raise AssertionError(f"dryrun: {label}: {rec['status']}: "
                             f"{rec.get('traceback')}")
    return res


def check_long_peaks(res: dict, peaks: dict) -> None:
    """(d): each long serve path's peak memory within DRYRUN_PEAK_RTOL of
    its prefill's dry run (``long_dryrun_jobs``)."""
    for name, real in peaks.items():
        pred = res[f"path {name}, fake cuda"]["rec"]["memory"]["peak_bytes"]
        print(f"dryrun: (d) path {name}'s prefill: predicted peak "
              f"{pred / 2**30:.3f} GiB, path {name}'s max_memory_allocated "
              f"{real / 2**30:.3f} GiB ({pred / real - 1:+.2%}; limit "
              f"{DRYRUN_PEAK_RTOL:.0%})", flush=True)
        if abs(pred - real) > DRYRUN_PEAK_RTOL * real:
            raise AssertionError(f"dryrun: (d) path {name}'s predicted peak "
                                 "memory left its limit")


def dryrun_phase(dry: dict, path_a: dict, long_peaks: dict) -> None:
    """The card's memory is the report's fit mark (on an H100 80GB HBM3);
    (a) the dry run of path a's command on fake CUDA tensors predicts
    path a's run: its kernel launches and collectives per step exactly,
    its peak memory within DRYRUN_PEAK_RTOL of max_memory_allocated, and
    a roofline bound max(compute_s, memory_s) no longer than the traced
    step's device busy time; (b) the production dry runs finish on fake
    CUDA tensors without moving torch.cuda.memory_allocated() by 1 MiB;
    (c) path a's dry run on fake CPU tensors gives the same counts, FLOPs
    and bytes as on fake CUDA ones."""
    import torch
    from repro_torch.analysis import roofline as RL

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dryrun: {name}: total_memory {total:,} B; the report's fit "
          f"mark (analysis/roofline.HBM_BYTES) {RL.HBM_BYTES:,} B",
          flush=True)
    if name == "NVIDIA H100 80GB HBM3" and total != RL.HBM_BYTES:
        raise AssertionError("dryrun: roofline.HBM_BYTES is not this "
                             "card's memory")
    res = {label: _dryrun_result(label, fut, t_phase)
           for label, fut in dry.items()}
    a = res["path a, fake cuda"]["rec"]
    steps = len(path_a["losses"])
    per_step = {k: v / steps for k, v in path_a["launches"].items()}
    print(f"dryrun: (a) kernel launches per step: predicted {a['kernels']}, "
          f"path a {per_step}", flush=True)
    if a["kernels"] != per_step:
        raise AssertionError("dryrun: (a) the predicted kernel launches are "
                             "not path a's")
    coll: dict[str, float] = {}
    for name, n in path_a["collectives"].items():
        kind = COLLECTIVE_KINDS[name]
        coll[kind] = coll.get(kind, 0) + n / steps
    print(f"dryrun: (a) collectives per step: predicted "
          f"{a['collectives']['counts']}, path a {coll}", flush=True)
    if a["collectives"]["counts"] != coll:
        raise AssertionError("dryrun: (a) the predicted collectives are not "
                             "path a's")
    peak, real = a["memory"]["peak_bytes"], path_a["peak_mem_bytes"]
    print(f"dryrun: (a) peak memory: predicted {peak / 2**30:.3f} GiB, path "
          f"a's max_memory_allocated {real / 2**30:.3f} GiB "
          f"({peak / real - 1:+.2%}; limit {DRYRUN_PEAK_RTOL:.0%})",
          flush=True)
    if abs(peak - real) > DRYRUN_PEAK_RTOL * real:
        raise AssertionError("dryrun: (a) the predicted peak memory left "
                             "its limit")
    rf, t = a["roofline"], path_a["trace"]
    bound_ms = max(rf["compute_s"], rf["memory_s"]) * 1e3
    print(f"dryrun: (a) roofline: compute {rf['compute_s'] * 1e3:.2f} ms, "
          f"memory {rf['memory_s'] * 1e3:.2f} ms (dominant "
          f"{rf['dominant']}), wire {rf['collective_s'] * 1e3:.2f} ms; the "
          f"traced step's device busy time {t['device_busy_ms']:.1f} ms "
          f"({bound_ms / t['device_busy_ms']:.1%} of it)", flush=True)
    print(f"dryrun: (a) dispatched ops predicted per step {a['ops']}; the "
          f"traced step's device launches {t['device_launches']} (kernels, "
          "memcpys and memsets)", flush=True)
    if bound_ms > t["device_busy_ms"]:
        raise AssertionError("dryrun: (a) the roofline bound exceeds the "
                             "measured busy time: the count is wrong")
    for label in PRODUCTION_DRYRUNS:
        m0, m1 = res[label]["mem"]
        print(f"dryrun: (b) {label}: torch.cuda.memory_allocated() "
              f"{m0} -> {m1} B in its worker (CUDA initialized there: "
              f"{res[label]['cuda_init']})", flush=True)
        if abs(m1 - m0) >= 2**20:
            raise AssertionError(f"dryrun: (b) {label} moved the card's "
                                 "memory")
    c = res["path a, fake cpu"]["rec"]
    keys = ("ops", "flops_per_device", "hbm_bytes_per_device",
            "collectives", "kernels")
    same = all(a[k] == c[k] for k in keys)
    print(f"dryrun: (c) path a on fake CPU vs fake CUDA tensors: "
          f"{'the same' if same else 'DIFFERENT'} ops, FLOPs, bytes, "
          "collectives and kernels", flush=True)
    if not same:
        raise AssertionError("dryrun: (c) the device changed the plan: "
                             + str({k: (a[k], c[k]) for k in keys
                                    if a[k] != c[k]}))
    check_long_peaks(res, long_peaks)


if __name__ == "__main__":
    sys.exit(main())
