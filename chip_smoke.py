#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card; all phases

Phases, in order; any failure exits non-zero and prints no result:

1. print the card (``nvidia-smi`` name and power limit) and build every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the llama2-400m LoCo backward gives it, bit for bit; times
   (CUDA events) beside the HBM bound and the plain version's time;
3. train: ``repro_torch.launch.train`` trains full-width llama2-400m with
   ``--sync loco`` for 6 steps on a world-size-1 NCCL group; losses finite
   and falling, and every kernel launched 170 tensors x 2 microbatches x 6
   steps times during that run;
4. profile: one more full-width step under torch.profiler: device busy
   time by kernel class and the idle share (informational);
5. reference: a reduced llama2-400m trains 3 LoCo steps on the card and on
   the CPU (plain versions, gloo); the losses agree within 2e-2.

The last lines are the card, one ``{"kernels": [...]}`` JSON object and the
``{"ok": true, "device": ...}`` JSON object.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# LoCo tensor sizes of full-width llama2-400m and how many of each one
# backward syncs: 24 layers x (wq, wk, wv, wo) of 1024x1024, 24 x (w1, w2,
# w3) of 1024x2816, and tok + head of 32000x1024.
MAIN_SHAPES = {"attn": (1_048_576, 96), "mlp": (2_883_584, 72),
               "embed": (32_768_000, 2)}
LOCO_TENSORS = sum(c for _, c in MAIN_SHAPES.values())          # 170
TRAIN_ARGS = ["--arch", "llama2-400m", "--sync", "loco", "--seq-len", "1024",
              "--global-batch", "8", "--microbatch", "4", "--steps", "6",
              "--warmup", "1", "--log-every", "1"]
TRAIN_STEPS, TRAIN_ACCUM = 6, 2

# Device-memory rate by card (NVIDIA data sheets); peak FLOP/s are not
# needed: both kernels do a few flops per byte.
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


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def check_kernels(LQ, dev) -> dict:
    """Bit-exact comparisons of both kernels with their plain versions on
    the card at every main-path shape; returns the max |difference|."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"fused_compress": 0.0, "dequant_mean": 0.0}
    for shape_name, (n, _) in MAIN_SHAPES.items():
        g = _grad(n, gen, dev)
        for cell, bits, err, beta, escale in COMPRESS_CELLS:
            e = _err(n, err, gen, dev)
            kw = dict(bits=bits, beta=beta, escale=escale, err=err)
            got = LQ.fused_compress(g, e, **kw)
            want = LQ.fused_compress_plain(g, e, **kw)
            torch.cuda.synchronize()
            for k, w, what in zip(got, want, ("payload", "scales", "e_new")):
                worst["fused_compress"] = max(worst["fused_compress"],
                                              _max_abs(k, w))
                if not _same(k, w):
                    raise AssertionError(
                        f"fused_compress {cell} n={n}: {what} differs from "
                        f"the plain version (max |diff| {_max_abs(k, w)})")
            if err != "f8":
                continue
            payload, scales, _ = got
            for D in (1, 2, 4, 8):
                p2, s2 = payload.reshape(D, -1), scales.reshape(D, -1)
                out = LQ.dequant_mean(p2, s2, bits=bits)
                ref = LQ.dequant_mean_plain(p2, s2, bits=bits)
                torch.cuda.synchronize()
                worst["dequant_mean"] = max(worst["dequant_mean"],
                                            _max_abs(out, ref))
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"dequant_mean {bits}-bit D={D} n_chunk={n // D}: "
                        f"differs from the plain version "
                        f"(max |diff| {_max_abs(out, ref)})")
        print(f"kernels: {shape_name} n={n} bit-exact "
              f"({', '.join(c[0] for c in COMPRESS_CELLS)}; dequant_mean "
              f"D=1,2,4,8 at 4 and 8 bits)", flush=True)
    return worst


def compress_bytes(n: int) -> float:
    """Bytes fused_compress must move at 4 bits with f8 error: g f32 and e
    f8 read once; payload, e_new and scales written once."""
    return n * 4 + n + n / 2 + n + n / 256 * 4


def dequant_bytes(n: int, D: int = 1) -> float:
    """Bytes dequant_mean must move at 4 bits: D payload rows and scale rows
    read once, the f32 mean written once."""
    return D * (n / 2 + n / 256 * 4) + n * 4


def time_kernels(LQ, dev, rate: float) -> dict:
    """Kernel and plain-version time for the calls one LoCo backward makes
    (170 tensors, 4-bit, f8 error, D = 1), each call on its own cold
    buffers, plus per-shape medians."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    calls = []
    for n, count in MAIN_SHAPES.values():
        for _ in range(count):
            g = torch.randn(n, generator=gen, device=dev) * 1e-3
            e = torch.zeros(n, dtype=torch.float8_e4m3fn, device=dev)
            calls.append((g, e))
    kw = dict(bits=4, beta=0.5, escale=2.0**14, err="f8")
    wires = [LQ.fused_compress(g, e, **kw)[:2] for g, e in calls]
    recv = [(p.reshape(1, -1), s.reshape(1, -1)) for p, s in wires]

    def run(fn, args):
        def go():
            for a in args:
                fn(*a)
        return go

    out = {
        "fused_compress": dict(
            ms=cuda_ms(run(lambda g, e: LQ.fused_compress(g, e, **kw), calls), 5),
            plain_ms=cuda_ms(run(lambda g, e: LQ.fused_compress_plain(
                g, e, **kw), calls), 3),
            bound_ms=sum(compress_bytes(g.numel()) for g, _ in calls)
            / rate * 1e3),
        "dequant_mean": dict(
            ms=cuda_ms(run(lambda p, s: LQ.dequant_mean(p, s, bits=4), recv), 5),
            plain_ms=cuda_ms(run(lambda p, s: LQ.dequant_mean_plain(
                p, s, bits=4), recv), 3),
            bound_ms=sum(dequant_bytes(p.numel() * 2) for p, _ in recv)
            / rate * 1e3),
    }
    for name, t in out.items():
        print(f"kernels: {name} one backward (170 calls, 4-bit f8, D=1): "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.1%} of HBM rate), plain "
              f"{t['plain_ms']:.4f} ms", flush=True)
    del calls, wires, recv
    for shape_name, (n, _) in MAIN_SHAPES.items():
        g = torch.randn(n, generator=gen, device=dev) * 1e-3
        e = torch.zeros(n, dtype=torch.float8_e4m3fn, device=dev)
        p, s, _ = LQ.fused_compress(g, e, **kw)
        p, s = p.reshape(1, -1), s.reshape(1, -1)
        tc = cuda_ms(lambda: LQ.fused_compress(g, e, **kw), 20)
        tp = cuda_ms(lambda: LQ.fused_compress_plain(g, e, **kw), 5)
        td = cuda_ms(lambda: LQ.dequant_mean(p, s, bits=4), 20)
        tdp = cuda_ms(lambda: LQ.dequant_mean_plain(p, s, bits=4), 5)
        print(f"kernels: {shape_name} n={n}: fused_compress {tc * 1e3:.1f} us "
              f"(bound {compress_bytes(n) / rate * 1e6:.1f} us, plain "
              f"{tp * 1e3:.1f} us); dequant_mean {td * 1e3:.1f} us (bound "
              f"{dequant_bytes(n) / rate * 1e6:.1f} us, plain "
              f"{tdp * 1e3:.1f} us)", flush=True)
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import build
    from repro_torch.kernels import loco_quant as LQ

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {', '.join(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for b in built.values():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {b.name}: {line.strip()}")

    rate = hbm_rate(torch.cuda.get_device_name(0))
    worst = check_kernels(LQ, dev)
    timing = time_kernels(LQ, dev, rate)
    launches = train_phase(LQ)
    profile_phase()
    reference_phase()

    rows = []
    for name, line in (("fused_compress", 84), ("dequant_mean", 172)):
        t = timing[name]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/loco_quant.cu",
                     "replaces": f"src/repro/kernels/loco_quant.py:{line}",
                     "launches": launches[name],
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes", "library_ms": None})
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 3: the main path, through the training CLI
# ---------------------------------------------------------------------------

def train_phase(LQ) -> dict:
    """Train full-width llama2-400m with LoCo; returns the launch counts of
    that run alone."""
    from repro_torch.launch import train

    print(f"train: python -m repro_torch.launch.train {' '.join(TRAIN_ARGS)}",
          flush=True)
    LQ.reset_launches()
    res = train.main(TRAIN_ARGS)
    launches = dict(LQ.LAUNCHES)
    losses = res["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    want = LOCO_TENSORS * TRAIN_ACCUM * TRAIN_STEPS
    for name in ("fused_compress", "dequant_mean"):
        if launches.get(name, 0) != want:
            raise AssertionError(
                f"train: {name} launched {launches.get(name, 0)} times, "
                f"want {want} ({LOCO_TENSORS} LoCo tensors x {TRAIN_ACCUM} "
                f"microbatches x {TRAIN_STEPS} steps)")
    print(f"train: losses {losses}; {res['tok_per_s']:.1f} tok/s after the "
          f"first step; peak device memory "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    return launches


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "fused_compress" in low or "dequant_mean" in low:
        return "loco kernels (this repo)"
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_phase() -> None:
    """Where one full-width LoCo step spends device time: median wall time
    of two unprofiled steps, then one step under torch.profiler; device
    busy time is the sum of kernel times (informational: an empty trace is
    reported, not failed)."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.flatparam import MeshTopo
    from repro_torch.data.synthetic import DataConfig, make_batch_fn
    from repro_torch.launch import mesh, steps, train

    args = train.build_args(TRAIN_ARGS)
    cfg, run = get_arch(args.arch), train.make_run(args)
    dev = torch.device("cuda", 0)
    shape = ShapeConfig("smoke", args.seq_len, args.global_batch, "train")
    batch_fn = make_batch_fn(DataConfig(cfg.vocab, args.seq_len,
                                        args.global_batch, args.seed))
    with mesh.dp_group(dev) as group:
        topo = MeshTopo.from_group(group)
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
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile: step {wall_ms:.1f} ms unprofiled (median of 2, "
          f"{args.global_batch * args.seq_len / wall_ms * 1e3:.0f} tok/s); "
          f"kernels busy {busy_ms:.1f} ms in the profiled step; device idle "
          f"share {max(0.0, 1 - busy_ms / wall_ms):.1%}", flush=True)
    if not kernels:
        print("profile: the profiler saw no device time", flush=True)
        return
    by_class: dict[str, float] = {}
    for e in kernels:
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"profile: {c}: {ms:.1f} ms ({ms / busy_ms:.1%} of busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile: kernel {e.key[:90]} x{e.count}: "
              f"{e.self_device_time_total / 1e3:.2f} ms")
    for e in events:
        if e.key.startswith("loco/"):
            print(f"profile: range {e.key} x{e.count}: host "
                  f"{e.cpu_time_total / 1e3:.1f} ms, device "
                  f"{e.device_time_total / 1e3:.1f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on a small model
# ---------------------------------------------------------------------------

REF_ARGS = ["--arch", "llama2-400m", "--reduced", "--sync", "loco",
            "--seq-len", "32", "--global-batch", "8", "--microbatch", "2",
            "--steps", "3", "--warmup", "2", "--lr", "2e-3",
            "--log-every", "1"]
REF_STEP0_RTOL, REF_ATOL = 2e-3, 2e-2


def reference_phase() -> None:
    """Same seed, same batches, same weights (the init draws on the CPU):
    the card's run (CUDA kernels, NCCL, cuBLAS) must track the CPU run
    (plain versions, gloo) within the port's model-level tolerance."""
    from repro_torch.launch import train

    gpu = train.main(REF_ARGS + ["--device", "cuda"])["losses"]
    cpu = train.main(REF_ARGS + ["--device", "cpu"])["losses"]
    gaps = [abs(a - b) for a, b in zip(gpu, cpu)]
    print(f"reference: reduced llama2-400m loco, card {gpu} vs cpu {cpu}; "
          f"gaps {gaps}", flush=True)
    if not (gaps[0] <= REF_STEP0_RTOL * abs(cpu[0])
            and max(gaps) <= REF_ATOL):
        raise AssertionError("reference: the card's losses left the CPU "
                             f"run's (step 0 rtol {REF_STEP0_RTOL}, "
                             f"all steps atol {REF_ATOL})")


if __name__ == "__main__":
    sys.exit(main())
