#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card; all phases

Phases, in order; any failure exits non-zero and prints no result:

1. print the card (``nvidia-smi`` name and power limit) and build every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` with nvcc (one process per
   source, all at once);
2. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit: ``fused_compress``/``dequant_mean`` at every chunk length the
   llama2-400m and deepseek-v3-moe LoCo backwards give them (derived from
   the parameter declarations, ``loco_sizes``), ``act_encode``/
   ``act_decode`` at the deepseek-v3-moe exchange (81,920 rows of 512),
   ``onebit_pack`` at the onebit path's shapes; times (CUDA events) beside the HBM bound, the
   plain version's time and, for ``act_decode``, the one PyTorch call that
   computes the same function;
3. train, three paths through ``repro_torch.launch.train`` on a
   world-size-1 NCCL group, each with the launch counters zeroed just
   before it and read just after:
   a. full-width llama2-400m, ``--sync loco``, 6 steps;
   b. full-width, full-depth deepseek-v3-moe, ``--sync loco --moe-a2a
      block8``, 6 steps;
   c. full-width llama2-400m, ``--sync onebit``, 3 steps;
   losses finite (and falling on a and b), and every kernel of the path
   launched as often as the code says (counts derived from the parameter
   declarations and the layer structure, below);
4. profile: one more full-width step of paths a and b under
   torch.profiler: device busy time by kernel class and the idle share
   (informational);
5. reference: reduced llama2-400m (loco and onebit) and reduced
   deepseek-v3-moe (loco, block8) train 3 steps on the card and on the CPU
   (plain versions, gloo); the losses agree within 2e-3 relative at step 0
   and 2e-2 at every step.

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


def _train_args(arch, sync, steps, *extra):
    return ["--arch", arch, "--sync", sync, "--seq-len", "1024",
            "--global-batch", "8", "--microbatch", "4", "--steps", str(steps),
            "--warmup", "1", "--log-every", "1", *extra]


TRAIN_ARGS = _train_args("llama2-400m", "loco", 6)
MOE_ARGS = _train_args("deepseek-v3-moe", "loco", 6, "--moe-a2a", "block8")
ONEBIT_ARGS = _train_args("llama2-400m", "onebit", 3)
# Each MoE layer exchanges its slot buffer twice (dispatch, combine); each
# exchange runs once in the forward, once in the checkpoint's recomputation
# and once in the backward (the cotangent rides the same wire), and calls
# act_encode and act_decode once each time.
EXCHANGES_PER_MOE_LAYER = 2 * 3


def loco_sizes(argv) -> dict[int, int]:
    """Chunk length -> how many tensors of that length one backward of the
    training run ``argv`` hands the gradient codec (fused_compress and
    dequant_mean, or onebit_pack), from the parameter declarations. At dp =
    1 a chunk is the whole padded tensor: llama2-400m gives 1,048,576 (x96),
    2,883,584 (x72) and 32,768,000 (x2); deepseek-v3-moe adds 33,554,432
    (the 64 x 1024 x 512 experts), 262,144 (GQA wk, wv) and 65,536 (the
    router)."""
    from repro_torch.launch import train
    from repro_torch.models.transformer import build_groups

    sizes: dict[int, int] = {}
    for g in build_groups(train.make_cfg(train.build_args(argv)), 1):
        for i in g.infos:
            if i.loco:
                n = i.chunklen(1, 1)
                sizes[n] = sizes.get(n, 0) + (g.n_layers or 1)
    return dict(sorted(sizes.items()))


def loco_path_sizes() -> list[int]:
    """Every chunk length the two LoCo paths (llama, deepseek) launch
    fused_compress and dequant_mean at."""
    return sorted(set(loco_sizes(TRAIN_ARGS)) | set(loco_sizes(MOE_ARGS)))

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
    the card at every chunk length the llama and deepseek LoCo paths give
    them (``loco_path_sizes``); returns the max |difference|."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"fused_compress": 0.0, "dequant_mean": 0.0}
    for n in loco_path_sizes():
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
        print(f"kernels: n={n} bit-exact "
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
    """Kernel and plain-version time for the calls one llama2-400m LoCo
    backward makes (170 tensors, 4-bit, f8 error, D = 1), each call on its
    own cold buffers, plus per-shape medians at every LoCo path's shapes."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    calls = []
    for n, count in loco_sizes(TRAIN_ARGS).items():
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
        print(f"kernels: {name} one backward ({len(calls)} calls, 4-bit f8, "
              f"D=1): "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.1%} of HBM rate), plain "
              f"{t['plain_ms']:.4f} ms", flush=True)
    del calls, wires, recv
    for n in loco_path_sizes():
        g = torch.randn(n, generator=gen, device=dev) * 1e-3
        e = torch.zeros(n, dtype=torch.float8_e4m3fn, device=dev)
        p, s, _ = LQ.fused_compress(g, e, **kw)
        p, s = p.reshape(1, -1), s.reshape(1, -1)
        tc = cuda_ms(lambda: LQ.fused_compress(g, e, **kw), 20)
        tp = cuda_ms(lambda: LQ.fused_compress_plain(g, e, **kw), 5)
        td = cuda_ms(lambda: LQ.dequant_mean(p, s, bits=4), 20)
        tdp = cuda_ms(lambda: LQ.dequant_mean_plain(p, s, bits=4), 5)
        print(f"kernels: n={n}: fused_compress {tc * 1e3:.1f} us "
              f"(bound {compress_bytes(n) / rate * 1e6:.1f} us, plain "
              f"{tp * 1e3:.1f} us); dequant_mean {td * 1e3:.1f} us (bound "
              f"{dequant_bytes(n) / rate * 1e6:.1f} us, plain "
              f"{tdp * 1e3:.1f} us)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 2, continued: the activation wire and the onebit wire
# ---------------------------------------------------------------------------

def moe_exchange_rows() -> int:
    """Rows of 512 that one deepseek-v3-moe exchange quantizes at seq 1024,
    microbatch 4: 64 experts x 640 slots x 1024 / 512 = 81,920."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core import act_comm

    g = act_comm.a2a_geometry(get_arch("deepseek-v3-moe"), 4 * 1024, 1)
    return g["n_pad"] // act_comm.ACT_BLOCK


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


def kernel_act(AQ, dev, rate: float) -> dict:
    """act_encode / act_decode at the deepseek-v3-moe exchange: bit-exact
    against the plain versions (and the decode against ``q / scale``), then
    timed per call."""
    import torch

    rows = moe_exchange_rows()
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

    def per_call(fn, *args, reps=5, calls=10):
        # back-to-back calls between the events, so the card, not the
        # host's per-call work, sets the time; the 168 MB input exceeds L2
        def go():
            for _ in range(calls):
                fn(*args)
        return cuda_ms(go, reps) / calls

    res = {
        "act_encode": dict(
            max_abs_err=max(_max_abs(q, pq), _max_abs(s, ps)),
            ms=per_call(AQ.act_encode, h),
            plain_ms=per_call(AQ.act_encode_plain, h, reps=3),
            bound_ms=bound, library_ms=None),
        "act_decode": dict(
            max_abs_err=_max_abs(out, ref),
            ms=per_call(AQ.act_decode, q, s),
            plain_ms=per_call(AQ.act_decode_plain, q, s, reps=3),
            bound_ms=bound,
            library_ms=per_call(lambda a, b: a / b[:, None], q, s)),
    }
    for name, t in res.items():
        lib_s = (f", q / scale {t['library_ms'] * 1e3:.1f} us"
                 if t["library_ms"] is not None else "")
        print(f"kernels: {name} rows={rows} bit-exact; {t['ms'] * 1e3:.1f} us "
              f"per call, bound {t['bound_ms'] * 1e3:.1f} us "
              f"({t['bound_ms'] / t['ms']:.1%} of HBM rate), plain "
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

    res = dict(max_abs_err=worst, ms=cuda_ms(run(SP.onebit_pack), 5),
               plain_ms=cuda_ms(run(SP.onebit_pack_plain), 3),
               bound_ms=sum(onebit_bytes(h.numel()) for h, _ in calls)
               / rate * 1e3, library_ms=None)
    print(f"kernels: onebit_pack one backward ({len(calls)} calls): "
          f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_ms'] / res['ms']:.1%} of HBM rate), plain "
          f"{res['plain_ms']:.4f} ms", flush=True)
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
    t_start = time.perf_counter()

    from repro_torch.kernels import act_quant as AQ
    from repro_torch.kernels import build
    from repro_torch.kernels import loco_quant as LQ
    from repro_torch.kernels import sign_pack as SP

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
    for name in timing:
        timing[name].update(max_abs_err=worst[name], library_ms=None)
    timing.update(kernel_act(AQ, dev, rate))
    timing["onebit_pack"] = kernel_onebit(SP, dev, rate)
    torch.cuda.empty_cache()
    print(f"kernels: phase done at {time.perf_counter() - t_start:.0f} s",
          flush=True)

    launches = train_phase(LQ)
    for args in (TRAIN_ARGS, MOE_ARGS):
        profile_phase(args)
    reference_phase()

    rows = []
    for name, src, replaces in KERNEL_ROWS:
        t = timing[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes", "library_ms": t["library_ms"]})
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

def expected_launches(argv) -> dict:
    """Launches each kernel of a training run must make, from the code: per
    microbatch backward one fused_compress and one dequant_mean per LoCo
    tensor (one onebit_pack with --sync onebit), and per MoE layer and
    microbatch EXCHANGES_PER_MOE_LAYER act_encode and act_decode."""
    from repro_torch.launch import train

    args = train.build_args(argv)
    cfg = train.make_cfg(args)
    runs = args.steps * (args.global_batch // args.microbatch)
    loco = sum(loco_sizes(argv).values())
    want = ({"onebit_pack": loco * runs} if args.sync == "onebit" else
            {"fused_compress": loco * runs, "dequant_mean": loco * runs})
    if cfg.family == "moe" and cfg.moe_a2a_codec == "block8":
        acts = EXCHANGES_PER_MOE_LAYER * cfg.n_layers * runs
        want.update(act_encode=acts, act_decode=acts)
    return want


def train_path(LQ, argv, falls: bool) -> dict:
    """Train once through the CLI with the launch counters zeroed just
    before and read just after; returns that run's launch counts."""
    import torch
    from repro_torch.launch import train

    print(f"train: python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    want = expected_launches(argv)
    t0 = time.perf_counter()
    LQ.reset_launches()
    res = train.main(argv)
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
    router = (f"; moe_aux {res['moe_aux']}; moe_z {res['moe_z']}"
              if res["moe_aux"] else "")
    print(f"train: losses {losses}{router}; {res['tok_per_s']:.1f} tok/s "
          f"after the first step; peak device memory "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; launches {launches} "
          f"(as derived); {secs:.0f} s", flush=True)
    torch.cuda.empty_cache()
    return launches


def train_phase(LQ) -> dict:
    """The three main paths; returns every kernel's launches summed over
    them."""
    total: dict[str, int] = {}
    for argv, falls in ((TRAIN_ARGS, True), (MOE_ARGS, True),
                        (ONEBIT_ARGS, False)):
        for k, v in train_path(LQ, argv, falls).items():
            total[k] = total.get(k, 0) + v
    missing = [name for name, _, _ in KERNEL_ROWS if not total.get(name)]
    if missing:
        raise AssertionError(f"train: kernels never launched: {missing}")
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
    return "other (elementwise, reductions, copies)"


def profile_phase(argv) -> None:
    """Where one full-width step spends device time: median wall time of
    two unprofiled steps, then one step under torch.profiler; device busy
    time is the sum of kernel times (informational: an empty trace is
    reported, not failed)."""
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
    tag = f"profile[{cfg.name}]"
    with mesh.dp_group(dev) as group:
        topo = MeshTopo.from_group(group, model=mesh.model_group(cfg))
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
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{tag}: step {wall_ms:.1f} ms unprofiled (median of 2, "
          f"{args.global_batch * args.seq_len / wall_ms * 1e3:.0f} tok/s); "
          f"kernels busy {busy_ms:.1f} ms in the profiled step; device idle "
          f"share {max(0.0, 1 - busy_ms / wall_ms):.1%}", flush=True)
    if not kernels:
        print(f"{tag}: the profiler saw no device time", flush=True)
        return
    by_class: dict[str, float] = {}
    for e in kernels:
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"{tag}: {c}: {ms:.1f} ms ({ms / busy_ms:.1%} of busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"{tag}: kernel {e.key[:90]} x{e.count}: "
              f"{e.self_device_time_total / 1e3:.2f} ms")
    for e in kernels:
        if any(k in e.key.lower() for k in KERNEL_NAMES):
            print(f"{tag}: kernel {e.key[:60]} x{e.count}: "
                  f"{e.self_device_time_total / 1e3:.2f} ms")
    for e in events:
        if e.key.startswith("loco/"):
            print(f"{tag}: range {e.key} x{e.count}: host "
                  f"{e.cpu_time_total / 1e3:.1f} ms, device "
                  f"{e.device_time_total / 1e3:.1f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on small models
# ---------------------------------------------------------------------------

def _ref_args(arch, sync, *extra):
    return ["--arch", arch, "--reduced", "--sync", sync, "--seq-len", "32",
            "--global-batch", "8", "--microbatch", "2", "--steps", "3",
            "--warmup", "2", "--lr", "2e-3", "--log-every", "1", *extra]


REF_RUNS = {"llama2-400m loco": _ref_args("llama2-400m", "loco"),
            "deepseek-v3-moe loco block8": _ref_args(
                "deepseek-v3-moe", "loco", "--moe-a2a", "block8"),
            "llama2-400m onebit": _ref_args("llama2-400m", "onebit")}
REF_STEP0_RTOL, REF_ATOL = 2e-3, 2e-2


def reference_phase() -> None:
    """Same seed, same batches, same weights (the init draws on the CPU):
    the card's run (CUDA kernels, NCCL, cuBLAS) must track the CPU run
    (plain versions, gloo) within the port's model-level tolerance."""
    from repro_torch.launch import train

    for label, argv in REF_RUNS.items():
        gpu = train.main(argv + ["--device", "cuda"])["losses"]
        cpu = train.main(argv + ["--device", "cpu"])["losses"]
        gaps = [abs(a - b) for a, b in zip(gpu, cpu)]
        print(f"reference: reduced {label}, card {gpu} vs cpu {cpu}; "
              f"gaps {gaps}", flush=True)
        if not (gaps[0] <= REF_STEP0_RTOL * abs(cpu[0])
                and max(gaps) <= REF_ATOL):
            raise AssertionError(f"reference: {label}: the card's losses "
                                 f"left the CPU run's (step 0 rtol "
                                 f"{REF_STEP0_RTOL}, all steps atol "
                                 f"{REF_ATOL})")


if __name__ == "__main__":
    sys.exit(main())
