"""Reading a ``torch.profiler`` window: the benchmark's own copy.

:func:`summary` is the program's ``telemetry/profiler.window_summary``
(device time and count per kernel, memcpy and memset name; GPU-side and
host time per ``loco/*`` range), read from the profiler's raw events, with
what the benchmark adds: the device's busy time as the union of its
operations' intervals (so overlapping streams are not counted twice), the
ten operations that took most device time, and the idle gaps on the
device (the ``gaps_scanned`` longest) summed by the innermost host range
or operator that was running when each began; the CUDA runtime's own
calls (``cuda*``) are left out of that look, so a gap is named by the
operator that launched into it.
"""
from __future__ import annotations

import numpy as np

KERNEL_NAMES = ("fused_compress", "dequant_mean", "onebit_pack",
                "act_encode", "act_decode", "attention_fwd",
                "attention_bwd_dq", "attention_bwd_dkdv")
MATMUL = ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")


def kernel_class(name: str) -> str:
    """The class of one device operation by its name.  cuBLAS's Hopper
    kernels are named ``nvjet_*`` and count as matmuls."""
    low = name.lower()
    if any(k in low for k in KERNEL_NAMES):
        return "kernels (this repo)"
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in MATMUL):
        return "matmul"
    if "copy" in low or low.startswith("memcpy"):
        return "dtype copies and memcpy"
    return "other (elementwise, reductions, fills)"


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summary(prof, top: int = 10, gaps_scanned: int = 400) -> dict:
    from torch.autograd import DeviceType

    ranges: dict[str, float] = {}
    host_ranges: dict[str, float] = {}
    kernels: dict[str, list] = {}
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name, ns, t0 = e.name(), e.duration_ns(), e.start_ns()
        ms = ns / 1e6
        if e.device_type() != DeviceType.CUDA:
            if name.startswith("loco/"):
                host_ranges[name] = host_ranges.get(name, 0.0) + ms
            if not name.startswith("cuda"):
                host.append((t0, t0 + ns, name or "(unnamed host event)"))
            continue
        if e.is_user_annotation():
            if name.startswith("loco/"):
                ranges[name] = ranges.get(name, 0.0) + ms
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += ms
        k[1] += 1
        dev.append((t0, t0 + ns))
    busy = _union(dev)
    busy_ns = sum(e - s for s, e in busy)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    by_host: dict[str, float] = {}
    for length, t in gaps[:gaps_scanned]:
        live = np.flatnonzero((hs <= t) & (he >= t))
        key = (host[live[np.argmin(he[live] - hs[live])]][2] if live.size
               else "(no host range)")
        by_host[key] = by_host.get(key, 0.0) + length / 1e9
    ops = sorted(((n, v[0] / 1e3) for n, v in kernels.items()),
                 key=lambda x: -x[1])[:top]
    idle = sorted(by_host.items(), key=lambda x: -x[1])[:top]
    return {"busy_s": busy_ns / 1e9, "device_launches": len(dev),
            "ranges": ranges, "host_ranges": host_ranges,
            "kernels": kernels,
            "breakdown": {"device_ops": [list(x) for x in ops],
                          "idle_gaps": [list(x) for x in idle]}}


def class_ms(summ: dict, cls: str) -> float:
    """Device ms of the operations of class ``cls`` in a summary."""
    return sum(v[0] for n, v in summ["kernels"].items()
               if kernel_class(n) == cls)


def kernel_calls(summ: dict, part: str) -> tuple[float, int]:
    """(device ms, calls) of the kernels whose name holds ``part``."""
    hits = [v for n, v in summ["kernels"].items() if part in n]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def idle_share(ctx) -> float | None:
    """% of the traced window's wall time with nothing on the device."""
    s = ctx["trace"]
    if s is None or not s["busy_s"] or not ctx["trace_window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / ctx["trace_window_s"])


def kernel_roofline(ctx, kernel: str, kind: str) -> float | None:
    """% of the HBM bound that the traced calls of ``kernel`` reach: the
    bytes of every sync the traced steps make (``flops.loco_lengths``, per
    microbatch) over the calls' device time.  Nothing to read unless the
    calls counted are exactly those syncs."""
    from bench import flops as FL

    s = ctx["trace"]
    if ctx["kind"] != "train" or s is None or ctx["traffic"]["sync"] != "loco":
        return None
    ms, calls = kernel_calls(s, kernel)
    lengths = FL.loco_lengths(ctx["config"], ctx["traffic"])
    per = ctx["trace_units"] * ctx["accum"]
    if not calls or calls != per * len(lengths):
        return None
    size = FL.compress_bytes if kind == "compress" else FL.dequant_bytes
    nbytes = per * sum(size(n) for n in lengths)
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / (ms / 1e3)


def sync(device) -> None:
    """Wait for the card (there is nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler(device):
    """A ``torch.profiler`` of the host and, on a card, of the device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
