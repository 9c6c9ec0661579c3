"""Phase-level trace annotation for the sync path, and step-window traces.

Port of ``repro.telemetry.profiler``.  :func:`phase`: the sync phases
(``encode`` -> ``exchange`` -> ``decode`` in core/comm, ``apply`` and
``metrics`` in launch/steps) run inside ``torch.profiler.record_function``
ranges named ``loco/<phase>``, the names the reference gives its XLA
scopes, so a ``torch.profiler`` trace shows the comm structure by name.
The overlapped schedule tags each range with its stage
(``loco/encode/g1`` inside the window of ``loco/exchange/g0``'s
collectives is the overlap itself).  Outside a profiler the ranges cost
one cheap Python context manager each.

:class:`TraceSession` and :func:`parse_window` capture a
``torch.profiler`` trace of an inclusive step window (``--profile-steps
N:M`` in ``launch/train.py``) and write it as a Chrome trace into the
trace directory.  A failure to start or stop the profiler is a warning: it
never ends a training run.
"""
from __future__ import annotations

import os
import warnings

import torch


def phase(name: str, group: int | None = None):
    """Profiler range for one sync phase (nestable); ``group`` is the
    overlap-schedule stage index, named ``loco/<phase>/g<group>``."""
    if group is None:
        return torch.profiler.record_function(f"loco/{name}")
    return torch.profiler.record_function(f"loco/{name}/g{group}")


def parse_window(spec: str) -> tuple[int, int]:
    """``"N:M"`` (inclusive step window) or ``"N"`` (single step)."""
    try:
        if ":" in spec:
            a, b = spec.split(":")
            lo, hi = int(a), int(b)
        else:
            lo = hi = int(spec)
    except ValueError:
        raise ValueError(
            f"--profile-steps expects 'N:M' or 'N', got {spec!r}") from None
    if lo < 0 or hi < lo:
        raise ValueError(f"--profile-steps window {spec!r} is empty")
    return lo, hi


def window_summary(prof) -> dict:
    """Device work of a finished profile: ``device_busy_ms`` (kernels,
    memcpys and memsets; the GPU-side ``loco/*`` annotation ranges span
    such work and are none of their own), ``device_launches``, per
    ``loco/*`` range its GPU-side span in ms (``ranges``, empty without a
    card) and its host time in ms (``host_ranges``), and per kernel,
    memcpy or memset name its device ms and count (``kernels``).  Read
    from the profiler's raw events: ``key_averages()`` builds a Python
    event tree first, which takes seconds per 10^5 events."""
    from torch.autograd import DeviceType

    busy = launches = 0
    ranges: dict[str, float] = {}
    host: dict[str, float] = {}
    kernels: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        name, ms = e.name(), e.duration_ns() / 1e6
        if e.device_type() != DeviceType.CUDA:
            if name.startswith("loco/"):
                host[name] = host.get(name, 0.0) + ms
            continue
        if e.is_user_annotation():
            if name.startswith("loco/"):
                ranges[name] = ranges.get(name, 0.0) + ms
            continue
        busy += ms
        launches += 1
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += ms
        k[1] += 1
    return {"device_busy_ms": busy, "device_launches": launches,
            "ranges": ranges, "host_ranges": host, "kernels": kernels}


class TraceSession:
    """Run ``torch.profiler`` over a step window and write its Chrome trace
    to ``trace_dir/trace_steps_<lo>-<hi>[_rank<r>].json``; ``summary``
    then holds :func:`window_summary` of the window."""

    def __init__(self, trace_dir: str, window: tuple[int, int],
                 cuda: bool, rank: int = 0):
        self.trace_dir = trace_dir
        self.lo, self.hi = window
        self.cuda = cuda
        self.rank = rank
        self.prof = None
        self.path: str | None = None
        self.summary: dict | None = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def maybe_start(self, step: int) -> None:
        if self.active or step != self.lo:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except (OSError, RuntimeError) as e:
            warnings.warn(f"profiler start failed ({e}); continuing untraced")
            self.lo = -1  # don't retry every step
            return
        self.prof = prof
        print(f"profiler: tracing steps {self.lo}..{self.hi} "
              f"-> {self.trace_dir}", flush=True)

    def maybe_stop(self, step: int) -> None:
        if self.active and step >= self.hi:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        prof, self.prof = self.prof, None
        rank = f"_rank{self.rank}" if self.rank else ""
        path = os.path.join(self.trace_dir,
                            f"trace_steps_{self.lo}-{self.hi}{rank}.json")
        try:
            if self.cuda:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
        except (OSError, RuntimeError) as e:
            warnings.warn(f"profiler stop failed ({e})")
            return
        self.path = path
        self.summary = window_summary(prof)
        busy = (f"; device busy {self.summary['device_busy_ms']:.1f} ms "
                f"over {self.hi - self.lo + 1} step(s)" if self.cuda else "")
        print(f"profiler: trace written to {path}{busy}", flush=True)
