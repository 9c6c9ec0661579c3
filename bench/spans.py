"""Readers of the program's own phase spans and allocator counter.

The program names its phases with ``torch.profiler`` ranges (``loco/*``,
``repro_torch.telemetry.profiler``), which :func:`bench.trace.summary`
collects as a device-side span (``ranges``) and a host time
(``host_ranges``) per name, and counts the caching allocator's calls
that map, allocate or free device memory during traced train steps in
that module's ``COUNTERS``.  Each
reader gives None where the run has nothing for it: an untraced run,
another kind of cell, or a program without the span or the counter.
"""
from __future__ import annotations

import sys

PROFILER = "repro_torch.telemetry.profiler"


def device_ms(ctx, kind: str, name: str) -> float | None:
    """The device-side span of range ``name``, ms per traced step or
    request."""
    s = ctx["trace"]
    if ctx["kind"] != kind or s is None or name not in s["ranges"]:
        return None
    return s["ranges"][name] / ctx["trace_units"]


def host_ms(ctx, kind: str, name: str) -> float | None:
    """The host time in range ``name``, ms per traced step or request."""
    s = ctx["trace"]
    if ctx["kind"] != kind or s is None or name not in s["host_ranges"]:
        return None
    return s["host_ranges"][name] / ctx["trace_units"]


def counter_per_step(ctx) -> float | None:
    """The program's ``COUNTERS`` summed over its keys, per traced train
    step; the program adds to them only in traced steps on a card."""
    counters = getattr(sys.modules.get(PROFILER), "COUNTERS", None)
    if ctx["kind"] != "train" or ctx["trace"] is None or not counters:
        return None
    return sum(counters.values()) / ctx["trace_units"]
