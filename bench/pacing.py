"""How the host paced a training window: each step's time (from one loss
read back to the next) and the interpreter's collections in it.

A step that the host dispatches repeats only as well as the host does, so
a run keeps what tells the sources of a spread apart: steps that stall
within a run (and whether a collection lines up with them), a transient
in the window's first steps, and a slower pace in some processes (each
run's median step).  Everything here is read once per step or per
collection, and nothing of it is a device number.
"""
from __future__ import annotations

import bisect
import gc
import os
import statistics
import time

FIRST = 3  # the window's first steps, reported apart from the rest
OUTLIER = 1.2  # a step over this many times the run's median stalled


class Collections:
    """The interpreter's collections while the object is entered: each
    one's generation, start (``time.perf_counter``) and seconds."""

    def __init__(self):
        self.events: list[tuple[int, float, float]] = []
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._start = now
        else:
            self.events.append((info["generation"], self._start,
                                now - self._start))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def quartiles(xs: list[float]) -> tuple[float, float, float]:
    """(q1, median, q3) as ``statistics.quantiles(xs, n=4)`` gives them;
    a single value is its own quartiles."""
    if len(xs) < 2:
        return (xs[0],) * 3
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return q1, q2, q3


def summary(times: list[float], t_start: float,
            events: list[tuple[int, float, float]]) -> dict:
    """The window's step times (seconds, back to back from ``t_start``)
    with the collections that fell in them."""
    if not times:
        return {"count": 0}
    q1, med, q3 = quartiles(times)
    ends, t = [], t_start
    for x in times:
        t += x
        ends.append(t)
    in_step = [0.0] * len(times)
    by_gen: dict[int, list[float]] = {}
    for gen, start, dur in events:
        by_gen.setdefault(gen, []).append(dur)
        i = bisect.bisect_right(ends, start)
        if i < len(times):
            in_step[i] += dur
    slow = [i for i, x in enumerate(times) if x > OUTLIER * med]
    rest = times[FIRST:]
    return {"count": len(times), "median": med, "q1": q1, "q3": q3,
            "min": min(times), "max": max(times),
            "first": times[:FIRST],
            "rest_median": statistics.median(rest) if rest else None,
            "outliers": slow,
            "gc": {g: [len(d), sum(d), max(d)]
                   for g, d in sorted(by_gen.items())},
            "gc_s_in_outliers": sum(in_step[i] for i in slow)}


def line(s: dict, times: list[float]) -> str:
    """One line for standard error: the summary, the CPUs the process may
    run on, and every step's time."""
    if not s["count"]:
        return "window steps: none"
    f = ", ".join(f"{x:.4f}" for x in s["first"])
    gcs = "; ".join(f"gen{g} {n} in {t:.4f} s (max {m:.4f})"
                    for g, (n, t, m) in s["gc"].items()) or "none"
    ahead = f" ({s['ahead']} dispatched ahead)" if "ahead" in s else ""
    return (f"window steps: {s['count']}{ahead}, median {s['median']:.4f} s, "
            f"q1 {s['q1']:.4f}, q3 {s['q3']:.4f}, min {s['min']:.4f}, "
            f"max {s['max']:.4f}; first {f}; rest median "
            f"{s['rest_median'] or float('nan'):.4f}; over {OUTLIER}x median: "
            f"{len(s['outliers'])}, with {s['gc_s_in_outliers']:.4f} s "
            f"of collections; collections: {gcs}; cpus "
            f"{sorted(os.sched_getaffinity(0))}; steps "
            + " ".join(f"{x:.4f}" for x in times))
