"""Phase-level trace annotation of the train step, the sync path and
serving; an allocator counter; step-window traces.

Port of ``repro.telemetry.profiler``, extended.  :func:`phase` opens a
``torch.profiler.record_function`` range named ``loco/<phase>``, the names
the reference gives its XLA scopes, so a ``torch.profiler`` trace shares
its clock with the device's work and names each phase.  The spans:

* ``loco/forward`` and ``loco/backward``: each microbatch's loss and its
  backward (``launch/steps.make_train_step``; the backward's recomputed
  forward and the gradient sync run inside it, and a ``block8+ef`` MoE's
  residual store).  :func:`backward` opens the latter on the thread that
  runs the backward, so that on a card it spans the kernels that thread
  launches;
* ``loco/gather``: ``core/flatparam.materialize``, the bf16 cast and the
  FSDP gather's forward, in the forward and again wherever remat
  recomputes a layer;
* ``loco/encode`` -> ``loco/exchange`` -> ``loco/decode``: the gradient
  sync (core/comm), inside the backward.  The overlapped schedule tags
  each with its stage (``loco/encode/g1`` inside the window of
  ``loco/exchange/g0``'s collectives is the overlap itself);
* ``loco/clip``: the gradient stack and mean over the microbatches, the
  global norm and the clip multiply (under ``--telemetry`` or a probe
  step, ``loco/metrics`` and ``loco/probe`` nest inside it);
* ``loco/apply``: the optimizer update; ``loco/metrics``: the telemetry
  sums (``--telemetry``); ``loco/probe``: a fidelity probe's reference
  (``--fidelity-every``);
* ``loco/serve/prefill`` and ``loco/serve/decode``: one prompt batch's
  prefill, one decode step with its greedy pick (``make_prefill_step``,
  ``make_decode_step``).

Outside a profiler :func:`phase` returns the one shared :data:`NOOP`
context and :func:`backward` hooks nothing, so an untraced step pays a
flag check per range.

:data:`COUNTERS`: the caching allocator's calls to CUDA for device memory
during traced train steps on a card, the change over each step of
``torch.cuda.memory_stats``' ``num_alloc_retries`` (failed
``cudaMalloc`` calls that flushed the cache and retried),
``num_device_alloc`` and ``num_device_free`` (the calls that map or
allocate device memory, and that unmap or free it: ``cuMemMap`` and
``cudaMalloc``, ``cuMemUnmap`` and ``cudaFree``), each summed under its
own key (:func:`alloc_counts`, :func:`count_alloc`).  An untraced step
reads nothing.

:class:`TraceSession` and :func:`parse_window` capture a
``torch.profiler`` trace of an inclusive step window (``--profile-steps
N:M`` in ``launch/train.py``, a decode step ``--profile-steps N`` in
``launch/serve.py``) and write it as a Chrome trace into the trace
directory, where the spans above show by name.  A failure to start or stop
the profiler is a warning: it never ends a training run.
"""
from __future__ import annotations

import contextlib
import os
import warnings

import torch

NOOP = contextlib.nullcontext()
ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free")
COUNTERS: dict[str, int] = {}


def phase(name: str, group: int | None = None):
    """Profiler range for one phase (nestable); ``group`` is the
    overlap-schedule stage index, named ``loco/<phase>/g<group>``.
    :data:`NOOP` when no profiler runs."""
    if not torch.autograd._profiler_enabled():
        return NOOP
    if group is None:
        return torch.profiler.record_function(f"loco/{name}")
    return torch.profiler.record_function(f"loco/{name}/g{group}")


def backward(loss: torch.Tensor, then=None) -> None:
    """``loss.backward()`` and then ``then()``, inside ``loco/backward``.

    A card's backward kernels are launched by the autograd engine's device
    thread, and a range spans on the device only the work launched from
    the thread that opened it.  So under a profiler the range is opened by
    a pre-hook of ``loss.grad_fn``, which runs on the thread that runs the
    backward, and closed, after ``then()``, by a callback that the engine
    runs when the backward has finished, on the thread that finished it
    (the same one: every node of the step's graph is on one device)."""
    if not torch.autograd._profiler_enabled() or loss.grad_fn is None:
        loss.backward()
        if then is not None:
            then()
        return
    rf = torch.profiler.record_function("loco/backward")

    def close():
        if then is not None:
            then()
        rf.__exit__(None, None, None)

    def open_(grad_outputs):
        rf.__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(close)

    hook = loss.grad_fn.register_prehook(open_)
    try:
        loss.backward()
    finally:
        hook.remove()


def alloc_counts(device: torch.device) -> dict[str, int] | None:
    """The allocator's :data:`ALLOC_KEYS` so far on ``device`` while a
    profiler runs on a card; None otherwise (nothing to count)."""
    if device.type != "cuda" or not torch.autograd._profiler_enabled():
        return None
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ALLOC_KEYS}


def count_alloc(before: dict[str, int] | None,
                device: torch.device) -> None:
    """Add each key's change since ``before`` (:func:`alloc_counts`) to
    :data:`COUNTERS`."""
    if before is None:
        return
    stats = torch.cuda.memory_stats(device)
    for k, v in before.items():
        COUNTERS[k] = COUNTERS.get(k, 0) + stats.get(k, 0) - v


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
