"""What every kernel wrapper shares: the launch counter, the device rule
and the checks around a ctypes launch.

``LAUNCHES`` counts kernel launches (never plain-version calls) per kernel
name, across all kernel modules; each module re-exports it.  A wrapper
launches its kernel for a CUDA tensor and runs the plain version for a CPU
tensor; a tensor on any other device raises.

A fake tensor (a dry run's, ``launch/dryrun``) has shapes and no data:
the wrapper then returns empty outputs of the kernel's shapes and dtypes
and counts a planned launch in ``PLANNED`` (:func:`observed`).  A meta
tensor still raises, as any device without a kernel or a plain version.
While ``OBSERVER`` (an ``analysis.op_stats.OpStats``) records, each
wrapper call, on any tensor, is reported to it as one kernel op.
"""
from __future__ import annotations

import collections

import torch
from torch._subclasses.fake_tensor import FakeTensor

LAUNCHES: collections.Counter = collections.Counter()
# planned launches per kernel name: wrapper calls on fake tensors
PLANNED: collections.Counter = collections.Counter()
# the dry run's recorder while it records (analysis.op_stats), else None
OBSERVER = None


def reset_launches() -> None:
    LAUNCHES.clear()


def is_planned(t: torch.Tensor) -> bool:
    """A fake tensor: shapes without data, nothing to launch on."""
    return isinstance(t, FakeTensor)


def address(t: torch.Tensor) -> int:
    """``t.data_ptr()``; for a planned tensor its byte offset into its
    storage (a fake storage starts at address 0)."""
    if is_planned(t):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def same_start(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Do ``a`` and ``b`` start at the same memory?  Planned tensors: the
    same storage at the same offset."""
    if is_planned(a) or is_planned(b):
        return (a.untyped_storage() is b.untyped_storage()
                and address(a) == address(b))
    return a.data_ptr() == b.data_ptr()


def observed(name: str, nbytes: float, t: torch.Tensor, planned, real,
             flops: float = 0.0):
    """A wrapper's call on a planned tensor ``t`` or while ``OBSERVER``
    records: ``planned()`` (the outputs' shapes, no launch) on a fake
    ``t``, counted in ``PLANNED``; else ``real()``, the wrapper's own
    path, with ``OBSERVER`` unset meanwhile.  A recording ``OBSERVER``
    counts the call as one kernel moving ``nbytes`` and doing ``flops``."""
    global OBSERVER
    fake = is_planned(t)
    if fake:
        PLANNED[name] += 1
    obs = OBSERVER
    if obs is None:
        return planned()
    OBSERVER = None
    try:
        with obs.kernel(name, nbytes, flops):
            return planned() if fake else real()
    finally:
        OBSERVER = obs


def device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def check_aligned(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and 16-byte "
                             f"aligned (shape {tuple(t.shape)}, "
                             f"ptr {t.data_ptr():#x})")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the int ctypes passes.

    No device switch: a kernel launches on the current device, which every
    process of the port sets to its card (``launch/mesh.py``)."""
    return torch.cuda.current_stream(device).cuda_stream


def launched(rc: int, name: str) -> None:
    """Count one launch of ``name``; raise if the launch returned an error."""
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
