"""What every kernel wrapper shares: the launch counter, the device rule
and the checks around a ctypes launch.

``LAUNCHES`` counts kernel launches (never plain-version calls) per kernel
name, across all kernel modules; each module re-exports it.  A wrapper
launches its kernel for a CUDA tensor and runs the plain version for a CPU
tensor; a tensor on any other device raises.
"""
from __future__ import annotations

import collections

import torch

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


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
