"""Byte views for the coalesced wire exchange.

Port of ``repro.core.wirepack.to_bytes``/``from_bytes``: every wire leaf is
viewed as ``uint8`` so that all leaves of one exchange ride one packed
collective; the views are exact (no arithmetic), so the packed exchange is
bit-identical to one collective per leaf.
"""
from __future__ import annotations

import torch


def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Flat ``uint8`` view of a tensor's bytes (bit-exact, no arithmetic)."""
    flat = a.contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def from_bytes(buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_bytes` along the last axis.

    ``buf``'s trailing axis is a byte count divisible by ``dtype``'s
    itemsize; leading axes (the peer axis of a received buffer) pass
    through, so ``(D, row_bytes) -> (D, row_elems)``.
    """
    if dtype == torch.uint8:
        return buf
    if buf.shape[-1] % dtype.itemsize:
        raise ValueError(f"{buf.shape[-1]} bytes is not a whole number of "
                         f"{dtype} elements")
    return buf.contiguous().view(dtype)
