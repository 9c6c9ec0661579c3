"""CUDA kernel for the onebit wire, with its plain PyTorch version.

``onebit_pack``, hand-written for Hopper in ``csrc/sign_pack.cu``, replaces
the Pallas kernel ``src/repro/kernels/sign_pack.py::onebit_pack``: from the
compensated gradient ``h`` and its L1 scale (``mean|h|``, computed by the
caller), the sign bits ``b = h > 0`` packed 8 per byte LSB first (bit j of
byte k = element 8k + j, :func:`repro_torch.core.quantizer.pack_signs`) and
the error ``e_new = h - (2b - 1) * scale`` in bf16.

Bound on the H100: bytes.  6.125 B per element (4 B f32 in; 1/8 B of signs
and 2 B of bf16 error out) for a compare and a subtract; one thread per
output byte.

Wrappers, launch counting and the device rule: :mod:`repro_torch.kernels.wrap`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantizer import SIGN_PACK, pack_signs
from repro_torch.kernels import wrap as W
from repro_torch.kernels.wrap import (  # noqa: F401  (LAUNCHES re-exported)
    LAUNCHES, check_aligned, device_kind, launched, reset_launches, stream)

GRAIN = 512  # n must be a multiple (the reference's 2 * QBLOCK)


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("sign_pack")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.onebit_pack.argtypes = [vp, vp, vp, vp, ll, vp]
    lib.onebit_pack.restype = i
    return lib


def _check(h: torch.Tensor, scale: torch.Tensor) -> None:
    if h.dim() != 1 or h.dtype != torch.float32 or h.shape[0] % GRAIN:
        raise ValueError(f"h must be a flat f32 vector of a multiple of "
                         f"{GRAIN} elements, got {h.dtype} {tuple(h.shape)}")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError(f"scale must be one f32 value, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if scale.device != h.device:
        raise ValueError(f"h on {h.device} but scale on {scale.device}")


def onebit_bytes(n: int) -> float:
    """Bytes onebit_pack must move: f32 h read; n/8 sign bytes and the
    bf16 error written; one f32 scale read."""
    return n * 4 + n / 8 + n * 2 + 4


def onebit_pack(h: torch.Tensor, scale: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compensated flat ``(n,)`` f32 gradient + scalar f32 L1 scale ->
    (packed signs ``(n/8,)`` uint8, ``e_new`` ``(n,)`` bf16).

    ``scale`` is a one-element f32 tensor on ``h``'s device; n must be a
    multiple of 512.
    """
    if W.OBSERVER is not None or W.is_planned(h):
        return W.observed("onebit_pack", onebit_bytes(h.numel()), h,
                          lambda: _onebit_planned(h, scale),
                          lambda: onebit_pack(h, scale))
    _check(h, scale)
    if device_kind(h) == "cpu":
        return onebit_pack_plain(h, scale)
    check_aligned(h)
    n = h.shape[0]
    packed = torch.empty(n // SIGN_PACK, dtype=torch.uint8, device=h.device)
    e_new = torch.empty(n, dtype=torch.bfloat16, device=h.device)
    rc = _lib().onebit_pack(h.data_ptr(), scale.data_ptr(),
                            packed.data_ptr(), e_new.data_ptr(), n,
                            stream(h.device))
    launched(rc, "onebit_pack")
    return packed, e_new


def _onebit_planned(h, scale):
    _check(h, scale)
    n = h.shape[0]
    return (h.new_empty(n // SIGN_PACK, dtype=torch.uint8),
            h.new_empty(n, dtype=torch.bfloat16))


def onebit_pack_plain(h: torch.Tensor, scale: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch ops (Pallas body
    ``_sign_pack_kernel``)."""
    bits = (h > 0).to(torch.uint8)
    d = (2.0 * bits.float() - 1.0) * scale.reshape(())
    return pack_signs(bits), (h - d).to(torch.bfloat16)
