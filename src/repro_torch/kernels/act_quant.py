"""CUDA kernels for the MoE activation wire, with their plain PyTorch
versions.

Two kernels, hand-written for Hopper in ``csrc/act_quant.cu``, over the
``(rows, ACT_BLOCK)`` layout that :mod:`repro_torch.core.act_comm`
quantizes:

* ``act_encode`` replaces the Pallas kernel
  ``src/repro/kernels/act_quant.py::act_encode``: per 512-element row,
  ``scale = 127 / max(absmax, 1e-30)`` and
  ``q = clip(round(h * scale), -128, 127)`` as int8;
* ``act_decode`` replaces ``src/repro/kernels/act_quant.py::act_decode``:
  ``q / scale`` per row, f32 out.

Bound on the H100: bytes.  Each kernel moves 5.0078 B per element (4 B f32
and 1 B int8, plus one 4-byte scale per 512 elements) for two or three
flops, so the HBM rate is their limit: at the deepseek-v3-moe exchange
(81,920 rows, 41,943,040 elements) a call is bounded near 62.7 us at the
H100 SXM's 3.35 TB/s.  Encode gives each row to one
warp (coalesced float4 loads, a shuffle absmax); decode gives each thread
four elements.

Wrappers, launch counting and the device rule: :mod:`repro_torch.kernels.wrap`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import wrap as W
from repro_torch.kernels.wrap import (  # noqa: F401  (LAUNCHES re-exported)
    LAUNCHES, check_aligned, device_kind, launched, reset_launches, stream)

ACT_BLOCK = 512
QMAX = 127.0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("act_quant")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.act_encode.argtypes = [vp, vp, vp, ll, vp]
    lib.act_encode.restype = i
    lib.act_decode.argtypes = [vp, vp, vp, ll, vp]
    lib.act_decode.restype = i
    return lib


def act_bytes(rows: int) -> float:
    """Bytes act_encode (and act_decode) must move: f32 rows and int8
    rows, one read and one written, plus one f32 scale per row."""
    return rows * ACT_BLOCK * (4 + 1) + rows * 4


def _check_rows(t: torch.Tensor, dtype: torch.dtype, what: str) -> int:
    if t.dim() != 2 or t.shape[1] != ACT_BLOCK or t.dtype != dtype \
            or t.shape[0] == 0:
        raise ValueError(f"{what} must be (rows, {ACT_BLOCK}) {dtype} with "
                         f"rows > 0, got {t.dtype} {tuple(t.shape)}")
    return t.shape[0]


def act_encode(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, 512)`` f32 -> (int8 codes ``(rows, 512)``, f32 scales
    ``(rows,)``)."""
    if W.OBSERVER is not None or W.is_planned(h):
        return W.observed("act_encode", act_bytes(h.shape[0]), h,
                          lambda: _encode_planned(h),
                          lambda: act_encode(h))
    rows = _check_rows(h, torch.float32, "h")
    if device_kind(h) == "cpu":
        return act_encode_plain(h)
    check_aligned(h)
    q = torch.empty(rows, ACT_BLOCK, dtype=torch.int8, device=h.device)
    s = torch.empty(rows, dtype=torch.float32, device=h.device)
    rc = _lib().act_encode(h.data_ptr(), q.data_ptr(), s.data_ptr(), rows,
                           stream(h.device))
    launched(rc, "act_encode")
    return q, s


def _encode_planned(h):
    rows = _check_rows(h, torch.float32, "h")
    return (h.new_empty(rows, ACT_BLOCK, dtype=torch.int8),
            h.new_empty(rows, dtype=torch.float32))


def act_encode_plain(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch ops (Pallas body ``_encode_kernel``)."""
    absmax = h.abs().amax(dim=1)
    scale = torch.tensor(QMAX, dtype=torch.float32, device=h.device) \
        / torch.clamp(absmax, min=1e-30)
    q = torch.clamp(torch.round(h * scale[:, None]), -128, 127)
    return q.to(torch.int8), scale


def _check_decode(q: torch.Tensor, scale: torch.Tensor) -> int:
    rows = _check_rows(q, torch.int8, "q")
    if tuple(scale.shape) != (rows,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be f32 ({rows},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if scale.device != q.device:
        raise ValueError(f"q on {q.device} but scale on {scale.device}")
    return rows


def act_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8 codes ``(rows, 512)``, f32 scales ``(rows,)``) -> ``(rows, 512)``
    f32."""
    if W.OBSERVER is not None or W.is_planned(q):
        return W.observed("act_decode", act_bytes(q.shape[0]), q,
                          lambda: q.new_empty(_check_decode(q, scale),
                                              ACT_BLOCK,
                                              dtype=torch.float32),
                          lambda: act_decode(q, scale))
    rows = _check_decode(q, scale)
    if device_kind(q) == "cpu":
        return act_decode_plain(q, scale)
    check_aligned(q, scale)
    out = torch.empty(rows, ACT_BLOCK, dtype=torch.float32, device=q.device)
    rc = _lib().act_decode(q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           rows, stream(q.device))
    launched(rc, "act_decode")
    return out


def act_decode_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops (Pallas body ``_decode_kernel``)."""
    return q.float() / scale[:, None]
