"""CUDA kernels for the quantized-wire compression hot path, with their
plain PyTorch versions and launch counters.

Two kernels, both hand-written for Hopper in ``csrc/loco_quant.cu``:

* ``fused_compress`` replaces the Pallas kernel
  ``src/repro/kernels/loco_quant.py::fused_compress``: error-decode +
  compensate + per-256-block absmax quantize (4 or 8 bit) + nibble-pack +
  moving-average error update + error re-encode, one pass over the
  gradient.  ``err="f8"`` is LoCo's scaled f8_e4m3 storage with the +-448
  clip; ``err="bf16"`` is EF's unscaled bf16 storage (beta = 1).
* ``dequant_mean`` replaces ``src/repro/kernels/loco_quant.py::dequant_mean``:
  (nibble-unpack +) dequantize + mean over the D peer rows that the
  all-to-all delivered, summed in order d = 0..D-1 then divided by D.

Bound on the H100: bytes.  ``fused_compress`` moves about 6.52 B per element
(4 B f32 gradient + 1 B f8 error in; 0.5 B payload + 1 B f8 error + 4/256 B
scale out) for a dozen flops; ``dequant_mean`` at D = 1 moves about 4.52 B
per element.  The kernels read each input once and write each output once
(one warp per quantizer block with vector loads and a shuffle absmax; one
thread per output pair), so the HBM rate is their limit; a call on a
2.9M-element tensor is bounded near 6 us, where launch overhead matters.

Wrappers, launch counting and the device rule: :mod:`repro_torch.kernels.wrap`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantizer import F8_MAX, pack_int4, unpack_int4
from repro_torch.kernels.wrap import (  # noqa: F401  (LAUNCHES re-exported)
    LAUNCHES, check_aligned, device_kind, launched, reset_launches, stream)

QBLOCK = 256          # quantizer block (elements per scale)
_ERR_CODE = {"f8": 0, "bf16": 1}
_ERR_DTYPE = {"f8": torch.float8_e4m3fn, "bf16": torch.bfloat16}


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("loco_quant")
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.loco_fused_compress.argtypes = [vp, vp, vp, vp, vp, ll, i, i, f, f, f, vp]
    lib.loco_fused_compress.restype = i
    lib.loco_dequant_mean.argtypes = [vp, vp, vp, i, ll, i, vp]
    lib.loco_dequant_mean.restype = i
    return lib


# ---------------------------------------------------------------------------
# kernel 1: fused compensate + quantize(block absmax) + pack + err update
# ---------------------------------------------------------------------------

def _check_compress(g, e, bits, err):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if err not in _ERR_CODE:
        raise ValueError(f"err must be 'f8' or 'bf16', got {err!r}")
    if g.dim() != 1 or g.dtype != torch.float32:
        raise ValueError(f"g must be a flat f32 vector, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if e.shape != g.shape or e.dtype != _ERR_DTYPE[err]:
        raise ValueError(f"e must be {_ERR_DTYPE[err]} of shape "
                         f"{tuple(g.shape)}, got {e.dtype} {tuple(e.shape)}")
    if g.shape[0] % (2 * QBLOCK):
        raise ValueError(f"n={g.shape[0]} must be a multiple of {2 * QBLOCK}")
    if e.device != g.device:
        raise ValueError(f"g on {g.device} but e on {e.device}")


def fused_compress(g: torch.Tensor, e: torch.Tensor, *, bits: int = 4,
                   beta: float, escale: float, err: str = "f8"):
    """Flat (n,) f32 gradient + (n,) error -> (payload, scales (n/256,), e_new).

    payload is (n/2,) nibble-packed int8 at 4 bits, (n,) int8 at 8 bits;
    e_new keeps the error dtype (f8_e4m3fn for ``err="f8"``, bf16 for
    ``err="bf16"``).  n must be a multiple of 512.
    """
    _check_compress(g, e, bits, err)
    if device_kind(g) == "cpu":
        return fused_compress_plain(g, e, bits=bits, beta=beta,
                                    escale=escale, err=err)
    check_aligned(g, e)
    n = g.shape[0]
    payload = torch.empty(n // 2 if bits == 4 else n, dtype=torch.int8,
                          device=g.device)
    scales = torch.empty(n // QBLOCK, dtype=torch.float32, device=g.device)
    e_new = torch.empty_like(e)
    rc = _lib().loco_fused_compress(
        g.data_ptr(), e.data_ptr(), payload.data_ptr(), scales.data_ptr(),
        e_new.data_ptr(), n, bits, _ERR_CODE[err], beta, 1.0 - beta, escale,
        stream(g.device))
    launched(rc, "fused_compress")
    return payload, scales, e_new


def fused_compress_plain(g: torch.Tensor, e: torch.Tensor, *, bits: int = 4,
                         beta: float, escale: float, err: str = "f8"):
    """The same function in plain PyTorch ops (Pallas body ``_compress_kernel``)."""
    gm = g.float().reshape(-1, QBLOCK)
    ev = e.float().reshape(-1, QBLOCK)
    if err == "f8":
        ev = ev / escale                                    # decompressor(e; s_e)
    h = gm + ev                                             # Eqn. (2)
    qmax = float(2 ** (bits - 1) - 1)
    qmin = float(-(2 ** (bits - 1)))
    absmax = h.abs().amax(dim=1, keepdim=True)
    scale = torch.tensor(qmax, dtype=torch.float32, device=g.device) \
        / torch.clamp(absmax, min=1e-30)
    q = torch.clamp(torch.round(h * scale), qmin, qmax)      # Eqn. (3)
    d = q / scale                                           # decompressor(q; s)
    e_tilde = (1.0 - beta) * ev + beta * (h - d)            # Eqn. (5)
    if err == "f8":
        e_new = torch.clamp(e_tilde * escale, -F8_MAX, F8_MAX).to(
            torch.float8_e4m3fn)                            # Eqn. (7)
    else:
        e_new = e_tilde.to(torch.bfloat16)
    qi = q.to(torch.int8).reshape(-1)
    payload = pack_int4(qi) if bits == 4 else qi
    return payload, scale.reshape(-1), e_new.reshape(-1)


# ---------------------------------------------------------------------------
# kernel 2: unpack + dequant + mean over peers
# ---------------------------------------------------------------------------

def _check_dequant(payload, scales, bits):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if payload.dim() != 2 or payload.dtype != torch.int8:
        raise ValueError(f"payload must be (D, m) int8, got {payload.dtype} "
                         f"{tuple(payload.shape)}")
    D, m = payload.shape
    n_chunk = m * 2 if bits == 4 else m
    if n_chunk % (2 * QBLOCK):
        raise ValueError(f"chunk of {n_chunk} elements is not a multiple of "
                         f"{2 * QBLOCK}")
    if tuple(scales.shape) != (D, n_chunk // QBLOCK) \
            or scales.dtype != torch.float32:
        raise ValueError(f"scales must be f32 ({D}, {n_chunk // QBLOCK}), got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if scales.device != payload.device:
        raise ValueError(f"payload on {payload.device} but scales on "
                         f"{scales.device}")
    return D, n_chunk


def dequant_mean(payload: torch.Tensor, scales: torch.Tensor, *,
                 bits: int = 4) -> torch.Tensor:
    """Received all-to-all rows -> f32 mean gradient chunk (n_chunk,).

    payload: (D, m) int8, m = n_chunk/2 at 4 bits else n_chunk;
    scales:  (D, n_chunk/256) f32.
    """
    D, n_chunk = _check_dequant(payload, scales, bits)
    if device_kind(payload) == "cpu":
        return dequant_mean_plain(payload, scales, bits=bits)
    check_aligned(payload, scales)
    out = torch.empty(n_chunk, dtype=torch.float32, device=payload.device)
    rc = _lib().loco_dequant_mean(payload.data_ptr(), scales.data_ptr(),
                                  out.data_ptr(), D, n_chunk, bits,
                                  stream(payload.device))
    launched(rc, "dequant_mean")
    return out


def dequant_mean_plain(payload: torch.Tensor, scales: torch.Tensor, *,
                       bits: int = 4) -> torch.Tensor:
    """The same function in plain PyTorch ops.  The peer sum is an explicit
    loop in order d = 0..D-1 (a ``.mean(0)`` may reduce in another order)."""
    D = payload.shape[0]
    q = unpack_int4(payload) if bits == 4 else payload
    vals = q.float().reshape(D, -1, QBLOCK) / scales.reshape(D, -1, 1)
    acc = torch.zeros(vals[0].numel(), dtype=torch.float32,
                      device=payload.device)
    for d in range(D):
        acc = acc + vals[d].reshape(-1)
    return acc / D
