"""CUDA kernels for the quantized-wire compression hot path, with their
plain PyTorch versions and launch counters.

Two kernels, both hand-written for Hopper in ``csrc/loco_quant.cu``:

* ``fused_compress`` replaces the Pallas kernel
  ``src/repro/kernels/loco_quant.py::fused_compress``: error-decode +
  compensate + per-256-block absmax quantize (4 or 8 bit) + nibble-pack +
  moving-average error update + error re-encode, one pass over the
  gradient, which it takes as it is (bf16 or f32; the upcast is exact).
  ``err="f8"`` is LoCo's scaled f8_e4m3 storage with the +-448 clip;
  ``err="bf16"`` is EF's unscaled bf16 storage (beta = 1).  The new error
  may be written in place (``e_out=e``).
* ``dequant_mean`` replaces ``src/repro/kernels/loco_quant.py::dequant_mean``:
  (nibble-unpack +) dequantize + mean over the D peer rows that the
  all-to-all delivered, summed in order d = 0..D-1 then divided by D, into
  an f32 or a bf16 shard (the f32 mean rounded to nearest-even).

Bound on the H100: bytes.  From a bf16 gradient ``fused_compress`` moves
4.52 B per element (2 B gradient + 1 B f8 error in; 0.5 B payload + 1 B f8
error + 4/256 B scale out; 6.52 B from f32) for a dozen flops;
``dequant_mean`` at D = 1 moves 2.52 B per element into a bf16 shard (4.52
B into f32).  Each input is read once and each output written once; the
source says how the kernels keep HBM streaming and avoid per-element
divisions.  Below a few million elements a call is bounded by a few
microseconds, so the wrappers keep their host work to one ``torch.empty``
per output, attribute checks and one ctypes call.

Wrappers, launch counting and the device rule: :mod:`repro_torch.kernels.wrap`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.quantizer import F8_MAX, pack_int4, unpack_int4
from repro_torch.kernels import wrap as W
from repro_torch.kernels.wrap import (  # noqa: F401  (LAUNCHES re-exported)
    LAUNCHES, check_aligned, device_kind, launched, reset_launches, stream)

QBLOCK = 256          # quantizer block (elements per scale)
_ERR_CODE = {"f8": 0, "bf16": 1}
_ERR_DTYPE = {"f8": torch.float8_e4m3fn, "bf16": torch.bfloat16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # gradient in, shard out
DTYPES = tuple(_DTYPE_CODE)


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("loco_quant")
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.loco_fused_compress.argtypes = [vp, i, vp, vp, vp, vp, ll, i, i,
                                        f, f, f, f, vp]
    lib.loco_fused_compress.restype = i
    lib.loco_dequant_mean.argtypes = [vp, vp, vp, i, i, ll, i, f, vp]
    lib.loco_dequant_mean.restype = i
    return lib


def exact_inverse(x: float) -> float:
    """``1/x`` when ``x`` is a power of two with ``x`` and ``1/x`` normal
    f32 values, else 0.0.  Then ``y / x`` and ``y * (1/x)`` round the same
    real number, so the kernels multiply instead of dividing."""
    m, e = math.frexp(x)
    return 2.0 ** (1 - e) if m == 0.5 and -126 <= e - 1 <= 126 else 0.0


# ---------------------------------------------------------------------------
# kernel 1: fused compensate + quantize(block absmax) + pack + err update
# ---------------------------------------------------------------------------

def compress_bytes(n: int, bits: int = 4, g_bytes: int = 2,
                   err: str = "f8") -> float:
    """Bytes fused_compress must move: g and e read once; payload, e_new
    and the scales written once."""
    eb = 1 if err == "f8" else 2
    return n * g_bytes + 2 * n * eb + (n / 2 if bits == 4 else n) \
        + n / QBLOCK * 4


def dequant_bytes(n: int, D: int = 1, bits: int = 4,
                  out_bytes: int = 2) -> float:
    """Bytes dequant_mean must move: D payload rows and scale rows read
    once, the mean written once."""
    return D * ((n / 2 if bits == 4 else n) + n / QBLOCK * 4) + n * out_bytes


def _check_compress(g, e, bits, err, e_out, aligned=True):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if err not in _ERR_CODE:
        raise ValueError(f"err must be 'f8' or 'bf16', got {err!r}")
    if g.dim() != 1 or g.dtype not in _DTYPE_CODE:
        raise ValueError(f"g must be a flat f32 or bf16 vector, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if g.shape[0] % (2 * QBLOCK):
        raise ValueError(f"n={g.shape[0]} must be a multiple of {2 * QBLOCK}")
    errs = (e,) if e_out is None or e_out is e else (e, e_out)
    for t in errs:
        if t.shape != g.shape or t.dtype != _ERR_DTYPE[err]:
            raise ValueError(f"e and e_out must be {_ERR_DTYPE[err]} of "
                             f"shape {tuple(g.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != g.device:
            raise ValueError(f"g on {g.device} but the error on {t.device}")
    if aligned:
        check_aligned(g, *errs)


def fused_compress(g: torch.Tensor, e: torch.Tensor, *, bits: int = 4,
                   beta: float, escale: float, err: str = "f8",
                   e_out: torch.Tensor | None = None):
    """Flat (n,) f32 or bf16 gradient + (n,) error -> (payload, scales
    (n/256,), e_new).

    payload is (n/2,) nibble-packed int8 at 4 bits, (n,) int8 at 8 bits;
    e_new keeps the error dtype (f8_e4m3fn for ``err="f8"``, bf16 for
    ``err="bf16"``) and is written into ``e_out`` when given, which may be
    ``e`` itself (an in-place update: each element is read before it is
    written).  n must be a multiple of 512.
    """
    if W.OBSERVER is not None or W.is_planned(g):
        return _observed_compress(g, e, bits, beta, escale, err, e_out)
    _check_compress(g, e, bits, err, e_out)
    if device_kind(g) == "cpu":
        payload, scales, e_new = fused_compress_plain(
            g, e, bits=bits, beta=beta, escale=escale, err=err)
        if e_out is None:
            return payload, scales, e_new
        return payload, scales, e_out.copy_(e_new)
    n, dev = g.shape[0], g.device
    # one torch.empty per output (cheaper on the host than slicing views
    # out of one buffer); none for the error when it is written in place
    payload = torch.empty(n // 2 if bits == 4 else n, dtype=torch.int8,
                          device=dev)
    scales = torch.empty(n // QBLOCK, dtype=torch.float32, device=dev)
    if e_out is None:
        e_out = torch.empty_like(e)
    rc = _lib().loco_fused_compress(
        g.data_ptr(), _DTYPE_CODE[g.dtype], e.data_ptr(), payload.data_ptr(),
        scales.data_ptr(), e_out.data_ptr(), n, bits, _ERR_CODE[err], beta,
        1.0 - beta, escale, exact_inverse(escale) if err == "f8" else 0.0,
        stream(dev))
    launched(rc, "fused_compress")
    return payload, scales, e_out


def _observed_compress(g, e, bits, beta, escale, err, e_out):
    """:func:`fused_compress` on fake tensors or under a recorder
    (``wrap.observed``)."""
    def planned():
        _check_compress(g, e, bits, err, e_out, aligned=False)
        n = g.shape[0]
        return (g.new_empty(n // 2 if bits == 4 else n, dtype=torch.int8),
                g.new_empty(n // QBLOCK, dtype=torch.float32),
                torch.empty_like(e) if e_out is None else e_out)

    return W.observed(
        "fused_compress", compress_bytes(g.numel(), bits, g.element_size(),
                                         err), g, planned,
        lambda: fused_compress(g, e, bits=bits, beta=beta, escale=escale,
                               err=err, e_out=e_out))


def _divide(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x / y`` rounded as one IEEE division on every device.  On CUDA,
    torch divides by a Python scalar as ``x * (1/y)``, which rounds
    otherwise unless ``y`` is a power of two; a device tensor divisor
    keeps the division (as the kernels and the reference compute it)."""
    return x / torch.full((), y, dtype=torch.float32, device=x.device)


def fused_compress_plain(g: torch.Tensor, e: torch.Tensor, *, bits: int = 4,
                         beta: float, escale: float, err: str = "f8"):
    """The same function in plain PyTorch ops (Pallas body ``_compress_kernel``)."""
    gm = g.float().reshape(-1, QBLOCK)
    ev = e.float().reshape(-1, QBLOCK)
    if err == "f8":
        ev = _divide(ev, escale)                            # decompressor(e; s_e)
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

def _check_dequant(payload, scales, bits, out_dtype, aligned=True):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
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
    if aligned:
        check_aligned(payload, scales)
    return D, n_chunk


def dequant_mean(payload: torch.Tensor, scales: torch.Tensor, *,
                 bits: int = 4,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Received all-to-all rows -> mean gradient chunk (n_chunk,).

    payload: (D, m) int8, m = n_chunk/2 at 4 bits else n_chunk;
    scales:  (D, n_chunk/256) f32;
    out_dtype: f32, or bf16 (the f32 mean rounded to nearest-even).
    """
    if W.OBSERVER is not None or W.is_planned(payload):
        return _observed_dequant(payload, scales, bits, out_dtype)
    D, n_chunk = _check_dequant(payload, scales, bits, out_dtype)
    if device_kind(payload) == "cpu":
        return dequant_mean_plain(payload, scales, bits=bits,
                                  out_dtype=out_dtype)
    dev = payload.device
    out = torch.empty(n_chunk, dtype=out_dtype, device=dev)
    rc = _lib().loco_dequant_mean(payload.data_ptr(), scales.data_ptr(),
                                  out.data_ptr(), _DTYPE_CODE[out_dtype], D,
                                  n_chunk, bits, exact_inverse(D), stream(dev))
    launched(rc, "dequant_mean")
    return out


def _observed_dequant(payload, scales, bits, out_dtype):
    """:func:`dequant_mean` on fake tensors or under a recorder
    (``wrap.observed``)."""
    def planned():
        _, n = _check_dequant(payload, scales, bits, out_dtype,
                              aligned=False)
        return payload.new_empty(n, dtype=out_dtype)

    D, m = payload.shape
    return W.observed(
        "dequant_mean", dequant_bytes(m * 2 if bits == 4 else m, D, bits,
                                      out_dtype.itemsize),
        payload, planned,
        lambda: dequant_mean(payload, scales, bits=bits,
                             out_dtype=out_dtype))


def dequant_mean_plain(payload: torch.Tensor, scales: torch.Tensor, *,
                       bits: int = 4,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The same function in plain PyTorch ops.  The peer sum is an explicit
    loop in order d = 0..D-1 (a ``.mean(0)`` may reduce in another order)."""
    D = payload.shape[0]
    q = unpack_int4(payload) if bits == 4 else payload
    vals = q.float().reshape(D, -1, QBLOCK) / scales.reshape(D, -1, 1)
    acc = torch.zeros(vals[0].numel(), dtype=torch.float32,
                      device=payload.device)
    for d in range(D):
        acc = acc + vals[d].reshape(-1)
    return _divide(acc, D).to(out_dtype)
