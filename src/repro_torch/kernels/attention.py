"""CUDA kernels for training's causal attention, with their plain PyTorch
versions.

Three kernels, hand-written for Hopper in ``csrc/attention.cu``, over q, k,
v of shape ``(B, S, H, hd)`` in bf16 (k and v expanded to the q heads),
causal, with an optional window, hd 64, 80 or 128:

* ``attention_fwd``: the output and each row's ``lse`` (``m log2 e +
  log2 l``, the log2 of the row's softmax denominator);
* ``attention_bwd_dq``: dq, and for the next kernel ``D = rowsum(dO * O)``
  and q scaled;
* ``attention_bwd_dkdv``: dk and dv.

They replace no TPU kernel (the reference leaves its blockwise attention
to XLA): they were added because the plain version below held the whole
``(B, H, S, S)`` score matrix in f32, about ten passes of it each way, for
most of an h2o-danube-1.8b training step on the H100.  The kernels keep
the scores on the SM with an online softmax; they are bound by the tensor
cores (4 hd flops per visible (query, key) pair forward, 10 hd backward),
and their numerics are the plain version's (``csrc/attention.cu``).

:func:`attention` is a ``torch.autograd.Function``: on a CUDA tensor it
launches the forward, and the two backward kernels (dq first); on a CPU
tensor it runs the plain version, :func:`attention_plain`, which is
``models/common.blockwise_attention`` with every key in one block, and
recomputes it for each backward kernel's plain version
(:func:`bwd_dq_plain`, :func:`bwd_dkdv_plain`), so the CPU's bits are
those of the plain path.  :func:`takes` is the rule by which
``models/common.attention`` calls it.

Wrappers, launch counting and the device rule: :mod:`repro_torch.kernels.wrap`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import wrap as W
from repro_torch.kernels.wrap import (  # noqa: F401  (LAUNCHES re-exported)
    LAUNCHES, device_kind, launched, reset_launches, stream)
from repro_torch.telemetry.profiler import phase

HEAD_DIMS = (64, 80, 128)
LOG2E = math.log2(math.e)


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("attention")
    vpp, llp, i, f, vp = (ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p)
    for name in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv"):
        fn = getattr(lib, name)
        fn.argtypes = [i, vpp, llp, i, i, i, i, f, vp]
        fn.restype = i
    return lib


def takes(q, k, v, causal: bool, softcap) -> bool:
    """Does ``models/common.attention`` call :func:`attention` for these
    inputs: causal, no soft cap, q, k and v of one 4-d bf16 shape with a
    head dim of HEAD_DIMS, on the CPU or a card (a planned tensor's too)?
    Every other case takes the plain path directly."""
    return (causal and softcap is None and q.dim() == 4
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape == k.shape == v.shape and q.shape[-1] in HEAD_DIMS
            and q.device.type in ("cpu", "cuda"))


def _window(S: int, window: int | None) -> int:
    return S if window is None else min(window, S)


def pairs(S: int, window: int | None) -> int:
    """Visible (query, key) pairs of one (batch, head): query i sees
    min(i + 1, window) keys."""
    w = _window(S, window)
    return w * (w + 1) // 2 + (S - w) * w


def flops(name: str, shape, window: int | None) -> float:
    """Operations the kernel ``name`` does at q's ``shape``: per visible
    pair 4 hd forward (the scores and the value product), 6 hd in dq (the
    scores, dP, dQ) and 8 hd in dk/dv (the scores, dP, dV, dK)."""
    B, S, H, hd = shape
    per = {"attention_fwd": 4, "attention_bwd_dq": 6,
           "attention_bwd_dkdv": 8}[name]
    return float(per * hd * pairs(S, window) * B * H)


def nbytes(name: str, shape) -> float:
    """Bytes the kernel ``name`` must move: each (B, S, H, hd) bf16 input
    read and output written once, and the f32 per-row vectors (lse, D)."""
    B, S, H, hd = shape
    n, rows = B * S * H * hd * 2, B * H * S * 4
    return {"attention_fwd": 4 * n + rows,              # q k v -> o, lse
            "attention_bwd_dq": 7 * n + 2 * rows,       # q k v o dO lse -> dq qs D
            "attention_bwd_dkdv": 6 * n + 2 * rows}[name]  # qs k v dO lse D -> dk dv


def _check(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dim() != 4 or q.dtype != torch.bfloat16 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"attention takes (B, S, H, hd) bf16 with hd in "
                         f"{HEAD_DIMS}, got {q.dtype} {tuple(q.shape)}")
    for t in ts[1:]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} beside q's {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}")


def _check_layout(*ts: torch.Tensor) -> None:
    """The kernels read (B, S, H, hd) through its strides, 16 bytes at a
    time: hd contiguous, 16-byte aligned, the other strides multiples of 8
    elements."""
    for t in ts:
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s % 8 for s in t.stride()[:3]):
            raise ValueError(f"attention: strides {t.stride()} at "
                             f"{t.data_ptr():#x}: hd must be contiguous, "
                             "16-byte aligned, the other strides multiples "
                             "of 8")


def _launch(name: str, q: torch.Tensor, window: int | None, views: dict,
            vectors: tuple) -> None:
    """Launch ``name`` with ``views`` (by name, the others null) and the
    (lse, dsum, qs) ``vectors`` (None where unused)."""
    order = ("q", "k", "v", "o", "dout", "dq", "dk", "dv")
    ptrs = [views[n].data_ptr() if n in views else None for n in order]
    ptrs += [t.data_ptr() if t is not None else None for t in vectors]
    strides = []
    for n in order:
        strides += list(views[n].stride()[:3]) if n in views else [0, 0, 0]
    B, S, H, hd = q.shape
    rc = getattr(_lib(), name)(
        hd, (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_longlong * len(strides))(*strides), B, S, H,
        _window(S, window), 1.0 / math.sqrt(hd), stream(q.device))
    launched(rc, name)


# ---------------------------------------------------------------------------
# the three kernels, each with its planned and plain versions
# ---------------------------------------------------------------------------

def _observed(name, q, window, planned, real):
    return W.observed(name, nbytes(name, q.shape), q, planned, real,
                      flops=flops(name, q.shape, window))


def attention_fwd(q, k, v, window: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, hd) -> (out (B, S, H, hd) bf16, lse (B, H, S) f32)."""
    if W.OBSERVER is not None or W.is_planned(q):
        return _observed("attention_fwd", q, window,
                         lambda: _fwd_planned(q, k, v),
                         lambda: attention_fwd(q, k, v, window))
    _check(q, k, v)
    if device_kind(q) == "cpu":
        return attention_fwd_plain(q, k, v, window)
    _check_layout(q, k, v)
    B, S, H, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    _launch("attention_fwd", q, window, {"q": q, "k": k, "v": v, "o": out},
            (lse, None, None))
    return out, lse


def _fwd_planned(q, k, v):
    _check(q, k, v)
    B, S, H, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty(B, H, S, dtype=torch.float32))


def attention_bwd_dq(q, k, v, out, lse, dout, window: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dq (B, S, H, hd) bf16, D = rowsum(dout * out) (B, H, S) f32, q
    scaled (B, H, S, hd) bf16), the last two for :func:`attention_bwd_dkdv`."""
    if W.OBSERVER is not None or W.is_planned(q):
        return _observed("attention_bwd_dq", q, window,
                         lambda: _dq_planned(q, k, v, out, dout),
                         lambda: attention_bwd_dq(q, k, v, out, lse, dout,
                                                  window))
    _check(q, k, v, out, dout)
    if device_kind(q) == "cpu":
        return bwd_dq_plain(q, k, v, out, dout, window)
    _check_layout(q, k, v, out, dout)
    B, S, H, hd = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dsum = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    qs = torch.empty(B, H, S, hd, dtype=q.dtype, device=q.device)
    _launch("attention_bwd_dq", q, window,
            {"q": q, "k": k, "v": v, "o": out, "dout": dout, "dq": dq},
            (lse, dsum, qs))
    return dq, dsum, qs


def _dq_planned(q, k, v, out, dout):
    _check(q, k, v, out, dout)
    B, S, H, hd = q.shape
    return (q.new_empty(q.shape), q.new_empty(B, H, S, dtype=torch.float32),
            q.new_empty(B, H, S, hd))


def attention_bwd_dkdv(q, qs, k, v, lse, dsum, dout,
                       window: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (dk, dv), each (B, S, H, hd) bf16, from :func:`attention_bwd_dq`'s
    q scaled ``qs`` and ``dsum`` (the plain version recomputes from q)."""
    if W.OBSERVER is not None or W.is_planned(q):
        return _observed("attention_bwd_dkdv", q, window,
                         lambda: _dkdv_planned(q, k, v, dout),
                         lambda: attention_bwd_dkdv(q, qs, k, v, lse, dsum,
                                                    dout, window))
    _check(q, k, v, dout)
    if device_kind(q) == "cpu":
        return bwd_dkdv_plain(q, k, v, dout, window)
    _check_layout(k, v, dout)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("attention_bwd_dkdv", q, window,
            {"k": k, "v": v, "dout": dout, "dk": dk, "dv": dv},
            (lse, dsum, qs))
    return dk, dv


def _dkdv_planned(q, k, v, dout):
    _check(q, k, v, dout)
    return k.new_empty(k.shape), v.new_empty(v.shape)


class _Attention(torch.autograd.Function):
    """The forward kernel, and in the backward the dq kernel, then the
    dk/dv kernel (inside the ``loco/attention`` span: the backward runs on
    the autograd engine's thread)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = attention_fwd(q, k, v, window)
        ctx.window = window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        w = ctx.window
        with phase("attention"):
            if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]):
                dout = dout.contiguous()
            dq, dsum, qs = attention_bwd_dq(q, k, v, out, lse, dout, w)
            dk, dv = attention_bwd_dkdv(q, qs, k, v, lse, dsum, dout, w)
        return dq, dk, dv, None


def attention(q, k, v, window: int | None = None) -> torch.Tensor:
    """Causal attention of q, k, v (B, S, H, hd) bf16 (k and v expanded to
    the q heads; hd in HEAD_DIMS), query i seeing keys ``i - window < j <=
    i`` -> (B, S, H, hd) bf16, differentiable."""
    return _Attention.apply(q, k, v, window)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, window: int | None = None):
    """The plain path: ``blockwise_attention`` with every key in one block."""
    return _stats_plain(q, k, v, window)[0]


def _stats_plain(q, k, v, window):
    from repro_torch.models import common as C

    pos = torch.arange(q.shape[1], device=q.device)
    m, l, acc = C.blockwise_attention(q, k, v, pos, pos, window=window,
                                      block_k=k.shape[1], return_stats=True)
    return C._normalize(q, l[..., None], acc), m, l


def attention_fwd_plain(q, k, v, window: int | None = None):
    """The forward kernel's plain version: the plain path's output, laid
    out as the kernel writes it, and ``m log2 e + log2 l`` per row."""
    out, m, l = _stats_plain(q, k, v, window)
    return out.contiguous(), m * LOG2E + torch.log2(l)


def _grads_plain(q, k, v, dout, window, wrt: tuple[int, ...]):
    """The plain path's gradients with respect to the inputs ``wrt`` (of
    q, k, v), by recomputing it: the bits of its own backward, laid out as
    the kernels write them."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(i in wrt)
              for i, x in enumerate((q, k, v))]
        out = attention_plain(*xs, window)
        grads = torch.autograd.grad(out, [xs[i] for i in wrt], dout)
    return [g.contiguous() for g in grads]


def bwd_dq_plain(q, k, v, out, dout, window: int | None = None):
    """The dq kernel's plain version: dq, D and q scaled."""
    dq, = _grads_plain(q, k, v, dout, window, (0,))
    dsum = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    qs = (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)
    return dq, dsum, qs.transpose(1, 2)


def bwd_dkdv_plain(q, k, v, dout, window: int | None = None):
    """The dk/dv kernel's plain version: dk and dv."""
    return tuple(_grads_plain(q, k, v, dout, window, (1, 2)))
