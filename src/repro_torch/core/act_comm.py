"""Compressed activation exchange for the MoE ``ep_a2a`` dispatch/combine.

Port of ``repro.core.act_comm``.  The
expert-parallel MoE moves its ``(tp, El, cap, d)`` capacity-slot buffer
through an all-to-all over the ``model`` group twice per layer (dispatch
and combine), forward and backward.  With ``moe_a2a_codec="block8"`` each
rank's per-peer row is flattened, zero-padded to a multiple of 512,
quantized per 512-element block to int8 with an absmax scale
(:mod:`repro_torch.kernels.act_quant`: the CUDA kernels on the card, their
plain versions on the CPU), packed with the f32 scales into one ``uint8``
row (:mod:`repro_torch.core.wirepack`), exchanged in ONE u8 all-to-all and
dequantized on the receiving rank.

:func:`a2a_exchange` is a ``torch.autograd.Function`` whose backward sends
the cotangent through the same compressed exchange: an all-to-all with
split and concat on axis 0 is a self-inverse permutation, so its transpose
is itself.  :func:`a2a_raw` is the ``fp`` codec's uncompressed exchange,
with the same backward rule.

``block8+ef`` adds error feedback on the combine (:func:`a2a_exchange_ef`):
each layer keeps a persistent bf16 residual of its send buffer, the part
of ``x + err`` that no peer received, carried by the train step under
``states["_moe_a2a"]`` (:data:`EF_STATE_KEY`) and checkpointed with it.

Dead capacity slots and pad tokens are zero before encode
(``models/moe.py`` scatters with the ``valid`` mask), so an absmax scale
never sees garbage.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import wirepack as WP
from repro_torch.core.comm import all_to_all_chunks
from repro_torch.kernels import act_quant as AQ

ACT_BLOCK = AQ.ACT_BLOCK   # absmax block length (elements), the wire granule
QMAX = AQ.QMAX             # symmetric int8
SCALE_BYTES = 4            # one f32 scale per block
MOE_A2A_CODECS = ("fp", "block8", "block8+ef")
EF_STATE_KEY = "_moe_a2a"   # the train state's entry for the EF stack


# ---------------------------------------------------------------------------
# codec cells
# ---------------------------------------------------------------------------

def quant_rows(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, ACT_BLOCK)`` f32 -> (int8 codes, f32 per-row absmax scales);
    an all-zero block round-trips to exact zeros."""
    return AQ.act_encode(h)


def dequant_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant_rows` -> ``(rows, ACT_BLOCK)`` f32."""
    return AQ.act_decode(q, scale)


def _pad_up(n: int) -> int:
    return -(-n // ACT_BLOCK) * ACT_BLOCK


def wire_row_bytes(n_per_peer: int) -> int:
    """u8 bytes of one peer row: padded int8 payload + packed f32 scales."""
    n_pad = _pad_up(n_per_peer)
    return n_pad + (n_pad // ACT_BLOCK) * SCALE_BYTES


# ---------------------------------------------------------------------------
# encode / exchange / decode
# ---------------------------------------------------------------------------

def _padded(x4: torch.Tensor, n_pp: int, n_pad: int, tp: int) -> torch.Tensor:
    """``(tp, El, cap, d)`` -> ``(tp, n_pad)`` f32, zero past ``n_pp``."""
    xf = x4.reshape(tp, n_pp).float()
    if n_pad != n_pp:
        xf = torch.nn.functional.pad(xf, (0, n_pad - n_pp))
    return xf


def _pack(q: torch.Tensor, s: torch.Tensor, n_pad: int,
          tp: int) -> torch.Tensor:
    """int8 codes and f32 scales -> packed ``(tp, row_bytes)`` u8 rows."""
    qb = q.reshape(tp, n_pad).view(torch.uint8)
    sb = WP.to_bytes(s).reshape(tp, (n_pad // ACT_BLOCK) * SCALE_BYTES)
    return torch.cat([qb, sb], dim=1)


def _encode(x4: torch.Tensor, n_pp: int, n_pad: int, tp: int) -> torch.Tensor:
    """``(tp, El, cap, d)`` -> packed ``(tp, row_bytes)`` u8 send buffer."""
    xf = _padded(x4, n_pp, n_pad, tp)
    q, s = quant_rows(xf.reshape(-1, ACT_BLOCK))
    return _pack(q, s, n_pad, tp)


def _decode(buf: torch.Tensor, n_pp: int, n_pad: int, tp: int,
            shape4: tuple, dtype: torch.dtype) -> torch.Tensor:
    """Packed ``(tp, row_bytes)`` u8 -> ``(tp, El, cap, d)`` in ``dtype``."""
    q = buf[:, :n_pad].contiguous().view(torch.int8)
    s = WP.from_bytes(buf[:, n_pad:], torch.float32)
    dec = dequant_rows(q.reshape(-1, ACT_BLOCK), s.reshape(-1))
    return dec.reshape(tp, n_pad)[:, :n_pp].reshape(shape4).to(dtype)


def _exchange8(x4: torch.Tensor, group) -> torch.Tensor:
    tp = x4.shape[0]
    n_pp = x4.numel() // tp
    n_pad = _pad_up(n_pp)
    buf = all_to_all_chunks(_encode(x4, n_pp, n_pad, tp), group)
    return _decode(buf, n_pp, n_pad, tp, tuple(x4.shape), x4.dtype)


class _A2A8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x4, group):
        ctx.group = group
        return _exchange8(x4, group)

    @staticmethod
    def backward(ctx, g):
        # the a2a permutation is self-inverse: its transpose is itself, so
        # the cotangent rides the same compressed exchange
        return _exchange8(g, ctx.group), None


class _A2ARaw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x4, group):
        ctx.group = group
        return all_to_all_chunks(x4, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_chunks(g, ctx.group), None


class _A2A8EF(torch.autograd.Function):
    """``(x4, err) -> (y4, new_err)``: the forward quantizes ``h = x +
    err`` (f32, padded), keeps ``new_err = h - decode(encode(h))`` in the
    state's dtype, the residual no peer received, and sends the codes;
    the backward compresses the cotangent through the stateless exchange,
    and the state gets no gradient (it is a carried buffer)."""

    @staticmethod
    def forward(ctx, x4, err, group):
        ctx.group = group
        tp = x4.shape[0]
        n_pp = x4.numel() // tp
        n_pad = _pad_up(n_pp)
        h = _padded(x4, n_pp, n_pad, tp) + err.reshape(tp, n_pad).float()
        q, s = quant_rows(h.reshape(-1, ACT_BLOCK))
        dec_local = dequant_rows(q, s).reshape(tp, n_pad)
        new_err = (h - dec_local).reshape(err.shape).to(err.dtype)
        buf = all_to_all_chunks(_pack(q, s, n_pad, tp), group)
        y4 = _decode(buf, n_pp, n_pad, tp, tuple(x4.shape), x4.dtype)
        ctx.mark_non_differentiable(new_err)
        return y4, new_err

    @staticmethod
    def backward(ctx, g, _g_err):
        return _exchange8(g, ctx.group), None, None


def a2a_exchange(x4: torch.Tensor, group) -> torch.Tensor:
    """Stateless block8 all-to-all of a ``(tp, El, cap, d)`` slot buffer
    over the ``model`` group (``tp`` = its size), forward and backward."""
    return _A2A8.apply(x4, group)


def a2a_exchange_ef(x4: torch.Tensor, err: torch.Tensor,
                    group) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback block8 all-to-all of a ``(tp, El, cap, d)`` slot
    buffer with this layer's ``(tp * n_pad,)`` residual ``err``; returns
    ``(y4, new_err)``.  The caller stores ``new_err`` once per
    microbatch (``launch/steps``): a recomputed forward must read the
    same ``err`` and its ``new_err`` is dropped."""
    return _A2A8EF.apply(x4, err, group)


def a2a_raw(x4: torch.Tensor, group) -> torch.Tensor:
    """The ``fp`` codec: the same all-to-all in the buffer's own dtype."""
    return _A2ARaw.apply(x4, group)


# ---------------------------------------------------------------------------
# static geometry
# ---------------------------------------------------------------------------

def wants_ef(cfg) -> bool:
    """Does this model carry a persistent combine-side EF state?"""
    return (getattr(cfg, "n_experts", 0) > 0
            and getattr(cfg, "moe_impl", "") == "ep_a2a"
            and getattr(cfg, "moe_a2a_codec", "fp") == "block8+ef")


def a2a_geometry(cfg, n_tokens: int, tp: int) -> dict:
    """Static shapes of one layer's dispatch/combine exchange for
    ``n_tokens`` tokens on this rank's model group (= microbatch * seq_len),
    mirroring the ``models/moe.py`` ep_a2a capacity math."""
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    Tpad = -(-n_tokens // tp) * tp
    Tl = Tpad // tp
    cap = max(1, int(math.ceil(Tl * k / E * cfg.capacity_factor)))
    El = E // tp
    n_pp = El * cap * d
    n_pad = _pad_up(n_pp)
    return dict(cap=cap, El=El, n_pp=n_pp, n_pad=n_pad,
                row_bytes=wire_row_bytes(n_pp),
                fp_row_bytes=2 * n_pp)  # bf16 baseline


def ef_state_len(cfg, n_tokens: int, tp: int) -> int:
    """Flat per-layer EF-state length (tp * padded per-peer elements)."""
    return tp * a2a_geometry(cfg, n_tokens, tp)["n_pad"]
