"""Compressed activation exchange for the MoE ``ep_a2a`` dispatch/combine.

Port of ``repro.core.act_comm`` for the stateless codecs.  The
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

Dead capacity slots and pad tokens are zero before encode
(``models/moe.py`` scatters with the ``valid`` mask), so an absmax scale
never sees garbage.  ``block8+ef`` (error feedback on the combine) is not
ported yet (ROADMAP.md).
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
PORTED_CODECS = ("fp", "block8")  # models.transformer.check_supported


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

def _encode(x4: torch.Tensor, n_pp: int, n_pad: int, tp: int) -> torch.Tensor:
    """``(tp, El, cap, d)`` -> packed ``(tp, row_bytes)`` u8 send buffer."""
    xf = x4.reshape(tp, n_pp).float()
    if n_pad != n_pp:
        xf = torch.nn.functional.pad(xf, (0, n_pad - n_pp))
    q, s = quant_rows(xf.reshape(-1, ACT_BLOCK))
    qb = q.reshape(tp, n_pad).view(torch.uint8)
    sb = WP.to_bytes(s).reshape(tp, (n_pad // ACT_BLOCK) * SCALE_BYTES)
    return torch.cat([qb, sb], dim=1)


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


def a2a_exchange(x4: torch.Tensor, group) -> torch.Tensor:
    """Stateless block8 all-to-all of a ``(tp, El, cap, d)`` slot buffer
    over the ``model`` group (``tp`` = its size), forward and backward."""
    return _A2A8.apply(x4, group)


def a2a_raw(x4: torch.Tensor, group) -> torch.Tensor:
    """The ``fp`` codec: the same all-to-all in the buffer's own dtype."""
    return _A2ARaw.apply(x4, group)


# ---------------------------------------------------------------------------
# static geometry
# ---------------------------------------------------------------------------

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
