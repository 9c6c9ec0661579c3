"""Quantization codecs used by LoCo and the baseline compressors.

Port of ``repro.core.quantizer``: the ``fixed`` (paper Eqn. (1)), ``block``
(per-256-element absmax) and ``tensor`` (one absmax per segment) gradient
codecs, the two-nibbles-per-byte int4 wire packing, and the 8-bit error
codecs (``int8`` paper-exact, ``f8`` = float8_e4m3fn with a static
pre-scale, plus ``bf16``/``none`` float storage).

Every function is plain tensor math on whatever device its input lives on.
Rounding is half-to-even (``torch.round``) and every division is a true
division, so CPU results are bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

INT8_MIN, INT8_MAX = -128, 127
DEFAULT_BLOCK = 256
F8_MAX = 448.0  # float8_e4m3fn saturation bound


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the gradient wire format."""

    bits: int = 4
    mode: Literal["fixed", "block", "tensor"] = "block"
    scale: float = 2.0**17          # fixed mode only (paper: 2**17 or 2**19)
    block: int = DEFAULT_BLOCK      # block mode only
    error_codec: Literal["int8", "f8", "bf16", "none"] = "f8"
    error_scale: float = 2.0**14    # static pre-scale for int8/f8 error
    stochastic_rounding: bool = False

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def _round(x: torch.Tensor, cfg: QuantConfig,
           gen: torch.Generator | None) -> torch.Tensor:
    if cfg.stochastic_rounding and gen is not None:
        noise = torch.rand(x.shape, generator=gen, dtype=x.dtype,
                           device=x.device) - 0.5
        return torch.round(x + noise)
    return torch.round(x)


# ---------------------------------------------------------------------------
# fixed-scale codec (paper Eqn. (1))
# ---------------------------------------------------------------------------

def quant_fixed(x: torch.Tensor, cfg: QuantConfig,
                gen: torch.Generator | None = None) -> torch.Tensor:
    """compressor(x; s, p): round to nearest integer in the signed p-bit range."""
    q = _round(x.float() * cfg.scale, cfg, gen)
    return torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int8)


# ---------------------------------------------------------------------------
# block-scaled codec (per-block absmax)
# ---------------------------------------------------------------------------

def _to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    if x.dim() != 1:
        raise ValueError("block codec operates on flat vectors")
    n = x.shape[0]
    if n % block:
        raise ValueError(f"size {n} not a multiple of block {block}")
    return x.reshape(n // block, block)


def block_scales(xb: torch.Tensor, qmax: int) -> torch.Tensor:
    """(rows, block) f32 -> (rows, 1) scales ``qmax / max(absmax, 1e-30)``."""
    absmax = xb.abs().amax(dim=1, keepdim=True)
    qm = torch.tensor(float(qmax), dtype=torch.float32, device=xb.device)
    return qm / torch.clamp(absmax, min=1e-30)


def quant_block(x: torch.Tensor, cfg: QuantConfig,
                gen: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax quantization.  Returns (int8 codes, f32 scales)."""
    xb = _to_blocks(x.float(), cfg.block)
    scales = block_scales(xb, cfg.qmax)
    q = _round(xb * scales, cfg, gen)
    q = torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int8)
    return q.reshape(-1), scales.reshape(-1)


def dequant_block(q: torch.Tensor, scales: torch.Tensor,
                  cfg: QuantConfig) -> torch.Tensor:
    qb = _to_blocks(q.float(), cfg.block)
    return (qb / scales.reshape(-1, 1)).reshape(-1)


# ---------------------------------------------------------------------------
# tensor-scaled codec (one dynamic absmax scale per segment)
# ---------------------------------------------------------------------------

def quant_tensor(x: torch.Tensor, cfg: QuantConfig,
                 gen: torch.Generator | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-segment absmax quantization.  Returns (int8 codes, (1,) f32 scale)."""
    xf = x.float()
    scale = block_scales(xf.reshape(1, -1), cfg.qmax).reshape(())
    q = _round(xf * scale, cfg, gen)
    q = torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int8)
    return q, scale.reshape(1)


# ---------------------------------------------------------------------------
# int4 <-> int8 packing (two nibbles per byte; wire format)
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8-held int4 values (in [-8, 7]) into half-length int8.

    Layout: byte = (hi << 4) | (lo & 0xF), element 2i -> lo, 2i+1 -> hi.
    """
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even length, got {q.shape}")
    lo = q[..., 0::2].view(torch.uint8) & 0xF
    hi = q[..., 1::2].view(torch.uint8) & 0xF
    return ((hi << 4) | lo).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns int8 values in [-8, 7]."""
    b = p.view(torch.uint8)
    lo = (b & 0xF).to(torch.int8)
    hi = ((b >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)   # sign-extend nibbles
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


# ---------------------------------------------------------------------------
# sign packing (onebit wire format: 8 signs per byte)
# ---------------------------------------------------------------------------

SIGN_PACK = 8  # signs per wire byte


def pack_signs(bits: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 sign bits into uint8 bytes, 8 per byte.

    Layout: bit j of byte k = element 8k + j (LSB first).
    """
    if bits.shape[-1] % SIGN_PACK:
        raise ValueError(f"sign packing needs a multiple of {SIGN_PACK} "
                         f"elements, got {tuple(bits.shape)}")
    b = bits.to(torch.uint8)
    out = b[..., 0::SIGN_PACK]
    for j in range(1, SIGN_PACK):
        out = out | (b[..., j::SIGN_PACK] << j)
    return out


def unpack_signs(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_signs`; returns uint8 values in {0, 1}."""
    b = p.view(torch.uint8)
    out = torch.stack([(b >> j) & 1 for j in range(SIGN_PACK)], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * SIGN_PACK)


# ---------------------------------------------------------------------------
# 8-bit error codecs (paper Eqn. (7) and the f8 variant)
# ---------------------------------------------------------------------------

def error_encode(e: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """High-precision error -> 8-bit storage."""
    if cfg.error_codec == "none":
        return e.float()
    if cfg.error_codec == "bf16":
        return e.to(torch.bfloat16)
    if cfg.error_codec == "int8":
        q = torch.round(e.float() * cfg.error_scale)
        return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)
    if cfg.error_codec == "f8":
        # saturate to the f8_e4m3 range first: the reference's cast turns
        # out-of-range values into NaN where torch's saturates, so the clip
        # is what makes both agree (and keeps outliers finite)
        scaled = torch.clamp(e.float() * cfg.error_scale, -F8_MAX, F8_MAX)
        return scaled.to(torch.float8_e4m3fn)
    raise ValueError(cfg.error_codec)


def error_decode(e8: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """8-bit storage -> float32 error (decompressor(e; s_e))."""
    if cfg.error_codec in ("none", "bf16"):
        return e8.float()
    return e8.float() / cfg.error_scale


def error_dtype(cfg: QuantConfig) -> torch.dtype:
    return {
        "none": torch.float32,
        "bf16": torch.bfloat16,
        "int8": torch.int8,
        "f8": torch.float8_e4m3fn,
    }[cfg.error_codec]


# ---------------------------------------------------------------------------
# full wire round trips used by the comm strategies
# ---------------------------------------------------------------------------

def compress(x: torch.Tensor, cfg: QuantConfig,
             gen: torch.Generator | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 -> (packed int8 payload, f32 scales).  Fixed mode returns a
    size-1 scales array (the static scale) so all modes share a wire shape."""
    if cfg.mode == "fixed":
        q = quant_fixed(x, cfg, gen)
        scales = torch.full((1,), cfg.scale, dtype=torch.float32,
                            device=x.device)
    elif cfg.mode == "tensor":
        q, scales = quant_tensor(x, cfg, gen)
    else:
        q, scales = quant_block(x, cfg, gen)
    if cfg.bits == 4:
        q = pack_int4(q)
    return q, scales


def decompress(payload: torch.Tensor, scales: torch.Tensor,
               cfg: QuantConfig) -> torch.Tensor:
    q = unpack_int4(payload) if cfg.bits == 4 else payload
    if cfg.mode in ("fixed", "tensor"):
        return q.float() / scales[0]
    return dequant_block(q, scales, cfg)
