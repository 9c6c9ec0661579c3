"""Wire-codec registry: one implementation per sync strategy.

Port of ``repro.core.codec`` for the quantized strategies (``loco``,
``ef``, ``naive4``) and ``onebit``:

* ``encode(g, state) -> (wire, new_state)``: the per-node compressor;
  ``wire`` is a dict of tensors that crosses the all-to-all;
* ``decode_mean(recv) -> shard``: what the receiver reconstructs from the
  ``D`` peer rows of each wire leaf (leading axis ``D``), averaged;
* ``wire_shapes(n) -> {name: WireLeaf}``: static shapes/dtypes of the wire
  tensors for an ``(n,)`` segment and how each crosses the group.

Where the reference dispatched Pallas fast paths on ``use_kernels``, the
port always routes the cells that have a kernel -- encode for
``(loco, 4|8, block, f8)`` and ``(ef, 4|8, block, bf16)``, decode_mean for
every quantized codec in block mode -- through
:mod:`repro_torch.kernels.loco_quant`, and onebit's encode through
:mod:`repro_torch.kernels.sign_pack`; their wrappers launch the CUDA kernel
for a CUDA tensor and run the plain version for a CPU tensor.  The other
cells (fixed/tensor modes, naive4 encode, stochastic rounding) run the
codec's own plain ops (``encode_ref``/``decode_mean_ref``) on any device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

from repro_torch.core import quantizer as Q
from repro_torch.core.loco import SyncConfig, mean_rows
from repro_torch.kernels import loco_quant as LQ
from repro_torch.kernels import sign_pack as SP


@dataclasses.dataclass(frozen=True)
class WireLeaf:
    """Static description of one wire tensor for an ``(n,)`` segment.

    ``comm``: ``split`` -- row ``i`` of ``reshape(D, -1)`` goes to peer ``i``
    (all-to-all); ``gather`` -- per-node metadata every peer needs
    (all-gather); ``none`` -- static metadata known to every peer already.
    """

    shape: tuple[int, ...]
    dtype: torch.dtype
    comm: Literal["split", "gather", "none"] = "split"

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


class Codec:
    """One sync strategy's wire format.  Subclasses implement the plain
    ``_ref`` forms; ``encode``/``decode_mean`` add the kernel dispatch."""

    strategy: str

    def __init__(self, cfg: SyncConfig):
        if cfg.strategy != self.strategy:
            raise ValueError(f"{type(self).__name__} got strategy "
                             f"{cfg.strategy!r}")
        self.cfg = cfg

    # ---- static facts ------------------------------------------------------
    def state_dtype(self) -> torch.dtype:
        raise NotImplementedError

    def needs_state(self) -> bool:
        return self.cfg.needs_state()

    def state_decode(self, state: torch.Tensor) -> torch.Tensor:
        """Stored compressor state -> logical f32 error values."""
        return state.float()

    def state_encode(self, e: torch.Tensor) -> torch.Tensor:
        """Logical f32 error values -> stored compressor state."""
        return e.to(self.state_dtype())

    def wire_shapes(self, n: int) -> dict[str, WireLeaf]:
        raise NotImplementedError

    # ---- plain forms (the correctness contract) ----------------------------
    def encode_ref(self, g, state, gen=None):
        raise NotImplementedError

    def decode_mean_ref(self, recv: dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    # ---- dispatching entry points ------------------------------------------
    def encode(self, g: torch.Tensor, state: torch.Tensor,
               gen: torch.Generator | None = None, *, inplace: bool = False):
        """Compress one local segment -> (wire dict, new_state).

        ``g`` may be bf16 or f32 (the codecs compute in f32; the upcast is
        exact).  ``inplace``: the caller no longer needs ``state``, so a
        codec may write the new state into it and return ``state`` itself;
        callers check identity, since a codec may also return a new tensor.
        """
        return self.encode_ref(g, state, gen)

    def decode_mean(self, recv: dict[str, torch.Tensor],
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Received per-peer wire rows (leading axis D) -> averaged shard,
        computed in f32 and rounded to ``out_dtype``."""
        return self.decode_mean_ref(recv).to(out_dtype)

    def roundtrip(self, g: torch.Tensor, state: torch.Tensor,
                  gen: torch.Generator | None = None):
        """One-node encode -> decode: (dequantized contribution, new_state).

        The simulation form (``loco.local_compress``) runs the wire round
        trip, not a shortcut, which keeps sim == distributed.
        """
        wire, new_state = self.encode(g, state, gen)
        d = self.decode_mean({k: v[None] for k, v in wire.items()})
        return d, new_state


# ---------------------------------------------------------------------------
# codec registry
# ---------------------------------------------------------------------------

CODECS: dict[str, type[Codec]] = {}


def register_codec(cls: type[Codec]) -> type[Codec]:
    CODECS[cls.strategy] = cls
    return cls


def get_codec(cfg: SyncConfig) -> Codec:
    try:
        cls = CODECS[cfg.strategy]
    except KeyError:
        raise ValueError(
            f"no wire codec registered for strategy {cfg.strategy!r} "
            f"(registered: {sorted(CODECS)}); 'fp' has no all-to-all wire "
            "format and is handled outside the registry"
        ) from None
    return cls(cfg)


# ---------------------------------------------------------------------------
# quantized codecs (loco / ef / naive4): int4/int8 payload + scales
# ---------------------------------------------------------------------------

class _QuantizedCodec(Codec):
    """Shared wire format of the payload+scales strategies."""

    # error storage the encode kernel takes for this strategy (None: no
    # encode kernel)
    def _kernel_err(self) -> str | None:
        return None

    def _block_kernel_cell(self) -> bool:
        qc = self.cfg.quant
        return (qc.mode == "block" and qc.block == LQ.QBLOCK
                and qc.bits in (4, 8) and not qc.stochastic_rounding)

    def wire_shapes(self, n: int) -> dict[str, WireLeaf]:
        qc = self.cfg.quant
        if qc.bits not in (4, 8):
            raise ValueError(f"quantized codecs take 4 or 8 bits, got {qc.bits}")
        payload = WireLeaf((n // 2,) if qc.bits == 4 else (n,), torch.int8)
        if qc.mode == "block":
            scales = WireLeaf((n // qc.block,), torch.float32)
        elif qc.mode == "tensor":
            # dynamic per-node scale: every peer needs every node's value
            scales = WireLeaf((1,), torch.float32, comm="gather")
        else:  # fixed: static config scale, known to every peer already
            scales = WireLeaf((1,), torch.float32, comm="none")
        return {"payload": payload, "scales": scales}

    def encode(self, g, state, gen=None, *, inplace=False):
        err = self._kernel_err()
        if err is None or not self._block_kernel_cell():
            return self.encode_ref(g, state, gen)
        qc = self.cfg.quant
        beta, escale = ((self.cfg.beta, qc.error_scale) if err == "f8"
                        else (1.0, 1.0))
        # the kernel takes a bf16 or f32 gradient as it is: no f32 copy
        if g.dtype not in LQ.DTYPES:
            g = g.float()
        payload, scales, e_new = LQ.fused_compress(
            g.contiguous(), state, bits=qc.bits, beta=beta, escale=escale,
            err=err, e_out=state if inplace else None)
        return {"payload": payload, "scales": scales}, e_new

    def decode_mean(self, recv, out_dtype=torch.float32):
        if not self._block_kernel_cell():
            return self.decode_mean_ref(recv).to(out_dtype)
        return LQ.dequant_mean(recv["payload"], recv["scales"],
                               bits=self.cfg.quant.bits, out_dtype=out_dtype)

    def decode_mean_ref(self, recv):
        qc = self.cfg.quant
        contrib = torch.stack([Q.decompress(p, s, qc) for p, s
                               in zip(recv["payload"], recv["scales"])])
        return mean_rows(contrib)

    def _check_gen(self, gen):
        if self.cfg.quant.stochastic_rounding and gen is None:
            raise ValueError(
                f"{self.strategy}: QuantConfig.stochastic_rounding is set "
                "but no generator reached the encode path -- rounding would "
                "silently fall back to round-to-nearest. Pass a "
                "torch.Generator, or disable stochastic_rounding.")


@register_codec
class LocoCodec(_QuantizedCodec):
    """Paper Algorithm 1: error-feedback + moving average + 8-bit error."""

    strategy = "loco"

    def state_dtype(self):
        return Q.error_dtype(self.cfg.quant)

    def state_decode(self, state):
        return Q.error_decode(state, self.cfg.quant)

    def state_encode(self, e):
        return Q.error_encode(e, self.cfg.quant)

    def _kernel_err(self):
        return "f8" if self.cfg.quant.error_codec == "f8" else None

    def encode_ref(self, g, state, gen=None):
        self._check_gen(gen)
        cfg, qc = self.cfg, self.cfg.quant
        g = g.float()
        e = Q.error_decode(state, qc)                    # decompressor(e; s_e)
        h = g + e                                        # Eqn. (2)
        payload, scales = Q.compress(h, qc, gen)         # Eqn. (3)
        d = Q.decompress(payload, scales, qc)
        e_tilde = (1.0 - cfg.beta) * e + cfg.beta * (h - d)   # Eqn. (5)
        return ({"payload": payload, "scales": scales},
                Q.error_encode(e_tilde, qc))             # Eqn. (7)


@register_codec
class EFCodec(_QuantizedCodec):
    """Seide et al. error feedback: full last-step error, no moving average."""

    strategy = "ef"

    def state_dtype(self):
        return torch.bfloat16

    def _kernel_err(self):
        return "bf16"

    def encode_ref(self, g, state, gen=None):
        self._check_gen(gen)
        qc = self.cfg.quant
        h = g.float() + state.float()
        payload, scales = Q.compress(h, qc, gen)
        d = Q.decompress(payload, scales, qc)
        return ({"payload": payload, "scales": scales},
                (h - d).to(state.dtype))


@register_codec
class Naive4Codec(_QuantizedCodec):
    """Zero++-style direct quantization, no error feedback (4- or 8-bit)."""

    strategy = "naive4"

    def state_dtype(self):
        return torch.float32  # dummy

    def encode_ref(self, g, state, gen=None):
        self._check_gen(gen)
        payload, scales = Q.compress(g.float(), self.cfg.quant, gen)
        return {"payload": payload, "scales": scales}, state


# ---------------------------------------------------------------------------
# onebit: sign compression, 8 signs per wire byte + per-segment L1 scale
# ---------------------------------------------------------------------------

@register_codec
class OnebitCodec(Codec):
    """1-bit Adam-style sign compression with error feedback.

    Wire: ``n/8`` packed sign bytes (bit j of byte k = sign of element
    ``8k+j``) plus one f32 L1 scale, all-gathered so every peer can
    reconstruct ``sign(h) * scale_peer``.  Receivers decode ``bit -> +-1``;
    an exact zero encodes as ``-1``.  ``encode`` computes ``h`` and its
    scale here and packs through :func:`repro_torch.kernels.sign_pack.
    onebit_pack`; ``decode_mean`` is plain ops (the reference has no kernel
    for it).
    """

    strategy = "onebit"

    def state_dtype(self):
        return torch.bfloat16

    def wire_shapes(self, n: int) -> dict[str, WireLeaf]:
        if n % Q.SIGN_PACK:
            raise ValueError(f"onebit needs a multiple of {Q.SIGN_PACK} "
                             f"elements, got {n}")
        return {"payload": WireLeaf((n // Q.SIGN_PACK,), torch.uint8),
                "scales": WireLeaf((1,), torch.float32, comm="gather")}

    @staticmethod
    def _compensate(g, state):
        h = g.float() + state.float()
        return h, torch.mean(torch.abs(h))

    def encode(self, g, state, gen=None, *, inplace=False):
        h, scale = self._compensate(g, state)
        packed, e_new = SP.onebit_pack(h, scale)
        return {"payload": packed, "scales": scale.reshape(1)}, e_new

    def encode_ref(self, g, state, gen=None):
        h, scale = self._compensate(g, state)
        packed, e_new = SP.onebit_pack_plain(h, scale)
        return {"payload": packed, "scales": scale.reshape(1)}, e_new

    def decode_mean_ref(self, recv):
        D = recv["payload"].shape[0]
        bits = Q.unpack_signs(recv["payload"]).float()
        return mean_rows((2.0 * bits - 1.0) * recv["scales"].reshape(D, 1))
