"""Wire-codec registry: one implementation per sync strategy.

Port of ``repro.core.codec``: the quantized strategies (``loco``, ``ef``,
``naive4``), ``onebit`` and the ragged block top-k (``topk``):

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
codec's own plain ops (``encode_ref``/``decode_mean_ref``) on any device,
as does ``topk``, which is plain jnp in the reference (no Pallas kernel).
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

    ``count_of`` makes the leaf **ragged**: a capacity-padded array of
    fixed-size slots (``shape`` is the static capacity) whose sibling leaf
    ``count_of`` (one u32 per slot group, in the same wire dict) says how
    many leading slots of each group are live.  Slots at or past the count
    are dead: the encoder writes zeros there and the receiver re-zeroes
    them after the exchange (``wirepack.mask_by_count``), so the wire
    geometry stays static while its information varies.  Ragged leaves
    are ``comm="split"``.
    """

    shape: tuple[int, ...]
    dtype: torch.dtype
    comm: Literal["split", "gather", "none"] = "split"
    count_of: str | None = None

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def ragged(self) -> bool:
        return self.count_of is not None


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

    def init_state(self, n: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
        """A zero state for an ``(n,)`` segment (a ``(1,)`` f32 dummy when
        stateless)."""
        if self.needs_state():
            return torch.zeros(n, dtype=self.state_dtype(), device=device)
        return torch.zeros(1, dtype=torch.float32, device=device)

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

    # ---- health-metric hooks (telemetry/metrics) ----------------------------
    # Both return {field: f32 sum} with keys from telemetry.metrics
    # UNIT_FIELDS; every value is a plain sum, so the step's one all-reduce
    # adds them over the ranks.  They read already-materialised tensors
    # (the synced gradient, the stored state) with plain torch ops and
    # never launch a kernel, as the reference's never dispatch Pallas.

    def grad_metrics(self, seg: torch.Tensor) -> dict[str, torch.Tensor]:
        """Quantizer-health probe over one f32 gradient segment: the
        segment re-quantised with this codec's wire config (saturation
        rate, log2-scale range), a proxy for the per-node encode, whose
        payload stays inside the backward.  Default: no probe."""
        return {}

    def state_metrics(self, state: torch.Tensor) -> dict[str, torch.Tensor]:
        """Exact metrics of the stored error-feedback state."""
        e = self.state_decode(state).float()
        return {
            "err_sq": torch.sum(e * e),
            "err_sat_cnt": self._state_sat_count(state),
            "err_tot": _f32(e.numel(), e.device),
            "err_bad": torch.sum(~torch.isfinite(e)).float(),
        }

    def _state_sat_count(self, state: torch.Tensor) -> torch.Tensor:
        """Stored error values pinned at the error codec's bound (0 for
        unbounded float storage)."""
        return _f32(0, state.device)

    def roundtrip(self, g: torch.Tensor, state: torch.Tensor,
                  gen: torch.Generator | None = None):
        """One-node encode -> decode: (dequantized contribution, new_state).

        The simulation form (``loco.local_compress``) runs the wire round
        trip, not a shortcut, which keeps sim == distributed.
        """
        wire, new_state = self.encode(g, state, gen)
        d = self.decode_mean({k: v[None] for k, v in wire.items()})
        return d, new_state


def _f32(x, device) -> torch.Tensor:
    # a fill on the device: no host-to-device copy, so no stream sync
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _scale_stats(scales: torch.Tensor) -> dict[str, torch.Tensor]:
    """log2-scale sums and the non-finite count of a probe's scales."""
    finite = torch.isfinite(scales)
    l2 = torch.where(finite, torch.log2(torch.clamp(scales, min=1e-30)),
                     torch.zeros_like(scales))
    return {"scale_l2_sum": torch.sum(l2),
            "scale_l2_sqsum": torch.sum(l2 * l2),
            "scale_cnt": _f32(scales.numel(), scales.device),
            "scale_bad": torch.sum(~finite).float()}


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

    def grad_metrics(self, seg):
        qc = self.cfg.quant
        x = seg.float()
        if qc.mode == "fixed":
            q = Q.quant_fixed(x, qc)
            scales = torch.full((1,), qc.scale, dtype=torch.float32,
                                device=x.device)
        elif qc.mode == "tensor":
            q, scales = Q.quant_tensor(x, qc)
        else:
            q, scales = Q.quant_block(x, qc)
        return {"sat_cnt": torch.sum((q == qc.qmax) | (q == qc.qmin)).float(),
                "sat_tot": _f32(q.numel(), x.device),
                **_scale_stats(scales)}

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

    def _state_sat_count(self, state):
        # stored errors clipped at the codec bound: outliers the
        # compensation state cannot represent (f8 saturates at +-448
        # pre-scale, int8 at +-127; bf16/none storage is unbounded).  f8
        # reads its codes: |code| == 0x7E is +-448 (0x7F is NaN).
        ec = self.cfg.quant.error_codec
        if ec == "f8":
            return torch.sum((state.view(torch.uint8) & 0x7F) == 0x7E).float()
        if ec == "int8":
            return torch.sum(state.float().abs() >= 127.0).float()
        return _f32(0, state.device)

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
        """``h = g + e`` and its scale ``mean |h|``, summed in f64 and
        rounded once to f32: the same bits on the CPU and on the card,
        whose f32 reductions add in other orders."""
        h = g.float() + state.float()
        total = torch.sum(torch.abs(h), dtype=torch.float64)
        n = torch.full((), float(h.numel()), dtype=torch.float64,
                       device=h.device)
        return h, (total / n).float()

    def encode(self, g, state, gen=None, *, inplace=False):
        h, scale = self._compensate(g, state)
        packed, e_new = SP.onebit_pack(h, scale)
        return {"payload": packed, "scales": scale.reshape(1)}, e_new

    def encode_ref(self, g, state, gen=None):
        h, scale = self._compensate(g, state)
        packed, e_new = SP.onebit_pack_plain(h, scale)
        return {"payload": packed, "scales": scale.reshape(1)}, e_new

    def grad_metrics(self, seg):
        # sign compression has no clipping bound; "saturation" here is the
        # positive-sign fraction (healthy gradients sit near 0.5), and the
        # scale stats track the segment's L1 scale
        x = seg.float()
        scale = LQ._divide(torch.sum(torch.abs(x)), float(x.numel()))
        return {"sat_cnt": torch.sum(x > 0).float(),
                "sat_tot": _f32(x.numel(), x.device),
                **_scale_stats(scale.reshape(1))}

    def decode_mean_ref(self, recv):
        D = recv["payload"].shape[0]
        bits = Q.unpack_signs(recv["payload"]).float()
        return mean_rows((2.0 * bits - 1.0) * recv["scales"].reshape(D, 1))


# ---------------------------------------------------------------------------
# topk: block-local top-k sparsification with error feedback (ragged wire)
# ---------------------------------------------------------------------------

# Selection block: top-k is taken per contiguous TOPK_SEL-element block of
# the compensated gradient.  Equal to buckets.ALIGN, so every bucket edge is
# a selection-block edge and every wire leaf splits evenly over the peers.
TOPK_SEL = 512


def topk_k(cfg: SyncConfig) -> int:
    """Live slots kept per TOPK_SEL block (>= 1)."""
    return max(1, min(TOPK_SEL, int(round(cfg.topk_frac * TOPK_SEL))))


def topk_cap(cfg: SyncConfig) -> int:
    """Static slot capacity per block: k rounded up to a multiple of 4 (the
    wire budget; keeps each block's idx/val bytes 8-byte aligned);
    ``topk_frac=1.0`` gives TOPK_SEL, the dense special case."""
    return min(TOPK_SEL, -(-topk_k(cfg) // 4) * 4)


def _live(cnt: torch.Tensor, cap: int) -> torch.Tensor:
    """``(..., u, cap)`` mask of the slots below each group's u32 count
    (read through an int32 view: counts never exceed TOPK_SEL)."""
    c = cnt.view(torch.int32).to(torch.int64)
    return torch.arange(cap, device=cnt.device) < c[..., None]


def _topk_scatter(idx: torch.Tensor, val: torch.Tensor,
                  cnt: torch.Tensor) -> torch.Tensor:
    """Reconstruct ``(u * TOPK_SEL,)`` f32 from capacity-padded ``(u, cap)``
    slots: the one decode of the encoder (exact error feedback) and the
    receiver.  Dead slots (at or past ``cnt``) add zero at index 0; live
    indices within a block are distinct, so no add collides with another
    nonzero one and the result is exact on any device."""
    u, cap = idx.shape
    live = _live(cnt, cap)
    v = torch.where(live, val.float(), torch.zeros((), device=val.device))
    i = torch.where(live, idx.view(torch.int16).to(torch.int64), 0)
    out = torch.zeros((u, TOPK_SEL), dtype=torch.float32, device=val.device)
    return out.scatter_add_(1, i, v).reshape(-1)


def topk_select(a: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of the non-negative ``a``
    (``|h|``) and their indices, in descending order, equal values by
    ascending index: the order of ``jax.lax.top_k``.  ``torch.topk``
    orders ties as it likes, on the CPU and on the card alike, so it runs
    on unique int64 keys: a non-negative f32's bits order as its value,
    and the reversed column breaks ties toward the lower index."""
    w = a.shape[1]
    col = torch.arange(w - 1, -1, -1, device=a.device)
    key = a.contiguous().view(torch.int32).to(torch.int64) * w + col
    idx = (w - 1) - torch.topk(key, k, dim=1).values % w
    return torch.gather(a, 1, idx), idx


@register_codec
class TopKCodec(Codec):
    """SparseLoCo-style block top-k with LoCo error feedback.

    Per TOPK_SEL block of the compensated gradient ``h = g + e``, the
    ``topk_k`` largest-|h| entries cross the wire as (u16 index, bf16
    value) pairs in a capacity-padded ragged leaf pair, with a u32 live
    count per block; what is not sent feeds the LoCo moving-average error
    (Eqns. 2, 5, 7 with the sparse reconstruction as ``d``).  Exact zeros
    are never sent, so a count lands anywhere in ``[0, k]``.
    """

    strategy = "topk"

    def state_dtype(self):
        return Q.error_dtype(self.cfg.quant)

    def state_decode(self, state):
        return Q.error_decode(state, self.cfg.quant)

    def state_encode(self, e):
        return Q.error_encode(e, self.cfg.quant)

    def _state_sat_count(self, state):
        bound = {"f8": 448.0, "int8": 127.0}.get(self.cfg.quant.error_codec)
        if bound is None:
            return _f32(0, state.device)
        return torch.sum(state.float().abs() >= bound).float()

    def wire_shapes(self, n: int) -> dict[str, WireLeaf]:
        if n % TOPK_SEL:
            raise ValueError(f"topk needs a multiple of {TOPK_SEL} elements, "
                             f"got {n}")
        u = n // TOPK_SEL
        cap = topk_cap(self.cfg)
        return {
            "cnt": WireLeaf((u,), torch.uint32),
            "idx": WireLeaf((u * cap,), torch.uint16, count_of="cnt"),
            "val": WireLeaf((u * cap,), torch.bfloat16, count_of="cnt"),
        }

    def encode_ref(self, g, state, gen=None):
        cfg, qc = self.cfg, self.cfg.quant
        k, cap = topk_k(cfg), topk_cap(cfg)
        e = Q.error_decode(state, qc)
        h = g.float() + e                                        # Eqn. (2)
        hb = h.reshape(-1, TOPK_SEL)
        u = hb.shape[0]
        av, ai = topk_select(hb.abs(), k)   # descending: the live slots lead
        valid = av > 0
        cnt = valid.sum(dim=1, dtype=torch.int32)
        vals = torch.gather(hb, 1, ai)
        val_w = torch.zeros((u, cap), dtype=torch.bfloat16, device=h.device)
        val_w[:, :k] = torch.where(valid, vals, torch.zeros_like(vals))
        idx_w = torch.zeros((u, cap), dtype=torch.int16, device=h.device)
        idx_w[:, :k] = torch.where(valid, ai, torch.zeros_like(ai))
        idx_w = idx_w.view(torch.uint16)
        cnt = cnt.view(torch.uint32)
        d = _topk_scatter(idx_w, val_w, cnt)   # == receiver reconstruction
        e_tilde = (1.0 - cfg.beta) * e + cfg.beta * (h - d)      # Eqn. (5)
        return ({"cnt": cnt, "idx": idx_w.reshape(-1),
                 "val": val_w.reshape(-1)},
                Q.error_encode(e_tilde, qc))                     # Eqn. (7)

    def decode_mean_ref(self, recv):
        cnt = recv["cnt"]
        D, u = cnt.shape
        cap = recv["idx"].shape[1] // u
        contrib = _topk_scatter(recv["idx"].reshape(D * u, cap),
                                recv["val"].reshape(D * u, cap),
                                cnt.reshape(D * u))
        return mean_rows(contrib.reshape(D, -1))
