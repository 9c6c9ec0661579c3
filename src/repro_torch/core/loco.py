"""LoCo (Algorithm 1 of the paper) and baseline compressors: configs and the
simulation form.

Port of ``repro.core.loco``.  The sync configuration dataclasses keep the
reference's fields with one exception: ``use_kernels`` is gone, because the
port picks the CUDA kernel by the tensor's device (a CUDA tensor always goes
to the kernel, a CPU tensor to its plain version).

Two execution forms of the same math, as in the reference:

* **simulation** (:func:`sim_sync`): N logical nodes as the leading axis of
  an ``(N, d)`` tensor on one device;
* **distributed** (:mod:`repro_torch.core.comm`): the per-node compressor on
  each rank of a ``torch.distributed`` group, exchanged by all-to-all.

Both run each codec's encode -> decode wire round trip
(:mod:`repro_torch.core.codec`), so simulation == distributed by
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.quantizer import QuantConfig


@dataclasses.dataclass(frozen=True)
class SyncTier:
    """One outer tier of an N-tier sync schedule (``sync`` codec exchanged
    on steps where ``step % every == every - 1``)."""

    sync: "SyncConfig"
    every: int = 1


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """Static config of the gradient-synchronization strategy."""

    strategy: Literal["fp", "loco", "ef", "ef21", "naive4", "onebit",
                      "topk"] = "loco"
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    beta: float = 0.5            # moving-average weight on the *current* error (Eqn. 5)
    reset_every: int = 512       # T_c (Eqn. 7); 0 disables reset
    # Multi-tier exchange: two-stage multi-pod, its stage-2 wire config, and
    # the N-tier schedule (not ported yet: the distributed form raises when
    # set).
    hierarchical: bool = False
    stage2: "SyncConfig | None" = None
    topk_frac: float = 0.01      # strategy "topk" only (not ported yet)
    # Tier-0 sync cadence: exchange only on steps where
    # ``step % every == every - 1``; off-cadence steps fold the gradient
    # into the compensation-error state and return a zero shard.
    every: int = 1
    tiers: "tuple[SyncTier, ...] | None" = None

    def needs_state(self) -> bool:
        return self.strategy in ("loco", "ef", "ef21", "onebit", "topk")

    def stage2_sync(self) -> "SyncConfig":
        """Resolved stage-2 (inter-pod) wire config of the two-stage
        exchange: the first outer tier of an explicit ``tiers`` schedule,
        else ``stage2``, else 8-bit block naive4."""
        if self.tiers:
            return self.tiers[0].sync
        if self.stage2 is not None:
            return self.stage2
        return SyncConfig(
            strategy="naive4",
            quant=dataclasses.replace(self.quant, bits=8, mode="block",
                                      stochastic_rounding=False))


def sync_schedule(cfg: SyncConfig) -> tuple[SyncTier, ...]:
    """Resolve a config's outer-tier schedule (empty = flat single-tier):
    ``tiers`` when set, else the classic two-stage schedule (one outer tier
    running ``stage2_sync()`` every step) when ``hierarchical``."""
    if cfg.tiers is not None:
        return cfg.tiers
    if cfg.hierarchical:
        return (SyncTier(cfg.stage2_sync(), every=1),)
    return ()


def validate_tier_codec(s2: SyncConfig) -> SyncConfig:
    """Check one outer-tier (stage-2 / pod / WAN) wire config: a registered
    codec that is stateless (``topk`` allowed: tiers run it from a fresh
    zero error), not itself hierarchical, without stochastic rounding.
    Returns the config unchanged."""
    from repro_torch.core import codec as codec_lib

    if (s2.strategy not in codec_lib.CODECS and s2.strategy != "topk") or (
            s2.needs_state() and s2.strategy != "topk"):
        raise ValueError(
            f"stage-2 codec {s2.strategy!r} must be a stateless registered "
            "codec (the pod mean is recomputed every step; there is nothing "
            "for error feedback to persist against); use naive4-style "
            "direct quantization or topk")
    if s2.hierarchical or s2.stage2 is not None or s2.tiers:
        raise ValueError(
            "stage-2 config must not itself be hierarchical: there is no "
            "third network to stage over, and the flags would be silently "
            "ignored. Clear hierarchical/stage2 on the stage2 config.")
    if s2.quant.stochastic_rounding:
        raise ValueError(
            "stage-2 stochastic_rounding is not supported (no PRNG key "
            "reaches the stage-2 encode). Disable it on the stage2 config.")
    return s2


def validate_cadence(cfg: SyncConfig) -> None:
    """Check the cadence knobs of one sync config.

    Cadence (``every > 1``) accumulates off-cadence gradients into the
    compensation-error state, so it needs a stateful codec, and the error
    reset must fire only at period boundaries.
    """
    if cfg.every < 1:
        raise ValueError(f"sync cadence every={cfg.every} must be >= 1")
    if cfg.every > 1 and not cfg.needs_state():
        raise ValueError(
            f"sync cadence every={cfg.every} needs a stateful codec "
            f"(off-cadence steps accumulate into the compensation-error "
            f"state); strategy {cfg.strategy!r} has no state")
    if cfg.every > 1 and cfg.reset_every > 0 \
            and cfg.reset_every % cfg.every != 0:
        raise ValueError(
            f"reset_every={cfg.reset_every} must be a multiple of "
            f"every={cfg.every}: the error reset may only fire at cadence-"
            f"period boundaries, or it would discard a partially "
            f"accumulated gradient")


# ---------------------------------------------------------------------------
# per-node compressor cores
# ---------------------------------------------------------------------------

def state_dtype(cfg: SyncConfig) -> torch.dtype:
    from repro_torch.core import codec as codec_lib

    if cfg.strategy in codec_lib.CODECS:
        return codec_lib.get_codec(cfg).state_dtype()
    if cfg.strategy == "ef21":
        return torch.bfloat16
    return torch.float32  # dummy


def init_state(cfg: SyncConfig, n: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-node compressor state for a flat gradient of length n."""
    if cfg.needs_state():
        return torch.zeros(n, dtype=state_dtype(cfg), device=device)
    return torch.zeros(1, dtype=torch.float32, device=device)


def local_compress(g: torch.Tensor, state: torch.Tensor, cfg: SyncConfig,
                   gen: torch.Generator | None = None):
    """Dispatch to the strategy's per-node compressor. fp is identity."""
    if cfg.strategy == "fp":
        return g, state
    if cfg.strategy == "ef21":
        raise NotImplementedError(
            "ef21 is not ported yet (ROADMAP.md, queue A); use "
            "strategy='loco' or 'ef'")
    from repro_torch.core import codec as codec_lib

    return codec_lib.get_codec(cfg).roundtrip(g, state, gen)


def reset_due(step: int, cfg: SyncConfig) -> bool:
    """Whether the error reset (Eqn. 7) fires at ``step``: at T_c, 2 T_c,
    ... and never at step 0, which would discard the very first
    compression error before it compensated anything."""
    if cfg.strategy not in ("loco", "ef", "onebit", "topk") \
            or cfg.reset_every <= 0:
        return False
    return step % cfg.reset_every == 0 and step > 0


def maybe_reset(state: torch.Tensor, step: int,
                cfg: SyncConfig) -> torch.Tensor:
    """Error reset (Eqn. 7): zero the error every T_c steps."""
    return torch.zeros_like(state) if reset_due(step, cfg) else state


# ---------------------------------------------------------------------------
# simulation of N nodes on one device
# ---------------------------------------------------------------------------

def sim_init(cfg: SyncConfig, n_nodes: int, d: int,
             device: torch.device | str = "cpu") -> torch.Tensor:
    if cfg.needs_state():
        return torch.zeros(n_nodes, d, dtype=state_dtype(cfg), device=device)
    return torch.zeros(n_nodes, 1, dtype=torch.float32, device=device)


def mean_rows(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading axis, summed in row order then divided (the
    order the receive-side kernel and the reference use)."""
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc / x.shape[0]


def sim_sync(g_nodes: torch.Tensor, state: torch.Tensor, step: int,
             cfg: SyncConfig, gen: torch.Generator | None = None):
    """One synchronization round over N simulated nodes.

    g_nodes: (N, d) per-node local gradients; returns (g_hat (d,),
    new_state (N, d)) where g_hat is the gradient every node reconstructs
    after the collective (paper Eqn. 8).
    """
    if cfg.strategy == "fp":
        return mean_rows(g_nodes), state
    outs = [local_compress(g, s, cfg, gen) for g, s in zip(g_nodes, state)]
    d = torch.stack([o[0] for o in outs])
    new_state = torch.stack([maybe_reset(o[1], step, cfg) for o in outs])
    return mean_rows(d), new_state
