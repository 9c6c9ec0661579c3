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
    # Multi-tier exchange: the two-stage (pod, data) exchange and its
    # stage-2 wire config; ``tiers`` below is the N-tier schedule.
    hierarchical: bool = False
    stage2: "SyncConfig | None" = None
    topk_frac: float = 0.01      # strategy "topk" only
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

    if s2.strategy not in codec_lib.CODECS or (
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


def validate_stage2(cfg: SyncConfig) -> SyncConfig:
    """Resolve and check a hierarchical config's stage-2 (first-tier)
    codec."""
    return validate_tier_codec(cfg.stage2_sync())


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
    for t, tier in enumerate(sync_schedule(cfg)):
        if tier.every < 1:
            raise ValueError(
                f"tier {t + 1} cadence every={tier.every} must be >= 1")


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


def _ef21_local(g: torch.Tensor, gest: torch.Tensor, cfg: SyncConfig,
                gen: torch.Generator | None = None):
    """EF21: communicate the compressed innovation ``c = C(g - g_est)``;
    the receiver reconstructs ``g_est + c``, the new estimate."""
    from repro_torch.core import quantizer as Q

    if cfg.quant.stochastic_rounding and gen is None:
        raise ValueError(
            "ef21: QuantConfig.stochastic_rounding is set but no generator "
            "reached the compressor (the codecs' loud-failure contract)")
    payload, scales = Q.compress(g.float() - gest.float(), cfg.quant, gen)
    gest_new = gest.float() + Q.decompress(payload, scales, cfg.quant)
    return gest_new, gest_new.to(gest.dtype)


def local_compress(g: torch.Tensor, state: torch.Tensor, cfg: SyncConfig,
                   gen: torch.Generator | None = None):
    """Dispatch to the strategy's per-node compressor. fp is identity.
    ``gen`` seeds stochastic rounding (required when it is configured)."""
    if cfg.strategy == "fp":
        return g, state
    if cfg.strategy == "ef21":
        return _ef21_local(g, state, cfg, gen)
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
    order the receive-side kernel and the reference use), by one IEEE
    division on any device (a Python-scalar divisor would be a multiply by
    its inverse on CUDA)."""
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc / torch.full((), float(x.shape[0]), dtype=acc.dtype,
                            device=acc.device)


def _node_gens(n: int, step: int, gen: torch.Generator | None,
               device) -> list[torch.Generator]:
    """One rounding generator per simulated node, seeded from ``gen`` (or,
    without one, from ``step``, so a training loop draws fresh noise every
    round with no extra plumbing)."""
    if gen is None:
        gen = torch.Generator().manual_seed(0x10C0 * 1_000_003 + int(step))
    seeds = torch.randint(0, 2**62, (n,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def _sim_round(g_nodes: torch.Tensor, state: torch.Tensor, step: int,
               cfg: SyncConfig, gen: torch.Generator | None):
    """One simulated compression round: each node's ``local_compress``
    (with its own rounding generator when stochastic rounding is on) and
    ``maybe_reset``.  Shared by :func:`sim_sync` and :func:`sim_sync_hier`
    so the two forms cannot drift."""
    n = g_nodes.shape[0]
    if cfg.quant.stochastic_rounding and cfg.strategy != "onebit":
        gens = _node_gens(n, step, gen, g_nodes.device)
    else:
        gens = [None] * n
    outs = [local_compress(g, s, cfg, gn)
            for g, s, gn in zip(g_nodes, state, gens)]
    d = torch.stack([o[0] for o in outs])
    new_state = torch.stack([maybe_reset(o[1], step, cfg) for o in outs])
    return d, new_state


def sim_sync(g_nodes: torch.Tensor, state: torch.Tensor, step: int,
             cfg: SyncConfig, gen: torch.Generator | None = None):
    """One synchronization round over N simulated nodes.

    g_nodes: (N, d) per-node local gradients; returns (g_hat (d,),
    new_state (N, d)) where g_hat is the gradient every node reconstructs
    after the collective (paper Eqn. 8).  With stochastic rounding each
    node rounds with its own generator, seeded from ``gen`` (or from
    ``step`` when none is given).
    """
    if cfg.strategy == "fp":
        return mean_rows(g_nodes), state
    d, new_state = _sim_round(g_nodes, state, step, cfg, gen)
    return mean_rows(d), new_state


def sim_sync_hier(g_nodes: torch.Tensor, state: torch.Tensor, step: int,
                  cfg: SyncConfig, pods: int,
                  gen: torch.Generator | None = None):
    """Two-stage (hierarchical) synchronization over ``pods`` simulated
    pods: the simulation form of ``comm.hierarchical_sync``, equal to it
    by construction.

    g_nodes: (N, d) per-node local gradients, N = pods * Dd; node
    ``r = p * Dd + dd`` lives in pod ``p`` at intra-pod index ``dd`` (the
    distributed rank order).  Stage 1 is each node's codec round trip (as
    in :func:`sim_sync`) and the intra-pod mean; stage 2 re-encodes, per
    destination device, the pod-mean slice that device holds distributed
    (the ``pods`` chunks ``{p' * Dd + dd}`` in chunk order) through
    ``cfg.stage2_sync()``'s codec, then means over source pods.  Chunk
    granularity ``c = d / N`` must keep block edges whole (the buckets
    layer's ``c % 512 == 0``).  Returns (g_hat (d,), new_state (N, d)).
    """
    from repro_torch.core import codec as codec_lib

    if cfg.strategy not in codec_lib.CODECS:
        raise ValueError(
            f"hierarchical sync needs a registered wire codec; strategy "
            f"{cfg.strategy!r} has none (registered: "
            f"{sorted(codec_lib.CODECS)})")
    N, d = g_nodes.shape
    if N % pods or d % N:
        raise ValueError(f"{N} nodes of {d} elements do not split into "
                         f"{pods} pods of whole chunks")
    dd_size, c = N // pods, d // N

    # ---- stage 1: per-node codec round trip (== sim_sync), pod mean -------
    dec, new_state = _sim_round(g_nodes, state, step, cfg, gen)
    pod_means = torch.stack([mean_rows(rows) for rows in
                             dec.reshape(pods, dd_size, d)])  # (pods, d)

    # ---- stage 2: per-device slice re-encode across pods -------------------
    codec2 = codec_lib.get_codec(validate_stage2(cfg))
    # device (p_src, dd)'s stage-2 input: pod p_src's mean on the chunks
    # {p * Dd + dd : p}, in chunk order
    slices = (pod_means.reshape(pods, pods, dd_size, c)      # [p_src, p, dd, c]
              .permute(0, 2, 1, 3).reshape(pods, dd_size, pods * c))
    dec2 = torch.stack([torch.stack([
        codec2.roundtrip(x, codec2.init_state(x.shape[0], x.device))[0]
        for x in per_pod]) for per_pod in slices])           # [p_src, dd, P*c]
    # final chunk r = p * Dd + dd: the mean over source pods of their pieces
    ghat = mean_rows(dec2.reshape(pods, dd_size, pods, c))   # [dd, p, c]
    return ghat.permute(1, 0, 2).reshape(d), new_state


def deviation_bound(cfg: SyncConfig, d: int, k: int, c_inf: float,
                    alpha: float = 1.0) -> float:
    """Lemma 2's upper bound on ``||sum_i (g_hat_i - g_i)||``:
    ``T_c sqrt(d) alpha c_inf + sqrt(d) k / (2 s_e)`` (for the block-scaled
    error codecs ``1/(2 s_e)`` is the worst-case f8 relative step at the
    configured pre-scale)."""
    import math

    tc = cfg.reset_every if cfg.reset_every > 0 else k
    se = cfg.quant.error_scale
    return tc * math.sqrt(d) * alpha * c_inf + math.sqrt(d) * k / (2.0 * se)
