"""Collective helpers and the distributed gradient sync.

Port of the flat path of ``repro.core.comm``.  Where the reference ran
inside ``shard_map`` over mesh axes, the port runs on each rank of one
``torch.distributed`` process group spanning the data-parallel ranks (rank
order ``pod * DATA + data``, see :mod:`repro_torch.launch.mesh`), so
sequential ``all_gather``/``reduce_scatter``/``all_to_all`` stay mutually
inverse in chunk order.

``dist_sync`` is the distributed form of the strategies in
:mod:`repro_torch.core.loco`: quantize locally, exchange the low-bit payload
with one packed u8 all-to-all over the group, decompress and average
**locally in f32** (paper section 3.3).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import codec as codec_lib
from repro_torch.core import loco as loco_lib
from repro_torch.core import wirepack as WP
from repro_torch.core.loco import SyncConfig
from repro_torch.telemetry import profiler as PROF

# torch renamed the tensor-in/tensor-out collectives; take whichever exists
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def axis_size(group) -> int:
    return dist.get_world_size(group)


def all_gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """Gather 1-D chunks from every rank, in rank order."""
    D = axis_size(group)
    out = torch.empty(D * x.shape[0], dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out


def psum_scatter_flat(x: torch.Tensor, group) -> torch.Tensor:
    """Inverse of :func:`all_gather_flat` composed with a sum over peers."""
    D = axis_size(group)
    out = torch.empty(x.shape[0] // D, dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def all_to_all_chunks(x: torch.Tensor, group) -> torch.Tensor:
    """Full personalized exchange over the group.

    x: (N, c, ...) with N the group size; row i is the payload for peer i.
    Returns (N, c, ...): row j is what peer j sent for *my* chunk.
    """
    if x.shape[0] != axis_size(group):
        raise ValueError(f"{x.shape[0]} rows for a group of "
                         f"{axis_size(group)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


# ---------------------------------------------------------------------------
# distributed gradient synchronization (one segment)
# ---------------------------------------------------------------------------

def exchange_wire(
    wire: dict[str, torch.Tensor],
    shapes: dict[str, codec_lib.WireLeaf],
    D: int,
    group,
) -> dict[str, torch.Tensor]:
    """Move every wire leaf across the group per its ``comm`` kind.

    Returns the received dict: each leaf with a leading peer axis ``D``
    (``split`` -> all-to-all rows, ``gather`` -> per-peer metadata,
    ``none`` -> the local copy broadcast).  All ``split`` leaves ride ONE
    packed u8 all-to-all and all ``gather`` leaves ONE packed all-gather:
    collectives move bytes verbatim and the dtype views are exact, so the
    received tensors are bit-identical to one collective per leaf.
    """
    recv = {}
    split = [n for n, l in shapes.items() if l.comm == "split"]
    gather = [n for n, l in shapes.items() if l.comm == "gather"]
    for name, leaf in shapes.items():
        if leaf.comm == "none":  # static metadata, known to every peer
            recv[name] = wire[name].expand(D, *wire[name].shape)
    if split:
        rows = [WP.to_bytes(wire[n]).reshape(D, -1) for n in split]
        widths = [r.shape[1] for r in rows]
        buf = all_to_all_chunks(torch.cat(rows, dim=1), group)
        off = 0
        for name, w in zip(split, widths):
            recv[name] = WP.from_bytes(buf[:, off:off + w], shapes[name].dtype)
            off += w
    if gather:
        bufs = [WP.to_bytes(wire[n]) for n in gather]
        widths = [b.shape[0] for b in bufs]
        got = all_gather_flat(torch.cat(bufs), group).reshape(D, -1)
        off = 0
        for name, w in zip(gather, widths):
            piece = WP.from_bytes(got[:, off:off + w], shapes[name].dtype)
            recv[name] = piece.reshape(D, *wire[name].shape)
            off += w
    return recv


def _cadence_on(step: int, every: int) -> bool:
    """Sync fires on the LAST step of each period (steps ``every-1,
    2*every-1, ...``), so a period accumulates ``every`` gradients before
    the exchange that flushes them."""
    return step % every == every - 1


def _cadence_select(g, state, cfg: SyncConfig, step: int, shard, new_state):
    """Tier-0 cadence gate around an already-computed sync: on-cadence
    steps keep the result; off-cadence steps return a zero shard and fold
    this step's gradient into the error state (``e <- e + g``)."""
    loco_lib.validate_cadence(cfg)
    if _cadence_on(step, cfg.every):
        return shard, new_state
    codec = codec_lib.get_codec(cfg)
    acc = codec.state_encode(g.float() + codec.state_decode(state))
    return torch.zeros_like(shard), acc.to(new_state.dtype)


def dist_sync(
    g: torch.Tensor,
    state: torch.Tensor,
    cfg: SyncConfig,
    group,
    gen: torch.Generator | None = None,
    step: int | None = None,
    *,
    out_dtype: torch.dtype = torch.float32,
    inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Synchronize one flat gradient segment across the group.

    g:     (n,) local gradient segment (bf16 or f32; the codecs compute in
           f32 and the loco/ef kernels take it as it is), n divisible by
           D * 2 * block; element i belongs to peer ``i // (n/D)``'s shard.
    state: this rank's compressor state (see loco.state_dtype).
    gen:   generator for stochastic rounding (required when
           ``cfg.quant.stochastic_rounding`` is set).
    step:  step index; when given and the codec is stateful, the cadence
           gate (``cfg.every``) applies (transparent at ``every == 1``).
    out_dtype: dtype of the returned shard: the f32 mean, rounded to
           nearest-even for bf16 (by the decode kernel where there is one).
    inplace: the caller no longer needs ``state``: on an on-cadence step
           the codec may write the new state into it (off-cadence steps
           read the old state after the encode, so they never do).
    returns (g_shard (n/D,) in ``out_dtype``, new_state): the *averaged*
    gradient piece this rank owns, and the updated local compressor state
    (``state`` itself when written in place).
    """
    n = g.shape[0]
    D = axis_size(group)
    if cfg.hierarchical or cfg.tiers:
        raise NotImplementedError(
            "hierarchical / multi-tier sync is not ported yet (ROADMAP.md)")
    if cfg.strategy == "fp":
        # 16-bit-style baseline: reduce-scatter mean (bf16 wire)
        with PROF.phase("exchange"):
            g_shard = psum_scatter_flat(g.to(torch.bfloat16), group)
        return (g_shard.float() / D).to(out_dtype), state
    if cfg.strategy == "ef21":
        raise NotImplementedError(
            "ef21 has no distributed form (receiver-side state); use "
            "strategy='ef' or 'loco'")

    codec = codec_lib.get_codec(cfg)
    gated = step is not None and cfg.needs_state()
    if gated and cfg.every != 1:
        # an off-cadence step folds g into the OLD state after the encode,
        # so only an on-cadence step may overwrite it
        inplace = inplace and cfg.every > 1 and _cadence_on(step, cfg.every)
    with PROF.phase("encode"):            # compensate + quantize (Alg. 1)
        wire, new_state = codec.encode(g, state, gen, inplace=inplace)
    with PROF.phase("exchange"):          # low-bit all-to-all (section 3.3)
        recv = exchange_wire(wire, codec.wire_shapes(n), D, group)
    with PROF.phase("decode"):            # dequant + f32 mean
        shard = codec.decode_mean(recv, out_dtype)
    if gated:
        shard, new_state = _cadence_select(g, state, cfg, step, shard,
                                           new_state)
    return shard, new_state
