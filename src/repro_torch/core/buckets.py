"""Bucketed gradient-sync scheduling (the layer between compressor and wire).

Port of ``repro.core.buckets``.  The monolithic path compresses each
parameter's whole flat gradient under one global
:class:`~repro_torch.core.loco.SyncConfig`.  This module partitions every
flat-param chunk into size-targeted buckets and resolves each bucket to its
own SyncConfig through :mod:`repro_torch.core.policy`, so embeddings can
sync at 8 bits, the transformer body at 4-bit LoCo and small buckets in
full precision.

Geometry: a parameter's padded flat tensor is split FSDP-style into ``D``
contiguous per-rank chunks of ``C = padlen / D`` elements.  Buckets live in
chunk space: bucket *b* covers chunk columns ``[offset, offset +
chunk_elems)`` on every rank.  Viewing the local full gradient as ``(D,
C)`` and slicing columns yields a ``(D * chunk_elems,)`` segment already in
``dist_sync``'s wire layout (row *i* = peer *i*'s piece), and the returned
shard is this rank's contiguous slice of its chunk, so the concatenation
over buckets is the monolithic shard.  With ``ALIGN = 512`` (int4 pack
factor x quantizer block) every bucket edge falls on a block boundary, so
under a uniform policy scales, codes and error states match the monolithic
path bit for bit.

Everything here is static Python (frozen dataclasses, plain ints): plans
are built once per step build, are hashable and hold no tensors.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.loco import SyncConfig
from repro_torch.core.policy import SyncPolicy, classify

# Bucket edges stay multiples of the int4 pack factor (2) times the
# quantizer block (256); equals flatparam.GRAIN so chunk ends always align.
ALIGN = 512

DEFAULT_TARGET_BYTES = 4 << 20  # 4 MiB of fp32 gradient per bucket


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """Static knobs of the bucketing scheduler.

    ``target_bytes`` is the fp32 byte size of the *global* gradient segment
    (``D * chunk_elems * 4``) each full bucket covers; the last bucket of a
    parameter takes the remainder.  Values below ``ALIGN`` elements per
    chunk are rounded up.
    """

    target_bytes: int = DEFAULT_TARGET_BYTES
    align: int = ALIGN


def partition(chunklen: int, dp: int, cfg: BucketConfig) -> tuple[int, ...]:
    """Split a per-rank chunk of ``chunklen`` elements into bucket lengths,
    each a multiple of ``cfg.align``, summing to ``chunklen`` (which must
    itself be a multiple of ``cfg.align``; flatparam pads to GRAIN)."""
    if chunklen % cfg.align:
        raise ValueError(f"chunk of {chunklen} elements is not a multiple "
                         f"of the bucket alignment {cfg.align}")
    target_c = (cfg.target_bytes // 4 // max(dp, 1)) // cfg.align * cfg.align
    target_c = max(cfg.align, target_c)
    if chunklen <= target_c:
        return (chunklen,)
    sizes = [target_c] * (chunklen // target_c)
    rem = chunklen - sum(sizes)
    if rem:
        sizes.append(rem)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One schedulable sync unit of a parameter's gradient."""

    index: int
    offset: int       # chunk-space start (elements)
    chunk_elems: int  # per-rank length c_b
    seg_elems: int    # global segment length D * c_b (= local grad slice)
    sync: SyncConfig  # policy-resolved wire config for this bucket

    @property
    def chunk_end(self) -> int:
        """Chunk-space end offset of this bucket."""
        return self.offset + self.chunk_elems


@dataclasses.dataclass(frozen=True)
class ParamPlan:
    """Bucket layout + resolved configs for one (loco) parameter."""

    group: str
    name: str
    tensor_class: str
    chunklen: int
    layers: int                 # stacked-group multiplier (1 if not stacked)
    buckets: tuple[Bucket, ...]

    @property
    def qualname(self) -> str:
        return f"{self.group}/{self.name}"

    def needs_state(self) -> bool:
        return any(b.sync.needs_state() for b in self.buckets)


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """Full model schedule: one ParamPlan per loco parameter."""

    params: tuple[ParamPlan, ...]

    def lookup(self, group: str, name: str) -> ParamPlan:
        for p in self.params:
            if p.group == group and p.name == name:
                return p
        raise KeyError(f"{group}/{name} not in sync plan")

    def needs_state(self) -> bool:
        return any(p.needs_state() for p in self.params)

    @property
    def n_buckets(self) -> int:
        return sum(len(p.buckets) for p in self.params)


def make_param_plan(group_name: str, info, topo, bucket_cfg: BucketConfig,
                    policy: SyncPolicy, layers: int = 1) -> ParamPlan:
    """Bucket one ParamInfo's chunk and resolve each bucket's config."""
    chunklen = info.chunklen(topo.tp, topo.dp)
    tclass = classify(info)
    qual = f"{group_name}/{info.name}"
    buckets = []
    off = 0
    for i, c in enumerate(partition(chunklen, topo.dp, bucket_cfg)):
        seg = topo.dp * c
        buckets.append(Bucket(index=i, offset=off, chunk_elems=c,
                              seg_elems=seg,
                              sync=policy.resolve(qual, tclass, seg)))
        off += c
    return ParamPlan(group=group_name, name=info.name, tensor_class=tclass,
                     chunklen=chunklen, layers=layers, buckets=tuple(buckets))


def loco_params(groups):
    """Yield ``(group_name, info, layers)`` for every sync-planned param
    (the ``loco`` ones; the others keep the fp gather)."""
    for g in groups:
        layers = g.n_layers if g.stacked else 1
        for info in g.infos:
            if info.loco:
                yield g.name, info, layers


def make_sync_plan(groups, topo, bucket_cfg: BucketConfig,
                   policy: SyncPolicy) -> SyncPlan:
    """Build the whole-model schedule."""
    return SyncPlan(params=tuple(
        make_param_plan(gname, info, topo, bucket_cfg, policy, layers=layers)
        for gname, info, layers in loco_params(groups)))


def monolithic_param_plan(group_name: str, info, topo, cfg: SyncConfig,
                          layers: int = 1) -> ParamPlan:
    """The monolithic sync expressed as a single-bucket plan: one bucket
    spanning the whole chunk (``seg_elems = D * chunklen = padlen``)."""
    chunklen = info.chunklen(topo.tp, topo.dp)
    return ParamPlan(
        group=group_name, name=info.name, tensor_class=classify(info),
        chunklen=chunklen, layers=layers,
        buckets=(Bucket(index=0, offset=0, chunk_elems=chunklen,
                        seg_elems=topo.dp * chunklen, sync=cfg),))


def monolithic_sync_plan(groups, topo, cfg: SyncConfig) -> SyncPlan:
    """Whole-model single-bucket-per-param plan."""
    return SyncPlan(params=tuple(
        monolithic_param_plan(gname, info, topo, cfg, layers=layers)
        for gname, info, layers in loco_params(groups)))
