"""Wire coalescer: one packed collective per comm group, not per bucket-leaf.

Port of ``repro.core.wirepack``.  The bucketed scheduler
(:mod:`repro_torch.core.buckets`) buys per-bucket wire policies at the price
of launches: each bucket would issue its own collective per wire leaf.
This module groups a plan's buckets, when the step is built, by exchange
kind and lays every (encode run, wire leaf) of a group out at a fixed byte
offset inside one packed buffer:

* ``a2a``: each leaf's per-peer rows side by side in a ``(peers,
  row_bytes)`` ``uint8`` buffer, ONE all-to-all over the group;
* ``gather``: per-node metadata leaves in one flat ``uint8`` buffer, ONE
  all-gather;
* ``reduce``: the ``fp`` buckets' bf16 segments, ONE reduce-scatter
  (elements, not bytes: the network adds here).

Groups are keyed by stage as well: ``flat`` crosses the whole dp group;
a hierarchical bucket's stage 1 (``hier1``, its own codec) crosses the
innermost ``data`` axis and its stage 2 (``hier2``, the stateless codec on
the pod means) the ``pod`` axis, each its own process group.

The byte views are exact and collectives move bytes verbatim, so the
packed exchange is bit-identical to one collective per bucket-leaf; the
512-aligned chunk geometry of :mod:`repro_torch.core.buckets` keeps every
leaf's per-peer row a whole number of bytes (checked here).  Ragged
(capacity-padded top-k) leaves ride the ``a2a`` groups with their count
leaf and are re-zeroed past the count on receipt (:func:`mask_by_count`).

Adjacent buckets with the same fusible config also *encode* as one segment
(:class:`EncodeRun`): under a uniform policy a parameter has one run, one
encode and one decode, as on the monolithic path.

The backward-overlap schedule (:func:`build_overlap_schedule`) cuts a
plan's runs at bucket edges into at most two readiness-ordered stages,
each with its own group plan, which ``core/comm`` pipelines.  The
reference's piece-space state carry (``StateLeaf`` ... ``merge_state_pieces``
and the f8 -> f16 widening) works around XLA:CPU's f8 emitters and is not
ported: a piece's state is a column slice of its run's peer-major buffer.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Literal

import torch

from repro_torch.core import codec as codec_lib
from repro_torch.core import loco as loco_lib
from repro_torch.core.buckets import ParamPlan
from repro_torch.core.loco import SyncConfig
from repro_torch.kernels.wrap import address

Stage = Literal["flat", "hier1", "hier2"]
Kind = Literal["a2a", "gather", "reduce"]


# ---------------------------------------------------------------------------
# byte views
# ---------------------------------------------------------------------------

def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Flat ``uint8`` view of a tensor's bytes (bit-exact, no arithmetic)."""
    flat = a.contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def from_bytes(buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_bytes` along the last axis.

    ``buf``'s trailing axis is a byte count divisible by ``dtype``'s
    itemsize; leading axes (the peer axis of a received buffer) pass
    through, so ``(D, row_bytes) -> (D, row_elems)``.
    """
    if dtype == torch.uint8:
        return buf
    if buf.shape[-1] % dtype.itemsize:
        raise ValueError(f"{buf.shape[-1]} bytes is not a whole number of "
                         f"{dtype} elements")
    return buf.contiguous().view(dtype)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's names, as the
    reference's plans store them)."""
    return str(dtype).removeprefix("torch.")


_DTYPES = {dtype_name(d): d for d in (torch.int8, torch.uint8, torch.float32,
                                      torch.bfloat16, torch.float8_e4m3fn,
                                      torch.uint16, torch.uint32)}


# ---------------------------------------------------------------------------
# encode runs: adjacent same-config buckets encoded as ONE segment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncodeRun:
    """Maximal run of adjacent buckets that encode and decode as one segment.

    ``block``/``fixed`` quantization, the error codecs and the receiver mean
    are elementwise per 256-block, and bucket edges are 512-aligned, so
    ``encode(concat) == concat(encode)``.  ``tensor``/``onebit`` scales and
    stochastic rounding depend on the whole segment and never fuse;
    hierarchical and top-k buckets stay singleton runs.  ``slot`` (the first member's
    bucket index) keys the run's wire tensors in the packed buffers.
    """

    slot: int
    buckets: tuple[int, ...]      # member bucket indices, in offset order
    positions: tuple[int, ...]    # member positions in plan.buckets
    offset: int                   # chunk-space start of the run
    chunk_elems: tuple[int, ...]  # per-member per-rank lengths
    sync: SyncConfig

    @property
    def chunk_total(self) -> int:
        return sum(self.chunk_elems)

    @property
    def fused(self) -> bool:
        return len(self.buckets) > 1


def fusible(cfg: SyncConfig) -> bool:
    """Whether adjacent buckets of this exact config may encode as one
    segment.  ``fp`` buckets always fuse: their wire is an elementwise
    bf16 sum."""
    if cfg.strategy == "fp":
        return True
    return (cfg.strategy in ("loco", "ef", "naive4")
            and cfg.quant.mode in ("block", "fixed")
            and not cfg.quant.stochastic_rounding
            and not cfg.hierarchical)


def fuse_run_state(run: EncodeRun, members: list, dp: int) -> torch.Tensor:
    """Member bucket states (position order, each ``(L?, D*c_b)``) -> the
    run's one peer-major buffer ``(L?, D*c_run)``.  Stateful runs only."""
    lead = members[0].shape[:-1]
    segs = [m.reshape(*lead, dp, c) for m, c in zip(members, run.chunk_elems)]
    return torch.cat(segs, dim=-1).reshape(*lead, dp * run.chunk_total)


def split_run_state(run: EncodeRun, rs: torch.Tensor, dp: int) -> list:
    """Exact inverse of :func:`fuse_run_state`."""
    lead = rs.shape[:-1]
    rsm = rs.reshape(*lead, dp, run.chunk_total)
    out, off = [], 0
    for c in run.chunk_elems:
        out.append(rsm[..., off:off + c].reshape(*lead, dp * c))
        off += c
    return out


@lru_cache(maxsize=None)
def encode_runs(plan: ParamPlan) -> tuple[EncodeRun, ...]:
    """Partition a plan's buckets into maximal fusible runs, offset order."""
    runs: list[EncodeRun] = []
    cur: list = []

    def flush():
        if cur:
            runs.append(EncodeRun(
                slot=cur[0][1].index,
                buckets=tuple(b.index for _, b in cur),
                positions=tuple(p for p, _ in cur),
                offset=cur[0][1].offset,
                chunk_elems=tuple(b.chunk_elems for _, b in cur),
                sync=cur[0][1].sync))
        cur.clear()

    for pos, b in enumerate(plan.buckets):
        if cur and not (fusible(b.sync) and b.sync == cur[-1][1].sync
                        and b.offset == cur[-1][1].chunk_end):
            flush()
        cur.append((pos, b))
        if not fusible(b.sync):
            flush()
    flush()
    return tuple(runs)


# ---------------------------------------------------------------------------
# static group plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedLeaf:
    """One (encode run, wire leaf) slot inside a packed group buffer.

    For ``a2a`` groups ``offset``/``nbytes`` are per-peer row bytes; for
    ``gather`` groups they index the flat local send buffer; for ``reduce``
    groups they are bf16 bytes of the per-peer row.
    """

    bucket: int          # run slot (== bucket index for singleton runs)
    name: str            # wire-leaf name ("payload", "scales", ...) / "seg"
    offset: int
    nbytes: int
    elems: int           # leaf elements per peer row (a2a/reduce) or total (gather)
    dtype: str           # dtype name (a string keeps the dataclass hashable)
    # ragged leaf: name of the same run's u32 count leaf in this group; the
    # leaf is capacity-padded (offset/nbytes are the static budget) and
    # unpack re-zeroes the slots at or past the count
    count_of: str | None = None


@dataclasses.dataclass(frozen=True)
class WireGroup:
    """All the wire tensors that ride one packed collective."""

    stage: Stage
    kind: Kind
    peers: int           # exchange group size (D flat, Dd hier1, pods hier2)
    row_bytes: int       # per-peer bytes (a2a/reduce: row; gather: local buffer)
    leaves: tuple[PackedLeaf, ...]


@dataclasses.dataclass(frozen=True)
class WireGroupPlan:
    """Static packing layout of one ParamPlan's coalesced exchange."""

    groups: tuple[WireGroup, ...]

    def group(self, stage: str, kind: Kind) -> "WireGroup | None":
        for g in self.groups:
            if g.stage == stage and g.kind == kind:
                return g
        return None

    def launches(self) -> int:
        """Collectives issued per sync: one per group.  Every group crosses
        one process group (the flat dp group, or one mesh axis's group for
        the hierarchical stages), where the reference's flat groups launch
        once per mesh axis they span."""
        return len(self.groups)


def _leaf_entries(cfg, n: int) -> list[tuple[str, "codec_lib.WireLeaf"]]:
    """(name, WireLeaf) pairs of a codec's wire, in stable dict order."""
    return list(codec_lib.get_codec(cfg).wire_shapes(n).items())


def _plan_groups(qualname: str, segs, D: int, pods: int) -> WireGroupPlan:
    """Group-layout walk over offset-ordered encode runs or stage pieces
    (both give the same group geometry for the same segments, which keeps
    the overlapped exchange bit-exact).  ``pods`` is the inter-pod axis
    size: a hierarchical run's stage 1 crosses ``D / pods`` peers, its
    stage 2 ``pods``."""
    dd = D // max(pods, 1)
    builders: dict[tuple, list[PackedLeaf]] = {}
    offs: dict[tuple, int] = {}

    def add(stage: Stage, kind: Kind, peers: int, bucket: int, name: str,
            nbytes: int, elems: int, dtype, count_of=None) -> None:
        sig = (stage, kind, peers)
        off = offs.get(sig, 0)
        builders.setdefault(sig, []).append(PackedLeaf(
            bucket=bucket, name=name, offset=off, nbytes=nbytes,
            elems=elems, dtype=dtype_name(dtype), count_of=count_of))
        offs[sig] = off + nbytes

    def check_ragged(leaf, entries, where: str) -> None:
        """The ragged-leaf contract: split only, its count leaf in the same
        wire."""
        if not leaf.ragged:
            return
        if leaf.comm != "split":
            raise ValueError(
                f"{where}: ragged leaves must be comm='split' "
                f"(got {leaf.comm!r}); the capacity-padded row layout only "
                "exists on the all-to-all")
        cnt = dict(entries).get(leaf.count_of)
        if cnt is None or cnt.comm != "split":
            raise ValueError(
                f"{where}: count leaf {leaf.count_of!r} missing from the "
                "wire dict (or not comm='split'); a ragged leaf's count "
                "must ride the same all-to-all")

    for run in segs:
        cfg = run.sync
        seg = D * run.chunk_total
        if cfg.strategy == "fp":
            # summed on the wire: bf16 elements, one reduce-scatter for
            # every fp run of the plan
            add("flat", "reduce", D, run.slot, "seg",
                nbytes=2 * run.chunk_total, elems=run.chunk_total,
                dtype=torch.bfloat16)
            continue
        hier = cfg.hierarchical
        if hier and len(loco_lib.sync_schedule(cfg)) > 1:
            raise ValueError(
                f"{qualname}[{run.slot}]: the coalesced exchange supports "
                f"at most one outer tier; "
                f"{len(loco_lib.sync_schedule(cfg))} are configured — run "
                "deeper schedules on the monolithic path (--no-coalesce)")
        stage1: Stage = "hier1" if hier else "flat"
        peers1 = dd if hier else D
        entries1 = _leaf_entries(cfg, seg)
        for name, leaf in entries1:
            if hier and leaf.ragged:
                raise ValueError(
                    f"{qualname}[{run.slot}].{name}: ragged (capacity-"
                    "padded) leaves cannot ride the coalesced hierarchical "
                    "stage-1 leg — the chunk regroup would interleave "
                    "capacity padding; run topk-over-hier buckets on the "
                    "monolithic path (--no-coalesce)")
            check_ragged(leaf, entries1, f"{qualname}[{run.slot}].{name}")
            if leaf.comm == "split":
                row, rem = divmod(leaf.nbytes, peers1)
                erow, erem = divmod(math.prod(leaf.shape), peers1)
                if rem or erem:
                    raise ValueError(
                        f"{qualname}[{run.slot}].{name}: leaf of "
                        f"{leaf.nbytes} bytes does not split over "
                        f"{peers1} peers; bucket edges must stay "
                        "512-aligned (see buckets.ALIGN)")
                add(stage1, "a2a", peers1, run.slot, name, nbytes=row,
                    elems=erow, dtype=leaf.dtype, count_of=leaf.count_of)
            elif leaf.comm == "gather":
                add(stage1, "gather", peers1, run.slot, name,
                    nbytes=leaf.nbytes, elems=math.prod(leaf.shape),
                    dtype=leaf.dtype)
            # comm == "none": static metadata, never exchanged
        if hier:
            cfg2 = loco_lib.validate_stage2(cfg)
            for name, leaf in _leaf_entries(cfg2, seg // dd):
                if leaf.ragged:
                    raise ValueError(
                        f"{qualname}[{run.slot}].stage2 (tier 1).{name}: "
                        "ragged (capacity-padded) leaves cannot ride the "
                        "coalesced stage-2 leg; run topk outer tiers on "
                        "the monolithic path (--no-coalesce)")
                if leaf.comm == "split":
                    row, rem = divmod(leaf.nbytes, pods)
                    if rem:
                        raise ValueError(
                            f"{qualname}[{run.slot}].stage2.{name}: "
                            f"{leaf.nbytes} bytes do not split over "
                            f"{pods} pods")
                    add("hier2", "a2a", pods, run.slot, name, nbytes=row,
                        elems=math.prod(leaf.shape) // pods,
                        dtype=leaf.dtype)
                elif leaf.comm == "gather":
                    add("hier2", "gather", pods, run.slot, name,
                        nbytes=leaf.nbytes, elems=math.prod(leaf.shape),
                        dtype=leaf.dtype)

    groups = tuple(
        WireGroup(stage=sig[0], kind=sig[1], peers=sig[2],
                  row_bytes=offs[sig], leaves=tuple(leaves))
        for sig, leaves in builders.items())
    return WireGroupPlan(groups=groups)


@lru_cache(maxsize=None)
def build_group_plan(plan: ParamPlan, D: int, pods: int = 1) -> WireGroupPlan:
    """Group one parameter's encode runs by exchange signature (stage,
    kind, peers).

    ``D`` is the dp-group size, ``pods`` the inter-pod axis size (1 = one
    pod).  Raises if a leaf's bytes do not divide evenly over its peer
    group (the 512-aligned bucket geometry guarantees they do for every
    codec), or for what the coalesced exchange cannot carry (more than one
    outer tier; ragged leaves on a hierarchical leg).
    """
    return _plan_groups(plan.qualname, encode_runs(plan), D, pods)


# ---------------------------------------------------------------------------
# overlap schedule: the backward-readiness table + per-stage group plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagePiece:
    """One overlap stage's slice of an encode run.

    Non-fusible runs (``tensor``/``onebit`` scales, stochastic rounding,
    hierarchical and top-k buckets) are *atomic*: their whole-segment statistics make a split lossy, so a
    piece always covers the full run.  Fusible runs may split at bucket
    edges: ``block``/``fixed`` quantization, the error codecs and the
    receiver mean are elementwise per 256-block and bucket edges are
    512-aligned, so each piece encodes and decodes bit-identically to its
    slice of the fused run.

    Duck-types :class:`EncodeRun` (``slot``/``positions``/``chunk_elems``/
    ``sync``/``chunk_total``/``fused``), so the pack layout and the
    bucket-space state stitch apply unchanged.  ``col_off``/``run_total``
    locate the piece inside its run's peer-major ``(D, run_total)`` state
    buffer: the piece's state is columns ``[col_off, col_off + chunk)``.
    """

    run_index: int                # index into encode_runs(plan)
    slot: int                     # first member bucket index (wire key)
    buckets: tuple[int, ...]
    positions: tuple[int, ...]
    offset: int                   # chunk-space start
    chunk_elems: tuple[int, ...]
    col_off: int                  # chunk offset inside the parent run
    run_total: int                # parent run chunk_total
    sync: SyncConfig

    @property
    def chunk_total(self) -> int:
        return sum(self.chunk_elems)

    @property
    def fused(self) -> bool:
        return len(self.buckets) > 1

    @property
    def whole(self) -> bool:
        """The piece covers its entire parent run."""
        return self.col_off == 0 and self.chunk_total == self.run_total


@dataclasses.dataclass(frozen=True)
class ScheduleStage:
    """One pipeline stage: the pieces whose collectives fire together.

    ``ready`` is the chunk-space end offset of its last piece: once the
    gradient covers ``[0, ready)`` every input of the stage's packed
    buffers exists.
    """

    index: int
    ready: int
    pieces: tuple[StagePiece, ...]
    gplan: WireGroupPlan


@dataclasses.dataclass(frozen=True)
class OverlapSchedule:
    """Readiness-ordered stage partition of one parameter's sync.

    Stages partition chunk space contiguously in offset order, each with
    its own :class:`WireGroupPlan`, so the overlapped schedule issues the
    sum of the stages' launches where the flat schedule issues one set.
    The bytes on the wire are the flat schedule's, cut per stage.
    """

    stages: tuple[ScheduleStage, ...]
    chunklen: int

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def pipelined(self) -> bool:
        return len(self.stages) > 1

    @property
    def readiness(self) -> tuple[int, ...]:
        """Per-stage chunk-space completion offsets."""
        return tuple(st.ready for st in self.stages)

    def launches(self) -> int:
        return sum(st.gplan.launches() for st in self.stages)

    @property
    def comm_groups(self) -> int:
        return sum(len(st.gplan.groups) for st in self.stages)


@lru_cache(maxsize=None)
def build_overlap_schedule(plan: ParamPlan, D: int, pods: int = 1,
                           max_stages: int = 2) -> OverlapSchedule:
    """Partition a plan's encode runs into pipeline stages.

    Atomic units are buckets (fusible runs) or whole runs (non-fusible);
    they are dealt greedily onto ``max_stages`` stages cut at the ideal
    chunk-space boundaries ``i * chunklen / S``.  A plan whose units cannot
    fill two stages degenerates to one stage, which the sync runs as the
    flat schedule (the same computation).
    """
    runs = encode_runs(plan)
    units: list[tuple[int, tuple, tuple, int, tuple]] = []
    for ri, run in enumerate(runs):
        if fusible(run.sync):
            off = run.offset
            for b, p, c in zip(run.buckets, run.positions, run.chunk_elems):
                units.append((ri, (b,), (p,), off, (c,)))
                off += c
        else:
            units.append((ri, run.buckets, run.positions, run.offset,
                          run.chunk_elems))

    S = max(1, min(max_stages, len(units)))
    per_stage: list[list] = [[] for _ in range(S)]
    s = 0
    for u in units:
        per_stage[s].append(u)
        end = u[3] + sum(u[4])
        while s < S - 1 and end * S >= (s + 1) * plan.chunklen:
            s += 1

    stages: list[ScheduleStage] = []
    for stage_units in per_stage:
        if not stage_units:
            continue
        pieces: list[StagePiece] = []
        for ri, bks, poss, off, ces in stage_units:
            if pieces and pieces[-1].run_index == ri:
                prev = pieces[-1]
                pieces[-1] = dataclasses.replace(
                    prev, buckets=prev.buckets + bks,
                    positions=prev.positions + poss,
                    chunk_elems=prev.chunk_elems + ces)
            else:
                pieces.append(StagePiece(
                    run_index=ri, slot=bks[0], buckets=bks, positions=poss,
                    offset=off, chunk_elems=ces,
                    col_off=off - runs[ri].offset,
                    run_total=runs[ri].chunk_total, sync=runs[ri].sync))
        gplan = _plan_groups(plan.qualname, pieces, D, pods)
        last = pieces[-1]
        stages.append(ScheduleStage(
            index=len(stages), ready=last.offset + last.chunk_total,
            pieces=tuple(pieces), gplan=gplan))
    return OverlapSchedule(stages=tuple(stages), chunklen=plan.chunklen)


# ---------------------------------------------------------------------------
# pack / unpack (local; core/comm issues the collectives)
# ---------------------------------------------------------------------------

def pack_a2a(group: WireGroup,
             wires: dict[int, dict[str, torch.Tensor]]) -> torch.Tensor:
    """Pack an a2a group's wire tensors into one ``(peers, row_bytes)`` u8
    buffer; row *i* concatenates every member leaf's piece for peer *i*."""
    rows = [to_bytes(wires[l.bucket][l.name]).reshape(group.peers, l.nbytes)
            for l in group.leaves]
    return torch.cat(rows, dim=1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (what the kernels take).  Leaves are packed back to back, so
    a leaf after 8*k bytes of scales can start at 8 mod 16."""
    if address(t) % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


# the signed dtype of each unsigned wide dtype's bits: torch computes
# little on uint16/uint32 (on CUDA least of all), so the mask selects on
# a view with the same bits
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def mask_by_count(arr: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Zero a ragged leaf's dead slots: ``arr`` is ``(..., units * slots)``,
    ``cnt`` the matching ``(..., units)`` u32 live counts; slot ``j`` of a
    unit survives iff ``j < cnt``.  The receiving half of the ragged wire
    contract, shared by the packed (:func:`unpack_a2a`) and the per-leaf
    (``comm.exchange_wire``) exchanges: the bytes past a count are dead
    padding and may hold anything, so masking makes the decode independent
    of them."""
    units = cnt.shape[-1]
    slots, rem = divmod(arr.shape[-1], units)
    if rem:
        raise ValueError(f"ragged leaf of shape {tuple(arr.shape)} does not "
                         f"split into {units} slot groups")
    view = _SIGNED_VIEW.get(arr.dtype)
    a = (arr.view(view) if view is not None else arr).reshape(
        *arr.shape[:-1], units, slots)
    live = (torch.arange(slots, device=arr.device)
            < cnt.view(torch.int32).to(torch.int64)[..., None])
    out = torch.where(live, a, torch.zeros((), dtype=a.dtype,
                                           device=a.device))
    out = out.reshape(arr.shape)
    return out.view(arr.dtype) if view is not None else out


def unpack_a2a(group: WireGroup,
               recv: torch.Tensor) -> dict[int, dict[str, torch.Tensor]]:
    """Received ``(peers, row_bytes)`` buffer -> per-run recv leaves, each
    ``(peers, row_elems)``, bit-identical to the per-leaf exchange.  Ragged
    leaves are re-zeroed past their count (two passes: dense leaves first,
    so every ragged leaf's count rows are decoded already)."""
    out: dict[int, dict[str, torch.Tensor]] = {}
    ragged: list[PackedLeaf] = []
    for l in group.leaves:
        if l.count_of is not None:
            ragged.append(l)
            continue
        piece = recv[:, l.offset:l.offset + l.nbytes]
        out.setdefault(l.bucket, {})[l.name] = _aligned(
            from_bytes(piece, _DTYPES[l.dtype]))
    for l in ragged:
        piece = from_bytes(recv[:, l.offset:l.offset + l.nbytes],
                           _DTYPES[l.dtype])
        out.setdefault(l.bucket, {})[l.name] = mask_by_count(
            piece, out[l.bucket][l.count_of])
    return out


def pack_gather(group: WireGroup,
                wires: dict[int, dict[str, torch.Tensor]]) -> torch.Tensor:
    """Pack a gather group's per-node metadata into one flat u8 buffer."""
    return torch.cat([to_bytes(wires[l.bucket][l.name])
                      for l in group.leaves])


def unpack_gather(group: WireGroup, recv: torch.Tensor,
                  shapes: dict[int, dict[str, tuple]]
                  ) -> dict[int, dict[str, torch.Tensor]]:
    """``(peers, row_bytes)`` gathered buffer -> per-run ``(peers, *shape)``
    recv leaves (``shapes[slot][name]`` is the leaf's local shape)."""
    out: dict[int, dict[str, torch.Tensor]] = {}
    for l in group.leaves:
        arr = from_bytes(recv[:, l.offset:l.offset + l.nbytes],
                         _DTYPES[l.dtype])
        out.setdefault(l.bucket, {})[l.name] = arr.reshape(
            (group.peers, *shapes[l.bucket][l.name]))
    return out


def pack_reduce(group: WireGroup,
                segs: dict[int, torch.Tensor]) -> torch.Tensor:
    """Pack fp runs' ``(D * c,)`` bf16 segments into one ``(D * sum_c,)``
    buffer whose per-peer tiles concatenate the runs' per-peer rows, so one
    reduce-scatter returns the concatenation of the per-run shards."""
    if len(group.leaves) == 1:
        return segs[group.leaves[0].bucket].reshape(-1)
    rows = [segs[l.bucket].reshape(group.peers, l.elems)
            for l in group.leaves]
    return torch.cat(rows, dim=1).reshape(-1)


def unpack_reduce(group: WireGroup,
                  shard: torch.Tensor) -> dict[int, torch.Tensor]:
    """``(sum_c,)`` reduce-scattered shard -> per-run ``(c,)`` shards."""
    out = {}
    for l in group.leaves:
        off = l.offset // 2  # offsets are bf16 bytes; the shard is elements
        out[l.bucket] = shard[off:off + l.elems]
    return out
