"""Collective helpers and the distributed gradient sync.

Port of ``repro.core.comm``.  Where the reference ran inside ``shard_map``
over mesh axes, the port runs on each rank of one ``torch.distributed``
process group spanning the data-parallel ranks (rank order
``(wan * PODS + pod) * DATA + data``, see :mod:`repro_torch.launch.mesh`),
so sequential ``all_gather``/``reduce_scatter``/``all_to_all`` stay
mutually inverse in chunk order.  The hierarchical exchange also needs
each mesh axis on its own: a :class:`MeshAxis` is one axis's name and this
rank's process group over it, and a tuple of them, outermost first, takes
the place of the reference's ``dp_axes``.

``dist_sync`` is the distributed form of the strategies in
:mod:`repro_torch.core.loco`: quantize locally, exchange the low-bit payload
with one packed u8 all-to-all over the group, decompress and average
**locally in f32** (paper section 3.3).  ``dist_sync_buckets`` and
``dist_sync_runs`` do so per bucketed plan, coalesced into one packed
collective per comm group, flat or pipelined over the plan's overlap
stages with asynchronous collectives.

Buckets whose config sets ``hierarchical`` route through
:func:`hierarchical_sync` (or its coalesced in-plan legs): the bucket's
codec inside the pod (the ``data`` axis), then a stateless codec on the pod
means across pods (the ``pod`` axis), and one more leg per outer tier of a
``tiers`` schedule (the ``wan`` axis).

With ``probe`` (the gradient-fidelity probe, ``telemetry/fidelity``) every
sync form also returns a ``(K, n/D)`` f32 reference stack of this rank's
chunk: the exact mean gradient, the mean of the live compensated
roundtrip and of the roundtrip from a zero state, all three in ONE extra
reduce-scatter over the dp group (:func:`_probe_reduce`), and one mid-tier
reference per non-final tier of a multi-tier schedule.  The shard and the
new state are the non-probe call's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core import codec as codec_lib
from repro_torch.core import loco as loco_lib
from repro_torch.core import wirepack as WP
from repro_torch.core.buckets import ParamPlan
from repro_torch.core.loco import SyncConfig
from repro_torch.kernels import loco_quant as LQ
from repro_torch.kernels.wrap import same_start
from repro_torch.telemetry import profiler as PROF

# torch renamed the tensor-in/tensor-out collectives; take whichever exists
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

# the dry run's recorder (analysis.op_stats.OpStats) while it records, else
# None: told of each asynchronous collective's issue, and it waits for each
OBSERVER = None


def axis_size(group) -> int:
    return dist.get_world_size(group)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One data-parallel mesh axis as this rank sees it: the axis name
    (``wan``, ``pod`` or ``data``) and the process group over the ranks
    that differ from this one on that axis only, in axis order."""

    name: str
    group: object

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def index(self) -> int:
        """This rank's coordinate on the axis."""
        return dist.get_rank(self.group)


def _names(axes) -> tuple[str, ...]:
    return tuple(a.name for a in axes)


def all_gather_flat(x: torch.Tensor, group, async_op: bool = False):
    """Gather chunks from every rank, in rank order, along dim 0.  With
    ``async_op``: ``(out, work)``, ``out`` valid after ``work.wait()``."""
    D = axis_size(group)
    x = x.contiguous()
    out = torch.empty((D * x.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    work = _ALL_GATHER(out, x, group=group, async_op=async_op)
    return (out, work) if async_op else out


def psum_scatter_flat(x: torch.Tensor, group, async_op: bool = False):
    """Inverse of :func:`all_gather_flat` composed with a sum over peers
    (``async_op`` as there)."""
    D = axis_size(group)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // D,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    work = _REDUCE_SCATTER(out, x, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)
    return (out, work) if async_op else out


def all_to_all_chunks(x: torch.Tensor, group, async_op: bool = False):
    """Full personalized exchange over the group.

    x: (N, c, ...) with N the group size; row i is the payload for peer i.
    Returns (N, c, ...): row j is what peer j sent for *my* chunk
    (``async_op`` as in :func:`all_gather_flat`).
    """
    if x.shape[0] != axis_size(group):
        raise ValueError(f"{x.shape[0]} rows for a group of "
                         f"{axis_size(group)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x, group=group, async_op=async_op)
    return (out, work) if async_op else out


def divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` rounded as one IEEE division on every device, as the
    reference computes it.  On CUDA torch divides by a Python scalar as
    ``x * (1/n)``, which rounds otherwise unless ``n`` is a power of two;
    any other ``n`` divides by a device tensor (filled on the device: no
    host-to-device copy, so no stream sync)."""
    if LQ.exact_inverse(n):
        return x / n
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


_SUM_SLICE = 1 << 24


def sum_f64(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """``sum(x * y)`` (``sum(x)`` without ``y``) as a 0-dim f64 tensor,
    for the caller to round to f32 once.  The products of f32 values are
    exact in f64 and the sum keeps 29 bits more than f32, so the rounded
    result is the same on the CPU and on the card, whose f32 reductions
    add in other orders.  Taken in slices of 2^24 elements, so the f64
    copy stays small; ``y is x`` converts each slice once."""
    xs = x.reshape(-1)
    ys = None if y is None or y is x else y.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, xs.numel(), _SUM_SLICE):
        a = xs[i:i + _SUM_SLICE].double()
        if y is None:
            total = total + torch.sum(a)
        else:
            b = a if ys is None else ys[i:i + _SUM_SLICE].double()
            total = total + torch.dot(a, b)
    return total


def fp_mean(summed: torch.Tensor, D: int) -> torch.Tensor:
    """The f32 mean ``summed / D`` of a reduce-scatter sum over ``D``
    peers, one IEEE division (:func:`divide`)."""
    return divide(summed.float(), D)


# ---------------------------------------------------------------------------
# distributed gradient synchronization (one segment)
# ---------------------------------------------------------------------------

def _mask_ragged(recv: dict[str, torch.Tensor],
                 shapes: dict[str, codec_lib.WireLeaf]
                 ) -> dict[str, torch.Tensor]:
    """Re-zero received ragged leaves past their in-band counts.  Slots
    past a block's count carry no information and the wire is not trusted:
    masking on receipt makes ``decode_mean`` independent of whatever bytes
    crossed in the dead slots."""
    for name, leaf in shapes.items():
        if leaf.ragged:
            recv[name] = WP.mask_by_count(recv[name], recv[leaf.count_of])
    return recv


def exchange_wire(
    wire: dict[str, torch.Tensor],
    shapes: dict[str, codec_lib.WireLeaf],
    D: int,
    group,
) -> dict[str, torch.Tensor]:
    """Move every wire leaf across the group per its ``comm`` kind.

    Returns the received dict: each leaf with a leading peer axis ``D``
    (``split`` -> all-to-all rows, ``gather`` -> per-peer metadata,
    ``none`` -> the local copy broadcast); ragged leaves come back zeroed
    past their counts.  All ``split`` leaves ride ONE packed u8 all-to-all
    and all ``gather`` leaves ONE packed all-gather: collectives move bytes
    verbatim and the dtype views are exact, so the received tensors are
    bit-identical to one collective per leaf.
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
    return _mask_ragged(recv, shapes)


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


def _probe_reduce(rows: torch.Tensor, group) -> torch.Tensor:
    """Fidelity-probe reference reduce: ``(K, n)`` local rows -> ``(K,
    n/D)`` exact means over the dp group.  The K rows interleave per
    destination chunk (``(K, D, C) -> (D, K*C)``), so ONE reduce-scatter
    delivers each rank the K rows of its own chunk; the mean is one IEEE
    division by D (:func:`divide`)."""
    K, n = rows.shape
    D = axis_size(group)
    x = rows.reshape(K, D, n // D).transpose(0, 1).reshape(-1)
    red = psum_scatter_flat(x, group)
    return divide(red.reshape(K, n // D), D)


def _probe_rt(codec: codec_lib.Codec, seg: torch.Tensor,
              wire: dict[str, torch.Tensor]
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's (live roundtrip, roundtrip without compensation) of one
    segment, both f32 ``(n,)``.  ``wire`` is the already encoded live wire
    (before any hierarchical regroup), decoded with a peer axis of 1: no
    second encode.  The counterfactual encodes ``seg`` from a zero state,
    the paper's Fig. 1 arm without compensation."""
    rt_live = codec.decode_mean({k: v[None] for k, v in wire.items()})
    rt_nc, _ = codec.roundtrip(seg, codec.init_state(seg.shape[0],
                                                     seg.device))
    return rt_live, rt_nc


def _fit_rows(refs: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad a reference stack to ``rows`` rows (one leaf shape across
    buckets with different stage counts)."""
    if refs.shape[0] > rows:
        raise ValueError(f"{refs.shape[0]} reference rows, room for {rows}")
    if refs.shape[0] == rows:
        return refs
    pad = refs.new_zeros((rows - refs.shape[0], refs.shape[1]))
    return torch.cat([refs, pad])


def _probe_refs(codec, g, wire, group) -> torch.Tensor:
    """The base reference stack ``(3, n/D)`` of one encoded segment."""
    with PROF.phase("probe"):
        rt_live, rt_nc = _probe_rt(codec, g, wire)
        return _probe_reduce(torch.stack([g.float(), rt_live, rt_nc]), group)


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
    axes: tuple[MeshAxis, ...] | None = None,
    probe: bool = False,
):
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
    axes:  the dp mesh axes, outermost first (:class:`MeshAxis`; None: one
           ``data`` axis over ``group``), which a ``hierarchical`` config
           exchanges over one at a time (:func:`hierarchical_sync`).
    probe: also return the fidelity reference stack ``(K, n/D)`` f32 of
           this rank's chunk (module docstring); fp returns zero rows.
    returns (g_shard (n/D,) in ``out_dtype``, new_state[, refs]): the
    *averaged* gradient piece this rank owns, and the updated local
    compressor state (``state`` itself when written in place).
    """
    n = g.shape[0]
    D = axis_size(group)
    gated = step is not None and cfg.needs_state()
    if gated and cfg.every != 1:
        # an off-cadence step folds g into the OLD state after the encode,
        # so only an on-cadence step may overwrite it
        inplace = inplace and cfg.every > 1 and _cadence_on(step, cfg.every)
    if cfg.hierarchical:
        # routed before the fp and ef21 cases (never silently flattened):
        # what the exchange cannot serve raises in hierarchical_sync, and
        # with the bucket named when the step is built
        out = hierarchical_sync(
            g, state, cfg, (MeshAxis("data", group),) if axes is None
            else axes, gen, step, out_dtype=out_dtype, inplace=inplace,
            probe=probe, group=group)
        shard, new_state = out[0], out[1]
        if gated:
            shard, new_state = _cadence_select(g, state, cfg, step, shard,
                                               new_state)
        return (shard, new_state, out[2]) if probe else (shard, new_state)
    if cfg.strategy == "fp":
        # 16-bit-style baseline: reduce-scatter mean (bf16 wire)
        with PROF.phase("exchange"):
            g_shard = psum_scatter_flat(g.to(torch.bfloat16), group)
        shard = fp_mean(g_shard, D).to(out_dtype)
        if probe:
            # fp carries no fidelity unit: zero rows keep the leaf shape
            return shard, state, g.new_zeros((3, n // D), dtype=torch.float32)
        return shard, state
    if cfg.strategy == "ef21":
        raise NotImplementedError(
            "ef21 has no distributed form (receiver-side state); use "
            "strategy='ef' or 'loco'")

    codec = codec_lib.get_codec(cfg)
    with PROF.phase("encode"):            # compensate + quantize (Alg. 1)
        wire, new_state = codec.encode(g, state, gen, inplace=inplace)
    refs = _probe_refs(codec, g, wire, group) if probe else None
    with PROF.phase("exchange"):          # low-bit all-to-all (section 3.3)
        recv = exchange_wire(wire, codec.wire_shapes(n), D, group)
    with PROF.phase("decode"):            # dequant + f32 mean
        shard = codec.decode_mean(recv, out_dtype)
    if gated:
        shard, new_state = _cadence_select(g, state, cfg, step, shard,
                                           new_state)
    return (shard, new_state, refs) if probe else (shard, new_state)


# ---------------------------------------------------------------------------
# bucketed dispatch: many segments, each with its own config + state
# ---------------------------------------------------------------------------

def _none_leaves(codec: codec_lib.Codec, n: int,
                 wire: dict[str, torch.Tensor],
                 peers: int) -> dict[str, torch.Tensor]:
    """Broadcast the never-exchanged (``comm == "none"``) leaves to the
    peer-axis layout ``decode_mean`` expects."""
    return {name: wire[name].expand(peers, *wire[name].shape)
            for name, leaf in codec.wire_shapes(n).items()
            if leaf.comm == "none"}


def _fused_state(codec: codec_lib.Codec, states: tuple, run: WP.EncodeRun,
                 D: int) -> torch.Tensor:
    """Member bucket states -> the run segment's peer-major state vector."""
    if not codec.needs_state():
        return states[run.positions[0]]  # dummy; encode passes it through
    return WP.fuse_run_state(run, [states[p] for p in run.positions], D)


def _split_state(codec: codec_lib.Codec, ns: torch.Tensor, states: tuple,
                 run: WP.EncodeRun, D: int) -> list:
    """Inverse of :func:`_fused_state`: per-member updated state buffers."""
    if not codec.needs_state():
        return [states[pos] for pos in run.positions]
    return WP.split_run_state(run, ns, D)


def _grad_view(g: torch.Tensor, plan: ParamPlan, group) -> torch.Tensor:
    """The local full gradient as ``(D, C)``: row i is peer i's chunk."""
    D, C = axis_size(group), plan.chunklen
    if g.shape != (D * C,):
        raise ValueError(f"{plan.qualname}: gradient of shape "
                         f"{tuple(g.shape)}, plan wants ({D * C},)")
    return g.reshape(D, C)


def dist_sync_buckets(
    g: torch.Tensor,
    states: tuple[torch.Tensor, ...],
    plan: ParamPlan,
    group,
    coalesce: bool = True,
    step: int | None = None,
    *,
    overlap: bool = False,
    out_dtype: torch.dtype = torch.float32,
    inplace: bool = False,
    axes: tuple[MeshAxis, ...] | None = None,
    probe: bool = False,
):
    """Synchronize a full local gradient bucket by bucket.

    g:      (padlen,) local full gradient of one parameter (bf16 or f32;
            the kernels take it as it is, the codecs upcast exactly)
    states: one compressor state per bucket of ``plan`` (``(1,)`` dummies
            for stateless buckets)
    returns (g_shard (padlen/D,) in ``out_dtype``, new_states): this rank's
    chunk of the averaged gradient (the per-bucket shards in offset order)
    and the per-bucket updated states.

    With ``coalesce`` (the default) the plan's buckets encode as fused runs
    and cross the network in one packed collective per comm group
    (:func:`repro_torch.core.wirepack.build_group_plan`; a hierarchical
    bucket's two legs are packed per leg); ``coalesce=False`` runs
    :func:`dist_sync` once per bucket, the parity oracle.  ``overlap``
    pipelines the coalesced schedule over the stages of
    :func:`repro_torch.core.wirepack.build_overlap_schedule` (see
    :func:`_dist_sync_overlapped`) and requires ``coalesce``.  All give the
    same bits.  ``inplace``, ``step``, ``axes`` and ``probe`` as in
    :func:`dist_sync`; with ``probe`` the per-bucket reference stacks,
    zero-padded to the deepest bucket's rows, are concatenated in chunk
    order (the probe runs the flat schedule: ``overlap`` is refused).
    """
    if len(states) != len(plan.buckets):
        raise ValueError(f"{plan.qualname}: {len(states)} states for "
                         f"{len(plan.buckets)} buckets")
    if overlap and not coalesce:
        raise ValueError(
            "overlap pipelines the *packed* exchange; overlap=True requires "
            "coalesce=True (the per-bucket schedule has no packed stages to "
            "pipeline)")
    gm = _grad_view(g, plan, group)
    if coalesce:
        return _dist_sync_coalesced(gm, states, plan, group, run_space=False,
                                    step=step, out_dtype=out_dtype,
                                    inplace=inplace, overlap=overlap,
                                    axes=axes, probe=probe)
    shards, new_states, refs = [], [], []
    for b, st in zip(plan.buckets, states):
        out = dist_sync(gm[:, b.offset:b.chunk_end].reshape(-1), st,
                        b.sync, group, step=step, out_dtype=out_dtype,
                        inplace=inplace, axes=axes, probe=probe)
        shards.append(out[0])
        new_states.append(out[1])
        if probe:
            refs.append(out[2])
    if probe:
        rows = max(r.shape[0] for r in refs)
        prefs = torch.cat([_fit_rows(r, rows) for r in refs], dim=1)
        return torch.cat(shards), tuple(new_states), prefs
    return torch.cat(shards), tuple(new_states)


def dist_sync_runs(
    g: torch.Tensor,
    run_states: tuple[torch.Tensor, ...],
    plan: ParamPlan,
    group,
    step: int | None = None,
    *,
    overlap: bool = False,
    out_dtype: torch.dtype = torch.float32,
    inplace: bool = False,
    axes: tuple[MeshAxis, ...] | None = None,
    probe: bool = False,
):
    """:func:`dist_sync_buckets` (coalesced) with RUN-space states.

    ``run_states`` holds one peer-major buffer per encode run
    (:func:`repro_torch.core.flatparam.fuse_run_states`) instead of one
    per bucket: a run's state is the exact peer-major concatenation of its
    members', so the result is the same, and under a uniform policy the
    train state carries one buffer per parameter, as on the monolithic
    path.  With ``inplace`` an on-cadence run's new state is written into
    its buffer by the encode kernel.  ``overlap`` pipelines the schedule;
    a stage piece's state is then its columns of the run's buffer.
    ``probe`` as in :func:`dist_sync_buckets`.
    """
    return _dist_sync_coalesced(_grad_view(g, plan, group), run_states, plan,
                                group, run_space=True, step=step,
                                out_dtype=out_dtype, inplace=inplace,
                                overlap=overlap, axes=axes, probe=probe)


@dataclasses.dataclass
class _Inflight:
    """One stage's issued packed collectives, with every buffer they read
    or write.  The caller holds it until the stage is decoded, so the
    caching allocator cannot hand a buffer to other work while an
    asynchronous collective still uses it (whatever the process group's
    own stream bookkeeping does)."""

    works: list
    sent: list
    red: torch.Tensor | None = None      # reduce-scatter output (bf16 sums)
    # receive buffers of the all-to-alls and all-gathers, by (stage, kind)
    bufs: dict = dataclasses.field(default_factory=dict)


class _SyncPass:
    """One coalesced sync of a ``(D, C)`` gradient view: the encode, issue,
    complete and decode steps that the flat and the overlapped schedules
    sequence differently.  A *unit* is an encode run or a stage piece,
    given with the index of its run in ``encode_runs(plan)``.

    ``states`` and the new states are per run when ``run_space``, else per
    bucket (fused members are stitched through peer-major views around
    each encode).  A unit's gradient segment is ``gm[:, off:off + c]`` in
    the gradient's own dtype: a contiguous view at D = 1, one copy at
    D > 1.  Tier-0 cadence (``every > 1``) is gated per unit: off cadence
    the state folds the gradient in (``e <- e + g``) and the shard is
    zero, and only an on-cadence unit may have its state written in
    place.  A hierarchical unit's stage-1 wire is regrouped for the
    ``data`` axis, decoded into the pod mean, re-encoded by the stage-2
    codec and exchanged over the ``pod`` axis (``axes``, outermost
    first: ``(pod, data)``).  With ``probe`` each non-fp unit's live and
    zero-state roundtrips are kept by slot (``probe_rt``), read from the
    wire before any regroup."""

    def __init__(self, gm, states, group, run_space, step, out_dtype,
                 inplace, axes=None, probe=False):
        self.gm, self.states, self.group = gm, states, group
        self.run_space, self.step = run_space, step
        self.out_dtype, self.inplace = out_dtype, inplace
        self.D = gm.shape[0]
        self.axes = axes
        self.Pp, self.Dd = ((axes[0].size, axes[-1].size) if axes
                            else (1, self.D))
        self.new_states = list(states)
        self.shards: dict[int, torch.Tensor] = {}
        self.off_cadence: list[int] = []
        self.probe_rt: dict | None = {} if probe else None

    def _stage_group(self, stage: str):
        """The process group a wire stage crosses."""
        if stage == "flat":
            return self.group
        return (self.axes[-1] if stage == "hier1" else self.axes[0]).group

    def encode(self, units) -> tuple[dict, dict]:
        """Encode ``(run index, unit)`` pairs into fresh pack inputs:
        ``(wires, fp_segs)``, private to the caller's stage."""
        wires: dict[int, dict[str, torch.Tensor]] = {}
        fp_segs: dict[int, torch.Tensor] = {}
        for ri, u in units:
            seg = self.gm[:, u.offset:u.offset + u.chunk_total].reshape(-1)
            if u.sync.strategy == "fp":
                fp_segs[u.slot] = seg.to(torch.bfloat16)
                continue
            wire = self._encode_unit(ri, u, seg)
            if self.probe_rt is not None:
                self.probe_rt[u.slot] = _probe_rt(
                    codec_lib.get_codec(u.sync), seg, wire)
            if u.sync.hierarchical:
                wire = _regroup_wire(codec_lib.get_codec(u.sync), wire,
                                     seg.shape[0], self.Pp, self.Dd)
            wires[u.slot] = wire
        return wires, fp_segs

    def _encode_unit(self, ri, u, seg) -> dict[str, torch.Tensor]:
        cfg, D, states, new_states = u.sync, self.D, self.states, \
            self.new_states
        if cfg.strategy == "ef21":
            raise NotImplementedError(
                "ef21 has no distributed form (receiver-side state); "
                "use strategy='ef' or 'loco'")
        if cfg.hierarchical:
            _check_hier_codec(cfg)
        codec = codec_lib.get_codec(cfg)
        on = True
        if self.step is not None and cfg.every > 1:
            loco_lib.validate_cadence(cfg)
            on = _cadence_on(self.step, cfg.every)
            if not on:
                self.off_cadence.append(u.slot)

        def select(ns, st):
            """Off-cadence: the state accumulates this step's gradient
            instead of keeping the exchanged update."""
            if on:
                return ns
            acc = codec.state_encode(seg.float() + codec.state_decode(st))
            return acc.to(ns.dtype)

        inplace = self.inplace and on
        if (self.run_space and isinstance(u, WP.StagePiece) and not u.whole
                and codec.needs_state()):
            # a piece's state: columns [col_off, col_off + c) of its run's
            # peer-major (D, run_total) buffer -- a view at D = 1 (the
            # kernel then writes the run's buffer in place), a copy at
            # D > 1 (never a strided view: the kernels take contiguous
            # memory), written back after the encode
            if new_states[ri] is states[ri] and not inplace:
                new_states[ri] = torch.empty_like(states[ri])
            a, b = u.col_off, u.col_off + u.chunk_total

            def cols(buf):
                return buf.view(D, u.run_total)[:, a:b]

            src = cols(states[ri])
            private = not src.is_contiguous()
            st = src.reshape(-1)
            wire, ns = codec.encode(seg, st, inplace=inplace or private)
            ns = select(ns, st)
            dst = cols(new_states[ri])
            if not same_start(ns, dst):
                dst.copy_(ns.view(D, -1))
        elif self.run_space:
            wire, ns = codec.encode(seg, states[ri], inplace=inplace)
            new_states[ri] = select(ns, states[ri])
        elif u.fused:
            fs = _fused_state(codec, states, u, D)
            wire, ns = codec.encode(seg, fs)
            ns = select(ns, fs)
            for pos, s in zip(u.positions,
                              _split_state(codec, ns, states, u, D)):
                new_states[pos] = s
        else:
            pos = u.positions[0]
            wire, ns = codec.encode(seg, states[pos], inplace=inplace)
            new_states[pos] = select(ns, states[pos])
        return wire

    def issue(self, gplan: WP.WireGroupPlan, wires: dict, fp_segs: dict,
              stages=("flat", "hier1")) -> _Inflight:
        """Start the packed collectives of ``stages``, asynchronously: per
        stage at most one u8 all-to-all (``split`` leaves) and one
        all-gather (``gather`` leaves), each over the stage's group, and
        with ``flat`` one bf16 reduce-scatter (fp runs)."""
        inf = _Inflight(works=[], sent=[])

        def start(collective, x, group):
            out, work = collective(x, group, async_op=True)
            if OBSERVER is not None:
                OBSERVER.issued(work)
            inf.works.append(work)
            inf.sent.append(x)
            return out

        rg = gplan.group("flat", "reduce")
        if rg is not None and "flat" in stages:
            inf.red = start(psum_scatter_flat,
                            WP.pack_reduce(rg, fp_segs).contiguous(),
                            self.group)
        for stage in stages:
            ga = gplan.group(stage, "a2a")
            if ga is not None:
                inf.bufs[stage, "a2a"] = start(
                    all_to_all_chunks, WP.pack_a2a(ga, wires).contiguous(),
                    self._stage_group(stage))
            gg = gplan.group(stage, "gather")
            if gg is not None:
                inf.bufs[stage, "gather"] = start(
                    all_gather_flat, WP.pack_gather(gg, wires).contiguous(),
                    self._stage_group(stage))
        return inf

    def complete(self, gplan: WP.WireGroupPlan, inf: _Inflight,
                 wires: dict) -> dict[int, dict[str, torch.Tensor]]:
        """Wait for a stage's collectives (the current stream then waits
        for them); store its fp shards and return the received leaves per
        unit slot (leading peer axis), bit-identical to what the
        per-bucket :func:`exchange_wire` would deliver."""
        for w in inf.works:
            if OBSERVER is None:
                w.wait()
            else:
                OBSERVER.wait(w)
        recv: dict[int, dict[str, torch.Tensor]] = {}
        if inf.red is not None:
            self.shards.update(WP.unpack_reduce(
                gplan.group("flat", "reduce"),
                fp_mean(inf.red, self.D).to(self.out_dtype)))
        for (stage, kind), buf in inf.bufs.items():
            grp = gplan.group(stage, kind)
            if kind == "a2a":
                got = WP.unpack_a2a(grp, buf)
            else:
                shapes: dict[int, dict[str, tuple]] = {}
                for l in grp.leaves:
                    shapes.setdefault(l.bucket, {})[l.name] = \
                        wires[l.bucket][l.name].shape
                got = WP.unpack_gather(grp, buf.reshape(grp.peers, -1),
                                       shapes)
            for slot, leaves in got.items():
                recv.setdefault(slot, {}).update(leaves)
        return recv

    def decode(self, units, wires: dict, recv: dict,
               gplan: WP.WireGroupPlan) -> None:
        """Decode-mean every non-fp unit into its shard.  A hierarchical
        unit's stage-1 decode is its pod mean, which the stage-2 codec
        re-encodes; every such unit's stage-2 wire then crosses the pod
        axis in one packed exchange and decodes into its shard."""
        wires2: dict[int, dict[str, torch.Tensor]] = {}
        codecs2: dict[int, tuple[codec_lib.Codec, int]] = {}
        for _, u in units:
            if u.sync.strategy == "fp":
                continue
            codec = codec_lib.get_codec(u.sync)
            r = dict(recv.get(u.slot, {}))
            if not u.sync.hierarchical:
                r.update(_none_leaves(codec, self.D * u.chunk_total,
                                      wires[u.slot], self.D))
                self.shards[u.slot] = codec.decode_mean(r, self.out_dtype)
                continue
            r.update(_none_leaves(codec, self.D * u.chunk_total,
                                  wires[u.slot], self.Dd))
            pod_mean = codec.decode_mean(r)
            codec2 = codec_lib.get_codec(loco_lib.validate_stage2(u.sync))
            n2 = pod_mean.shape[0]
            wires2[u.slot], _ = codec2.encode(
                pod_mean, codec2.init_state(n2, pod_mean.device))
            codecs2[u.slot] = (codec2, n2)
        if not wires2:
            return
        recv2 = self.complete(gplan, self.issue(gplan, wires2, {},
                                                stages=("hier2",)), wires2)
        for slot, (codec2, n2) in codecs2.items():
            r = dict(recv2.get(slot, {}))
            r.update(_none_leaves(codec2, n2, wires2[slot], self.Pp))
            self.shards[slot] = codec2.decode_mean(r, self.out_dtype)

    def result(self, units) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The shard (units partition chunk space in offset order) and the
        new states; off-cadence units contribute zeros."""
        for slot in self.off_cadence:
            self.shards[slot] = torch.zeros_like(self.shards[slot])
        parts = [self.shards[u.slot] for _, u in units]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out, tuple(self.new_states)

def _dist_sync_coalesced(
    gm: torch.Tensor,
    states: tuple[torch.Tensor, ...],
    plan: ParamPlan,
    group,
    run_space: bool,
    step: int | None,
    out_dtype: torch.dtype,
    inplace: bool,
    overlap: bool = False,
    axes: tuple[MeshAxis, ...] | None = None,
    probe: bool = False,
):
    """The coalesced schedule over ``gm`` (the ``(D, C)`` gradient view):
    encode every run, one packed collective per comm group, decode every
    run (:class:`_SyncPass`).  With ``overlap`` a plan whose schedule
    pipelines runs :func:`_dist_sync_overlapped` instead; a single-stage
    schedule is this flat one.  The pipelined schedule cannot carry
    cadence buckets (a stage piece cannot gate its whole run's
    accumulator): refused here and, with the bucket named, when the step
    is built (``launch.steps._validate_sync_configs``).  A plan with
    hierarchical buckets needs ``axes`` = ``(pod, data)``.  The probe runs
    on this flat schedule only (the overlapped one gives the same bits):
    its three rows cross in one packed reduce-scatter over the dp group,
    fp runs contributing zero live and counterfactual columns."""
    if probe and overlap:
        raise ValueError(
            "the fidelity probe runs on the flat coalesced schedule only "
            "(bit-exact with overlap; the probe step variant forces "
            "overlap off — see launch/steps.py)")
    D = gm.shape[0]
    runs = WP.encode_runs(plan)
    want = len(runs) if run_space else len(plan.buckets)
    if len(states) != want:
        raise ValueError(f"{plan.qualname}: {len(states)} states, want "
                         f"{want} ({'runs' if run_space else 'buckets'})")
    if any(b.sync.hierarchical and b.sync.strategy != "fp"
           for b in plan.buckets):
        axes = (MeshAxis("data", group),) if axes is None else axes
        _check_hier_axes(axes)
    else:
        axes = None
    sp = _SyncPass(gm, states, group, run_space, step, out_dtype, inplace,
                   axes, probe)
    if overlap:
        sched = WP.build_overlap_schedule(plan, D, pods=sp.Pp)
        if sched.pipelined:
            cadenced = [b for b in plan.buckets if b.sync.every > 1]
            if step is not None and cadenced:
                raise ValueError(
                    f"bucket {cadenced[0].index}: sync cadence every="
                    f"{cadenced[0].sync.every} cannot ride the pipelined "
                    "overlap schedule; run cadence plans with overlap "
                    "disabled")
            return _dist_sync_overlapped(sp, sched)
    gplan = WP.build_group_plan(plan, D, pods=sp.Pp)
    units = list(enumerate(runs))
    with PROF.phase("encode"):
        wires, fp_segs = sp.encode(units)
    refs = None
    if probe:
        with PROF.phase("probe"):
            def cols(i):
                return torch.cat(
                    [sp.probe_rt[r.slot][i].reshape(D, r.chunk_total)
                     if r.slot in sp.probe_rt
                     else gm.new_zeros((D, r.chunk_total),
                                       dtype=torch.float32)
                     for r in runs], dim=1)
            rows = torch.stack([gm.float(), cols(0), cols(1)]).reshape(3, -1)
            refs = _probe_reduce(rows, group)
    with PROF.phase("exchange"):
        recv = sp.complete(gplan, sp.issue(gplan, wires, fp_segs), wires)
    with PROF.phase("decode"):
        sp.decode(units, wires, recv, gplan)
    shard, new_states = sp.result(units)
    return (shard, new_states, refs) if probe else (shard, new_states)


def _dist_sync_overlapped(sp: _SyncPass, sched: WP.OverlapSchedule):
    """Pipelined coalesced schedule over the stages of ``sched``.

    Encode stage 0 and issue its packed collectives asynchronously; then
    for each later stage k: encode it while stage k-1's collectives run,
    wait for stage k-1 and decode it, issue stage k.  At most two stages'
    pack buffers are alive at once.  Where the reference pins the encode
    into the exchange's window with ``lax.optimization_barrier``, the port
    gets the overlap from ``async_op=True`` collectives.  A hierarchical
    piece's stage-2 leg exchanges within its stage's decode, as the
    reference's does.

    Bit-exact with the flat schedule by construction: each piece's encoded
    bytes equal its slice of the flat schedule's buffers (fusible codecs
    are elementwise per 256-block and pieces cut on 512-aligned bucket
    edges; non-fusible runs stay atomic), collectives move bytes verbatim,
    each ``decode_mean`` sees the same inputs, and the shards concatenate
    in chunk-offset order."""
    stages = sched.stages

    def units(stage):
        return [(p.run_index, p) for p in stage.pieces]

    with PROF.phase("encode", group=0):
        wires, fp_segs = sp.encode(units(stages[0]))
    with PROF.phase("exchange", group=0):
        inflight = sp.issue(stages[0].gplan, wires, fp_segs)
    prev = (stages[0], wires, inflight)
    for k in range(1, len(stages)):
        with PROF.phase("encode", group=k):
            wires, fp_segs = sp.encode(units(stages[k]))
        stage, pwires, pinf = prev
        with PROF.phase("decode", group=k - 1):
            sp.decode(units(stage), pwires,
                      sp.complete(stage.gplan, pinf, pwires), stage.gplan)
        with PROF.phase("exchange", group=k):
            inflight = sp.issue(stages[k].gplan, wires, fp_segs)
        prev = (stages[k], wires, inflight)
    stage, pwires, pinf = prev
    with PROF.phase("decode", group=len(stages) - 1):
        sp.decode(units(stage), pwires,
                  sp.complete(stage.gplan, pinf, pwires), stage.gplan)
    return sp.result([u for st in stages for u in units(st)])


# ---------------------------------------------------------------------------
# hierarchical (multi-tier) exchange over the nested dp mesh axes
# ---------------------------------------------------------------------------

def _check_hier_axes(axes: tuple[MeshAxis, ...], ntiers: int = 1) -> None:
    if len(axes) == 1 + ntiers:
        return
    if ntiers == 1:
        raise ValueError(
            f"hierarchical sync needs a (pod, data) mesh; got dp axes "
            f"{_names(axes)!r} — use the flat exchange (hierarchical=False) "
            "on single-axis meshes")
    raise ValueError(
        f"a {ntiers}-tier sync schedule needs {1 + ntiers} dp mesh axes "
        f"(one per exchange leg, innermost first); got {len(axes)}: "
        f"{_names(axes)!r}")


def _check_hier_codec(cfg: SyncConfig) -> None:
    if cfg.strategy not in codec_lib.CODECS:
        raise ValueError(
            f"hierarchical sync needs a registered wire codec for stage 1; "
            f"strategy {cfg.strategy!r} has none "
            f"(registered: {sorted(codec_lib.CODECS)})")


def _regroup_chunks(arr: torch.Tensor, Pp: int, Dd: int) -> torch.Tensor:
    """Flat chunk-major wire leaf -> ``(Dd, Pp * k)`` rows for the exchange
    over the inner axis.

    The segment's flat chunk order is ``r = p * Dd + d``; data-peer ``d``'s
    row must carry the ``Pp`` chunks ``{p * Dd + d : p}``, so reshape to
    ``(Pp, Dd, k)`` and move the pod axis inward.  ``k`` is the per-chunk
    leaf length (payload bytes, block scales, packed signs, top-k slots),
    whole because bucket edges are 512-aligned.  The transpose runs on the
    leaf's bytes (exact for any dtype, the unsigned ones included).
    """
    k, rem = divmod(arr.shape[0], Pp * Dd)
    if rem:
        raise ValueError(f"leaf of {arr.shape[0]} elements does not split "
                         f"into {Pp} x {Dd} chunks")
    b = WP.to_bytes(arr).reshape(Pp, Dd, -1).transpose(0, 1)
    return WP.from_bytes(b.reshape(Dd, -1), arr.dtype)


def _regroup_wire(codec: codec_lib.Codec, wire: dict, n: int, Pp: int,
                  Dd: int) -> dict[str, torch.Tensor]:
    """A wire dict with every ``split`` leaf regrouped (flat) for the
    inner axis; ``gather``/``none`` leaves are per node and stay."""
    return {name: (_regroup_chunks(wire[name], Pp, Dd).reshape(-1)
                   if leaf.comm == "split" else wire[name])
            for name, leaf in codec.wire_shapes(n).items()}


def hierarchical_sync(
    g: torch.Tensor,
    state: torch.Tensor,
    cfg: SyncConfig,
    axes: tuple[MeshAxis, ...],
    gen: torch.Generator | None = None,
    step: int | None = None,
    *,
    out_dtype: torch.dtype = torch.float32,
    inplace: bool = False,
    probe: bool = False,
    group=None,
):
    """Codec-level N-tier exchange over the nested dp mesh ``axes``
    (outermost first).

    The tier list is :func:`repro_torch.core.loco.sync_schedule`'s: the
    classic ``hierarchical=True`` config is ONE outer tier (stage 2) over a
    ``(pod, data)`` mesh; an explicit ``cfg.tiers`` schedule runs one leg
    per tier over ever outer axes (stage 1 crosses ``axes[-1]``, tier
    ``t`` crosses ``axes[-2 - t]``).

    Stage 1: the bucket's own codec (its CUDA kernels on the card) encodes
    the local segment as the flat path would; its ``split`` leaves are
    regrouped so row ``d`` carries the chunks data-peer ``d`` owns, the
    wire crosses the innermost axis only (``gather`` leaves all-gathered,
    so each peer's payload decodes with its own metadata), and
    ``decode_mean`` gives the f32 mean over the inner group of the chunks
    this device group owns.

    Tier ``t``: the tier's codec (stateless, or ``topk`` from a fresh zero
    state, :func:`repro_torch.core.loco.validate_tier_codec`) re-encodes
    the running mean, exchanges it over the tier's axis with
    :func:`exchange_wire` and decodes the mean, so every leg is the flat
    path's encode -> exchange -> decode_mean and sim == dist holds by
    construction (:func:`repro_torch.core.loco.sim_sync_hier`).

    Tier cadence (``tier.every > 1``, DESIGN.md section 16): a tier
    exchanges when ``step % every == every - 1``; off cadence each device
    keeps its OWN group's running mean (its slice of the tier input at its
    index on the tier's axis).  Every rank evaluates the same cadence, so
    an off-cadence tier issues no collective (the reference's SPMD form
    still runs them and selects).

    The device with flat dp rank r ends with flat chunk r, as with the
    flat exchange, so the FSDP layout is unchanged.  Error feedback
    covers stage 1 only: the new state is the flat path's, bit for bit.

    With ``probe`` (``group``: the flat dp group over all the axes) also
    returns the reference stack ``(3 + tiers - 1, n/D)``: the base rows of
    the stage-1 encode in one reduce-scatter over ``group``, then after
    each non-final tier's (cadence-selected) output the exact mean over
    the axes not crossed yet, scattered down to this rank's final chunk,
    so consecutive references telescope.
    Returns (shard (n/D,) in ``out_dtype``, new_state[, refs]).
    """
    tiers = loco_lib.sync_schedule(cfg)
    _check_hier_axes(axes, len(tiers))
    _check_hier_codec(cfg)
    sizes = [a.size for a in axes]
    Dd = sizes[-1]
    rem = math.prod(sizes[:-1])   # chunk groups left after stage 1
    n = g.shape[0]

    # --- stage 1: own codec, innermost-axis exchange -----------------------
    codec = codec_lib.get_codec(cfg)
    with PROF.phase("encode"):
        wire, new_state = codec.encode(g, state, gen, inplace=inplace)
        shapes1 = codec.wire_shapes(n)
        wire1 = _regroup_wire(codec, wire, n, rem, Dd)
    refs = None
    if probe:
        if group is None:
            raise ValueError("the hierarchical probe needs the flat dp group")
        refs = [_probe_refs(codec, g, wire, group)]
    with PROF.phase("exchange"):
        recv1 = exchange_wire(wire1, shapes1, Dd, axes[-1].group)
    with PROF.phase("decode"):
        cur = codec.decode_mean(recv1)               # (rem * c,) f32

    # --- outer tiers: stateless re-encode, one mesh axis per tier ----------
    for t, tier in enumerate(tiers):
        ax, P = axes[-2 - t], sizes[-2 - t]
        rem //= P          # chunk groups left after THIS tier
        codec_t = codec_lib.get_codec(loco_lib.validate_tier_codec(tier.sync))
        n_t = cur.shape[0]
        if step is not None and tier.every > 1 \
                and not _cadence_on(step, tier.every):
            # off cadence: my group's running mean of my chunks -- my slice
            # of the tier input (my index on this axis is the fast
            # coordinate of the remaining chunk order)
            cur = cur.reshape(rem, P, n_t // (rem * P))[:, ax.index] \
                .reshape(-1)
        else:
            with PROF.phase("encode"):
                wire_t, _ = codec_t.encode(cur, codec_t.init_state(
                    n_t, cur.device))
                shapes_t = codec_t.wire_shapes(n_t)
                if rem > 1:
                    # the stage-1 interleave: this tier's peer coordinate
                    # is the fast index of the remaining chunk order
                    wire_t = _regroup_wire(codec_t, wire_t, n_t, rem, P)
            with PROF.phase("exchange"):
                recv_t = exchange_wire(wire_t, shapes_t, P, ax.group)
            with PROF.phase("decode"):
                cur = codec_t.decode_mean(recv_t)    # (n_t / P,) f32
        if probe and t < len(tiers) - 1:
            # the exact mean over the axes still uncrossed, scattered down
            # to my final chunk (rank-major chunk order matches the
            # remaining legs' delivery)
            with PROF.phase("probe"):
                ref = cur
                for outer in axes[:len(axes) - 2 - t]:
                    ref = psum_scatter_flat(ref, outer.group)
                refs.append(divide(ref, rem)[None])
    if probe:
        return cur.to(out_dtype), new_state, torch.cat(refs)
    return cur.to(out_dtype), new_state
