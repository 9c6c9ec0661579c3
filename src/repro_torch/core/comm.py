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
**locally in f32** (paper section 3.3).  ``dist_sync_buckets`` and
``dist_sync_runs`` do so per bucketed plan, coalesced into one packed
collective per comm group, flat or pipelined over the plan's overlap
stages with asynchronous collectives.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import codec as codec_lib
from repro_torch.core import loco as loco_lib
from repro_torch.core import wirepack as WP
from repro_torch.core.buckets import ParamPlan
from repro_torch.core.loco import SyncConfig
from repro_torch.kernels import loco_quant as LQ
from repro_torch.telemetry import profiler as PROF

# torch renamed the tensor-in/tensor-out collectives; take whichever exists
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def axis_size(group) -> int:
    return dist.get_world_size(group)


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


def fp_mean(summed: torch.Tensor, D: int) -> torch.Tensor:
    """The f32 mean ``summed / D`` of a reduce-scatter sum over ``D``
    peers, one IEEE division (:func:`divide`)."""
    return divide(summed.float(), D)


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
        return fp_mean(g_shard, D).to(out_dtype), state
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
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
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
    (:func:`repro_torch.core.wirepack.build_group_plan`); ``coalesce=False``
    runs :func:`dist_sync` once per bucket, the parity oracle.  ``overlap``
    pipelines the coalesced schedule over the stages of
    :func:`repro_torch.core.wirepack.build_overlap_schedule` (see
    :func:`_dist_sync_overlapped`) and requires ``coalesce``.  All give the
    same bits.  ``inplace`` and ``step`` as in :func:`dist_sync`.
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
                                    inplace=inplace, overlap=overlap)
    shards, new_states = [], []
    for b, st in zip(plan.buckets, states):
        sh, ns = dist_sync(gm[:, b.offset:b.chunk_end].reshape(-1), st,
                           b.sync, group, step=step, out_dtype=out_dtype,
                           inplace=inplace)
        shards.append(sh)
        new_states.append(ns)
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
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """:func:`dist_sync_buckets` (coalesced) with RUN-space states.

    ``run_states`` holds one peer-major buffer per encode run
    (:func:`repro_torch.core.flatparam.fuse_run_states`) instead of one
    per bucket: a run's state is the exact peer-major concatenation of its
    members', so the result is the same, and under a uniform policy the
    train state carries one buffer per parameter, as on the monolithic
    path.  With ``inplace`` an on-cadence run's new state is written into
    its buffer by the encode kernel.  ``overlap`` pipelines the schedule;
    a stage piece's state is then its columns of the run's buffer.
    """
    return _dist_sync_coalesced(_grad_view(g, plan, group), run_states, plan,
                                group, run_space=True, step=step,
                                out_dtype=out_dtype, inplace=inplace,
                                overlap=overlap)


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
    a2a: torch.Tensor | None = None      # all-to-all receive buffer
    gat: torch.Tensor | None = None      # all-gather receive buffer


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
    place."""

    def __init__(self, gm, states, group, run_space, step, out_dtype,
                 inplace):
        self.gm, self.states, self.group = gm, states, group
        self.run_space, self.step = run_space, step
        self.out_dtype, self.inplace = out_dtype, inplace
        self.D = gm.shape[0]
        self.new_states = list(states)
        self.shards: dict[int, torch.Tensor] = {}
        self.off_cadence: list[int] = []

    def encode(self, units) -> tuple[dict, dict]:
        """Encode ``(run index, unit)`` pairs into fresh pack inputs:
        ``(wires, fp_segs)``, private to the caller's stage."""
        wires: dict[int, dict[str, torch.Tensor]] = {}
        fp_segs: dict[int, torch.Tensor] = {}
        for ri, u in units:
            seg = self.gm[:, u.offset:u.offset + u.chunk_total].reshape(-1)
            if u.sync.strategy == "fp":
                fp_segs[u.slot] = seg.to(torch.bfloat16)
            else:
                wires[u.slot] = self._encode_unit(ri, u, seg)
        return wires, fp_segs

    def _encode_unit(self, ri, u, seg) -> dict[str, torch.Tensor]:
        cfg, D, states, new_states = u.sync, self.D, self.states, \
            self.new_states
        if cfg.strategy == "ef21":
            raise NotImplementedError(
                "ef21 has no distributed form (receiver-side state); "
                "use strategy='ef' or 'loco'")
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
            if ns.data_ptr() != dst.data_ptr():
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

    def issue(self, gplan: WP.WireGroupPlan, wires: dict,
              fp_segs: dict) -> _Inflight:
        """Start a stage's packed collectives, asynchronously: at most one
        bf16 reduce-scatter (fp runs), one u8 all-to-all (``split``
        leaves) and one all-gather (``gather`` leaves)."""
        inf = _Inflight(works=[], sent=[])

        def start(collective, x):
            out, work = collective(x, self.group, async_op=True)
            inf.works.append(work)
            inf.sent.append(x)
            return out

        rg = gplan.group("flat", "reduce")
        if rg is not None:
            inf.red = start(psum_scatter_flat,
                            WP.pack_reduce(rg, fp_segs).contiguous())
        ga = gplan.group("flat", "a2a")
        if ga is not None:
            inf.a2a = start(all_to_all_chunks,
                            WP.pack_a2a(ga, wires).contiguous())
        gg = gplan.group("flat", "gather")
        if gg is not None:
            inf.gat = start(all_gather_flat,
                            WP.pack_gather(gg, wires).contiguous())
        return inf

    def complete(self, gplan: WP.WireGroupPlan, inf: _Inflight,
                 wires: dict) -> dict[int, dict[str, torch.Tensor]]:
        """Wait for a stage's collectives (the current stream then waits
        for them); store its fp shards and return the received leaves per
        unit slot (leading peer axis), bit-identical to what the
        per-bucket :func:`exchange_wire` would deliver."""
        for w in inf.works:
            w.wait()
        recv: dict[int, dict[str, torch.Tensor]] = {}
        if inf.red is not None:
            self.shards.update(WP.unpack_reduce(
                gplan.group("flat", "reduce"),
                fp_mean(inf.red, self.D).to(self.out_dtype)))
        if inf.a2a is not None:
            for slot, leaves in WP.unpack_a2a(gplan.group("flat", "a2a"),
                                              inf.a2a).items():
                recv.setdefault(slot, {}).update(leaves)
        if inf.gat is not None:
            gg = gplan.group("flat", "gather")
            shapes: dict[int, dict[str, tuple]] = {}
            for l in gg.leaves:
                shapes.setdefault(l.bucket, {})[l.name] = \
                    wires[l.bucket][l.name].shape
            for slot, leaves in WP.unpack_gather(
                    gg, inf.gat.reshape(gg.peers, -1), shapes).items():
                recv.setdefault(slot, {}).update(leaves)
        return recv

    def decode(self, units, wires: dict, recv: dict) -> None:
        """Decode-mean every non-fp unit into its shard."""
        for _, u in units:
            if u.sync.strategy == "fp":
                continue
            codec = codec_lib.get_codec(u.sync)
            r = dict(recv.get(u.slot, {}))
            r.update(_none_leaves(codec, self.D * u.chunk_total,
                                  wires[u.slot], self.D))
            self.shards[u.slot] = codec.decode_mean(r, self.out_dtype)

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
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The coalesced schedule over ``gm`` (the ``(D, C)`` gradient view):
    encode every run, one packed collective per comm group, decode every
    run (:class:`_SyncPass`).  With ``overlap`` a plan whose schedule
    pipelines runs :func:`_dist_sync_overlapped` instead; a single-stage
    schedule is this flat one.  The pipelined schedule cannot carry
    cadence buckets (a stage piece cannot gate its whole run's
    accumulator): refused here and, with the bucket named, when the step
    is built (``launch.steps._validate_sync_configs``)."""
    D = gm.shape[0]
    runs = WP.encode_runs(plan)
    want = len(runs) if run_space else len(plan.buckets)
    if len(states) != want:
        raise ValueError(f"{plan.qualname}: {len(states)} states, want "
                         f"{want} ({'runs' if run_space else 'buckets'})")
    sp = _SyncPass(gm, states, group, run_space, step, out_dtype, inplace)
    if overlap:
        sched = WP.build_overlap_schedule(plan, D)
        if sched.pipelined:
            cadenced = [b for b in plan.buckets if b.sync.every > 1]
            if step is not None and cadenced:
                raise ValueError(
                    f"bucket {cadenced[0].index}: sync cadence every="
                    f"{cadenced[0].sync.every} cannot ride the pipelined "
                    "overlap schedule; run cadence plans with overlap "
                    "disabled")
            return _dist_sync_overlapped(sp, sched)
    gplan = WP.build_group_plan(plan, D)
    units = list(enumerate(runs))
    with PROF.phase("encode"):
        wires, fp_segs = sp.encode(units)
    with PROF.phase("exchange"):
        recv = sp.complete(gplan, sp.issue(gplan, wires, fp_segs), wires)
    with PROF.phase("decode"):
        sp.decode(units, wires, recv)
    return sp.result(units)


def _dist_sync_overlapped(sp: _SyncPass, sched: WP.OverlapSchedule):
    """Pipelined coalesced schedule over the stages of ``sched``.

    Encode stage 0 and issue its packed collectives asynchronously; then
    for each later stage k: encode it while stage k-1's collectives run,
    wait for stage k-1 and decode it, issue stage k.  At most two stages'
    pack buffers are alive at once.  Where the reference pins the encode
    into the exchange's window with ``lax.optimization_barrier``, the port
    gets the overlap from ``async_op=True`` collectives.

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
                      sp.complete(stage.gplan, pinf, pwires))
        with PROF.phase("exchange", group=k):
            inflight = sp.issue(stages[k].gplan, wires, fp_segs)
        prev = (stages[k], wires, inflight)
    stage, pwires, pinf = prev
    with PROF.phase("decode", group=len(stages) - 1):
        sp.decode(units(stage), pwires,
                  sp.complete(stage.gplan, pinf, pwires))
    return sp.result([u for st in stages for u in units(st)])
