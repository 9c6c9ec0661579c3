"""Flat-parameter FSDP layout (PyTorch-FSDP-style).

Port of the monolithic path of ``repro.core.flatparam``.  Every parameter
tensor is described by a :class:`ParamInfo` and stored as a **flat f32
master chunk** per rank: the logical tensor is flattened, padded to a
multiple of ``D * GRAIN`` (``GRAIN = 512`` keeps every dp chunk divisible by
the int4 pack factor and the quantizer block), and split into ``D`` equal
chunks; rank ``r`` keeps chunk ``r``.

Per-rank storage (the reference's local views with the singleton mesh
dimensions dropped):

=================  ==========================
object             shape on one rank
param chunk        (L?, chunklen) f32
compressor state   (L?, padlen) state dtype, or (L?, 1) f32 dummy; under
                   a sync plan a tuple with one such tensor per state
                   unit (:func:`state_units`)
optimizer state    like the param chunk
=================  ==========================

``materialize`` turns a chunk into the logical bf16 tensor inside the
forward: bf16 cast -> FSDP all-gather (with the LoCo backward) -> unpad ->
reshape.

At ``tp > 1`` every parameter is its TP-local slice (``ParamInfo.tp_dim``),
chunked over the data group; each model index syncs its own slice there.
A replicated leaf (``tp_dim`` None) is wrapped in
:func:`~repro_torch.core.hijack.replicated_grad_psum`, as in the reference.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import math
import os
import types
import zlib
from typing import Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.core import loco as loco_lib
from repro_torch.core import wirepack as WP
from repro_torch.core.buckets import ParamPlan, SyncPlan
from repro_torch.core.hijack import (gather_fp, gather_with_sync,
                                     gather_with_sync_buckets,
                                     gather_with_sync_runs,
                                     replicated_grad_psum)
from repro_torch.core.loco import SyncConfig
from repro_torch.telemetry import profiler as PROF

GRAIN = 512  # dp chunks stay divisible by 2 (int4 pack) * 256 (quant block)


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    """Static description of one logical parameter tensor."""

    name: str
    shape: tuple[int, ...]          # logical *global* shape
    tp_dim: int | None = None       # dim sharded over "model" (None = replicated)
    init: str = "normal"            # normal | zeros | ones | embed
    init_scale: float | None = None  # overrides default fan-in scaling
    loco: bool = True               # quantized sync (False -> bf16 reduce-scatter)
    decay: bool = True              # weight-decay mask

    def local_shape(self, tp: int) -> tuple[int, ...]:
        if self.tp_dim is None:
            return self.shape
        s = list(self.shape)
        if s[self.tp_dim] % tp:
            raise ValueError(f"{self.name}: dim {self.tp_dim} of {self.shape} "
                             f"does not split over tp={tp}")
        s[self.tp_dim] //= tp
        return tuple(s)

    def numel_local(self, tp: int) -> int:
        return math.prod(self.local_shape(tp))

    def padlen(self, tp: int, d: int) -> int:
        n = self.numel_local(tp)
        g = d * GRAIN
        return (n + g - 1) // g * g

    def chunklen(self, tp: int, d: int) -> int:
        return self.padlen(tp, d) // d

    def fan_scale(self) -> float:
        if self.init_scale is not None:
            return self.init_scale
        if self.init == "embed":
            return 1.0
        fan_in = self.shape[0] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


@dataclasses.dataclass(frozen=True, eq=False)
class MeshTopo:
    """Static topology facts of one rank in a ``dp x tp`` world: its data
    group (``group``, over which the chunks are cut and the gradients
    sync), its size and this rank's index there (``rank``); the ``model``
    group (``launch.mesh.mesh_groups``), its size ``tp`` and this rank's
    index there (``tp_rank``); and the ``world`` group over every rank,
    on which the global norm and the loss are reduced.

    On a multi-pod mesh the flat data group is also cut by mesh axis:
    ``axes`` holds one ``comm.MeshAxis`` per dp axis, outermost first
    (``(wan,) pod, data``), which the hierarchical sync exchanges over;
    ``pods`` and ``wans`` are the sizes of the ``pod`` and ``wan`` axes
    (1 without them), and ``dp_axes`` their names, as in the reference."""

    group: object       # torch.distributed process group over the dp ranks
    dp: int
    rank: int
    tp: int = 1
    model: object = None  # process group over the tp ranks
    tp_rank: int = 0
    axes: tuple = ()    # comm.MeshAxis per dp axis, outermost first
    pods: int = 1
    wans: int = 1

    @property
    def world(self):
        """The group over all dp * tp ranks (the data group at tp = 1)."""
        return self.group if self.tp == 1 else dist.group.WORLD

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes) or ("data",)

    @staticmethod
    def from_group(group, model=None, axes=None) -> "MeshTopo":
        """The topology of the data group ``group``, the model group
        ``model`` (None: ``tp = 1`` with no model group) and the dp mesh
        ``axes`` (None: one flat ``data`` axis)."""
        sizes = {a.name: a.size for a in axes or ()}
        topo = MeshTopo(group=group, dp=dist.get_world_size(group),
                        rank=dist.get_rank(group),
                        tp=1 if model is None else dist.get_world_size(model),
                        model=model,
                        tp_rank=0 if model is None else dist.get_rank(model),
                        axes=tuple(axes or ()), pods=sizes.get("pod", 1),
                        wans=sizes.get("wan", 1))
        if topo.tp > 1 and dist.get_world_size() != topo.dp * topo.tp:
            raise ValueError(f"dp {topo.dp} x tp {topo.tp} ranks do not make "
                             f"the world of {dist.get_world_size()}")
        return topo


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    """A named set of ParamInfos, optionally stacked L times (layers)."""

    name: str
    infos: tuple[ParamInfo, ...]
    n_layers: int | None = None  # None = not stacked

    @property
    def stacked(self) -> bool:
        return self.n_layers is not None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_full(info: ParamInfo, gen: torch.Generator, tp: int,
               tp_rank: int = 0) -> torch.Tensor:
    """The logical TP-local tensor, f32, flattened, on the CPU: the slice
    ``tp_rank`` along ``tp_dim`` of the global tensor, so one seed draws
    the same weights at any ``tp``."""
    n = math.prod(info.shape)
    if info.init == "zeros":
        full = torch.zeros(n)
    elif info.init == "ones":
        full = torch.ones(n)
    else:
        full = torch.randn(n, generator=gen) * info.fan_scale()
    if info.tp_dim is None or tp == 1:
        return full
    w = info.local_shape(tp)[info.tp_dim]
    return full.reshape(info.shape).narrow(info.tp_dim, tp_rank * w,
                                           w).reshape(-1)


def init_chunk(info: ParamInfo, gen: torch.Generator, topo: MeshTopo,
               device: torch.device) -> torch.Tensor:
    """This rank's f32 master chunk: every rank draws the same full tensor
    from a CPU generator (so a seed gives the same weights on any device)
    and keeps its own slice."""
    full = _init_full(info, gen, topo.tp,
                      topo.tp_rank if topo.tp > 1 else 0)
    full = torch.nn.functional.pad(full, (0, info.padlen(topo.tp, topo.dp)
                                          - full.shape[0]))
    c = info.chunklen(topo.tp, topo.dp)
    return full[topo.rank * c:(topo.rank + 1) * c].to(device, copy=True)


def init_sync_state(info: ParamInfo, cfg: SyncConfig, topo: MeshTopo,
                    device: torch.device) -> torch.Tensor:
    """This rank's compressor state for one param ((padlen,) or dummy)."""
    if info.loco and cfg.needs_state():
        return torch.zeros(info.padlen(topo.tp, topo.dp),
                           dtype=loco_lib.state_dtype(cfg), device=device)
    return torch.zeros(1, dtype=torch.float32, device=device)


def bucket_state_struct(b) -> tuple[int, torch.dtype]:
    """(length, dtype) of one bucket's (or state unit's) stored compressor
    state: its full ``(seg_elems,)`` segment in the codec's state dtype,
    or a ``(1,)`` f32 dummy when stateless."""
    if b.sync.needs_state():
        return b.seg_elems, loco_lib.state_dtype(b.sync)
    return 1, torch.float32


def state_units(pplan: ParamPlan, coalesce: bool = True):
    """The state-leaf units of one param's stored train state.

    The coalesced runtime stores ONE buffer per encode run, expressed as
    :class:`~repro_torch.core.buckets.Bucket`-like units spanning the run's
    members (under a uniform policy: one per parameter, the monolithic
    layout); ``coalesce=False`` keeps one leaf per bucket.
    """
    if not coalesce:
        return pplan.buckets
    D = pplan.buckets[0].seg_elems // pplan.buckets[0].chunk_elems
    return tuple(
        dataclasses.replace(pplan.buckets[run.positions[0]],
                            index=ri, offset=run.offset,
                            chunk_elems=run.chunk_total,
                            seg_elems=D * run.chunk_total)
        for ri, run in enumerate(WP.encode_runs(pplan)))


def init_sync_state_units(pplan: ParamPlan, device: torch.device,
                          coalesce: bool = True) -> tuple[torch.Tensor, ...]:
    """Per-state-unit compressor states (see :func:`state_units`)."""
    return tuple(torch.zeros(n, dtype=dt, device=device)
                 for n, dt in map(bucket_state_struct,
                                  state_units(pplan, coalesce)))


def fuse_run_states(pplan: ParamPlan, states: Sequence[torch.Tensor],
                    dp: int) -> tuple[torch.Tensor, ...]:
    """Per-bucket state buffers ``(L?, seg_b)`` -> per-encode-run
    peer-major buffers ``(L?, D * c_run)`` (stateless runs keep their
    first member's dummy)."""
    out = []
    for run in WP.encode_runs(pplan):
        if len(run.positions) == 1 or not run.sync.needs_state():
            out.append(states[run.positions[0]])
            continue
        out.append(WP.fuse_run_state(
            run, [states[pos] for pos in run.positions], dp))
    return tuple(out)


def split_run_states(pplan: ParamPlan, run_states: Sequence[torch.Tensor],
                     dp: int) -> tuple[torch.Tensor, ...]:
    """Inverse of :func:`fuse_run_states` (stateless members share the
    run's dummy)."""
    out: list = [None] * len(pplan.buckets)
    for ri, run in enumerate(WP.encode_runs(pplan)):
        rs = run_states[ri]
        if len(run.positions) == 1 or not run.sync.needs_state():
            for pos in run.positions:
                out[pos] = rs
            continue
        for pos, piece in zip(run.positions,
                              WP.split_run_state(run, rs, dp)):
            out[pos] = piece
    return tuple(out)


def _param_gen(seed: int, name: str, layer: int) -> torch.Generator:
    key = (seed * 1_000_003 + (zlib.crc32(name.encode()) & 0x7FFFFFFF)
           + 7919 * layer) & 0x7FFFFFFFFFFFFFFF
    return torch.Generator().manual_seed(key)


def init_train_state(groups: Sequence[ParamGroup], cfg: SyncConfig,
                     topo: MeshTopo, device: torch.device, seed: int,
                     plan: SyncPlan | None = None, coalesce: bool = True):
    """Returns (chunks, states): {group: {name: tensor}} per-rank storage
    (stacked groups carry a leading layer axis).

    With a ``plan``, each loco param's state is a tuple of per-unit states:
    one per encode run under ``coalesce``, one per bucket otherwise (see
    :func:`state_units`), each stacked over layers like the chunk.
    """
    drawn = _draw_chunks(groups, topo, device, seed)
    chunks, states = {}, {}
    for g in groups:
        cg, sg = {}, {}
        for info in g.infos:
            if plan is not None and info.loco:
                s = init_sync_state_units(plan.lookup(g.name, info.name),
                                          device, coalesce)
            else:
                s = init_sync_state(info, cfg, topo, device)
            if g.stacked:
                cg[info.name] = torch.stack([
                    drawn.pop((g.name, info.name, l))
                    for l in range(g.n_layers)])
                sg[info.name] = (
                    tuple(torch.stack([u] * g.n_layers) for u in s)
                    if isinstance(s, tuple)
                    else torch.stack([s] * g.n_layers))
            else:
                cg[info.name] = drawn.pop((g.name, info.name, 0))
                sg[info.name] = s
        chunks[g.name], states[g.name] = cg, sg
    return chunks, states


INIT_THREADS = 8


def _pool(n_jobs: int):
    """The draws' executor: a pool of host threads, or the calling
    thread (the builtin ``map``) while a dispatch mode is active (a
    fake-tensor dry run's modes are thread-local: a pool thread would
    draw real tensors)."""
    if _get_current_dispatch_mode() is not None:
        return contextlib.nullcontext(types.SimpleNamespace(map=map))
    workers = min(INIT_THREADS, os.cpu_count() or 1, n_jobs)
    return concurrent.futures.ThreadPoolExecutor(max(workers, 1))


def _draw_chunks(groups: Sequence[ParamGroup], topo: MeshTopo,
                 device: torch.device, seed: int) -> dict:
    """``{(group, name, layer): chunk}`` of every tensor (and layer) of
    ``groups``, drawn on a pool of host threads: each draw has its own
    generator (``_param_gen``), so the bits do not depend on the order,
    and a large model's CPU draws overlap."""
    jobs = [(g.name, info, l) for g in groups for info in g.infos
            for l in range(g.n_layers or 1)]

    def draw(job):
        gname, info, l = job
        return init_chunk(info, _param_gen(seed, f"{gname}/{info.name}", l),
                          topo, device)

    with _pool(len(jobs)) as ex:
        out = list(ex.map(draw, jobs))
    return {(gname, info.name, l): c for (gname, info, l), c in zip(jobs,
                                                                   out)}


# ---------------------------------------------------------------------------
# chunk -> logical tensor
# ---------------------------------------------------------------------------

def materialize(chunk: torch.Tensor, state, info: ParamInfo,
                cfg: SyncConfig, topo: MeshTopo,
                compute_dtype: torch.dtype = torch.bfloat16,
                step: int | None = None, pplan: ParamPlan | None = None,
                coalesce: bool = True, overlap: bool = False,
                probe: torch.Tensor | None = None) -> torch.Tensor:
    """f32 chunk -> logical bf16 tensor (FSDP gather with the LoCo backward),
    inside the ``loco/gather`` range.

    With a ``pplan`` the backward runs the bucketed schedule: under
    ``coalesce`` (default) ``state`` is the run-space tuple and the exchange
    is packed per comm group, pipelined over the plan's overlap stages
    with ``overlap``; otherwise ``state`` is the per-bucket tuple and every
    bucket syncs on its own (``overlap`` has nothing to pipeline there).

    ``probe`` (fidelity-probe steps): an f32 ``(K, chunklen)`` buffer the
    backward adds the reference stack into (fp params take none).  It
    requires ``overlap=False``: the probe runs the flat schedule, which
    gives the pipelined one's bits.
    """
    if probe is not None and overlap:
        raise ValueError("fidelity probe runs the flat (non-overlapped) "
                         "schedule")
    axes = topo.axes or None
    with PROF.phase("gather"):
        w = chunk.to(compute_dtype)
        if info.loco and pplan is not None and coalesce:
            flat = gather_with_sync_runs(w, state, pplan, topo.group,
                                         step=step, overlap=overlap,
                                         axes=axes, probe=probe)
        elif info.loco and pplan is not None:
            flat = gather_with_sync_buckets(w, state, pplan, topo.group,
                                            coalesce=False, step=step,
                                            axes=axes, probe=probe)
        elif info.loco:
            flat = gather_with_sync(w, state, cfg, topo.group, step=step,
                                    axes=axes, probe=probe)
        else:
            flat = gather_fp(w, topo.group)
        n = info.numel_local(topo.tp)
        t = flat[:n].reshape(info.local_shape(topo.tp))
        if info.tp_dim is None and topo.tp > 1:
            # a leaf every model rank holds whole: psum its gradient over
            # the model group, so the sync sees the full gradient
            t = replicated_grad_psum(t, topo.model)
        return t


class TrainStore:
    """Bridges flat master chunks + sync states to model-visible tensors.

    ``chunks[group][name]`` is a chunk tensor, or for a stacked group a
    sequence with one chunk per layer (the autograd leaves of a step);
    ``states`` holds the per-rank compressor states (a tuple per planned
    param, see :func:`init_train_state`), which the backward updates in
    place.  ``plan``: the bucketed sync plan (None = monolithic sync per
    param); ``coalesce``: its packed exchange (run-space states) or one
    sync per bucket (bucket-space states); ``overlap``: the packed
    exchange pipelined over each param's overlap stages (the same bits
    and the same state layout).  ``probe``: the fidelity-probe buffers,
    ``{group: {name: (L?, K, chunklen) f32}}`` for the loco params, each
    handed (or its layer's slice) to the param's gather
    (:func:`materialize` refuses it with ``overlap``, as the reference
    does).
    """

    def __init__(self, groups, chunks, states, cfg: SyncConfig,
                 topo: MeshTopo, compute_dtype: torch.dtype = torch.bfloat16,
                 step: int | None = None, plan: SyncPlan | None = None,
                 coalesce: bool = True, overlap: bool = False,
                 probe: dict | None = None):
        self.groups = {g.name: g for g in groups}
        self.chunks = chunks
        self.states = states
        self.cfg = cfg
        self.topo = topo
        self.compute_dtype = compute_dtype
        self.step = step
        self.plan = plan
        self.coalesce = coalesce
        self.overlap = overlap
        self.probe = probe

    def _probe(self, gname, info, l=None):
        if self.probe is None or not info.loco:
            return None
        buf = self.probe[gname][info.name]
        return buf if l is None else buf[l]

    def _materialize(self, gname, info, chunk, state, probe=None):
        pplan = (self.plan.lookup(gname, info.name)
                 if self.plan is not None and info.loco else None)
        return materialize(chunk, state, info, self.cfg, self.topo,
                           self.compute_dtype, step=self.step, pplan=pplan,
                           coalesce=self.coalesce, overlap=self.overlap,
                           probe=probe)

    def group(self, gname: str) -> dict[str, torch.Tensor]:
        g = self.groups[gname]
        if g.stacked:
            raise ValueError(f"group {gname!r} is stacked: use layer()")
        return {i.name: self._materialize(gname, i, self.chunks[gname][i.name],
                                          self.states[gname][i.name],
                                          self._probe(gname, i))
                for i in g.infos}

    def layer(self, gname: str, l: int) -> dict[str, torch.Tensor]:
        """Layer ``l`` of a stacked group (``materialize_slice``)."""
        g = self.groups[gname]
        out = {}
        for i in g.infos:
            s = self.states[gname][i.name]
            s = tuple(u[l] for u in s) if isinstance(s, tuple) else s[l]
            out[i.name] = self._materialize(
                gname, i, self.chunks[gname][i.name][l], s,
                self._probe(gname, i, l))
        return out


# ---------------------------------------------------------------------------
# serving: logical TP-local bf16 tensors (no FSDP, no sync)
# ---------------------------------------------------------------------------

def serve_param_shapes(groups: Sequence[ParamGroup],
                       tp: int) -> dict[str, dict[str, tuple]]:
    """``{group: {name: shape}}`` of a rank's serving tensors: the
    TP-local shape, with a leading layer axis for stacked groups."""
    return {g.name: {i.name: ((g.n_layers,) if g.stacked else ())
                     + i.local_shape(tp) for i in g.infos} for g in groups}


def count_params(groups: Sequence[ParamGroup]) -> int:
    """Logical parameters of ``groups`` (every layer of a stacked
    group), whatever the tp and dp cut: the reference's count."""
    n = 0
    for g in groups:
        mult = g.n_layers if g.stacked else 1
        for info in g.infos:
            n += mult * math.prod(info.shape)
    return n


def init_serve_params(groups: Sequence[ParamGroup], tp: int, tp_rank: int,
                      device: torch.device, seed: int) -> dict:
    """A rank's serving tensors (:func:`serve_param_shapes`), drawn as
    :func:`init_train_state` draws the master chunks (the same generator
    per tensor and layer, on a pool of host threads) and cast to bf16: a
    seed gives the train run's weights."""
    shapes = serve_param_shapes(groups, tp)
    out = {g.name: {i.name: torch.empty(shapes[g.name][i.name],
                                        dtype=torch.bfloat16, device=device)
                    for i in g.infos}
           for g in groups}
    jobs = [(g, info, l) for g in groups for info in g.infos
            for l in range(g.n_layers or 1)]

    def draw(job):
        g, info, l = job
        t = _init_full(info, _param_gen(seed, f"{g.name}/{info.name}", l),
                       tp, tp_rank)
        return t.reshape(info.local_shape(tp)).to(torch.bfloat16)

    with _pool(len(jobs)) as ex:
        for (g, info, l), t in zip(jobs, ex.map(draw, jobs)):
            dst = out[g.name][info.name]
            (dst[l] if g.stacked else dst).copy_(t)
    return out


class ServeStore:
    """The :class:`TrainStore` interface (``group``, ``layer``) over a
    rank's bf16 serving tensors ``{group: {name: tensor}}`` (stacked groups
    with a leading layer axis)."""

    def __init__(self, groups, tensors):
        self.groups = {g.name: g for g in groups}
        self.tensors = tensors

    def group(self, gname: str) -> dict[str, torch.Tensor]:
        if self.groups[gname].stacked:
            raise ValueError(f"group {gname!r} is stacked: use layer()")
        return dict(self.tensors[gname])

    def layer(self, gname: str, l: int) -> dict[str, torch.Tensor]:
        return {name: t[l] for name, t in self.tensors[gname].items()}
