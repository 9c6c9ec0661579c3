"""FSDP gather with compressed-gradient backward (the "hijack").

Port of ``repro.core.hijack``'s monolithic gathers as
``torch.autograd.Function``s.  The forward is the FSDP all-gather of a flat
parameter chunk; the backward replaces the full-precision reduce-scatter
with LoCo's compensate -> quantize -> all-to-all -> dequant-mean
(:func:`repro_torch.core.comm.dist_sync`), or with the bucketed schedule of
a :class:`~repro_torch.core.buckets.ParamPlan`
(:func:`gather_with_sync_buckets`, :func:`gather_with_sync_runs`).

The reference returns the updated compensation error as the cotangent of
the error input, because a JAX function cannot write its inputs.  Here the
backward writes the new error into the state tensor in place, once per
backward (also under ``torch.utils.checkpoint``, whose recomputation reruns
the forward but not the backward): on an on-cadence step the encode kernel
writes it there directly, otherwise it is copied in; the bucketed gathers
do so per bucket or encode run.  The bf16 gradient
reaches the codec as it is and the synced shard comes back in the
gradient's dtype, so the backward adds no pass of its own over either.

The gradient-fidelity probe (``telemetry/fidelity``) passes each gather an
f32 probe buffer ``(K, chunklen)``: the backward then runs the sync's probe
form (the flat schedule) and **adds** its reference stack into the
buffer's first rows, in place, as it updates the error state; over a
step's microbatches the buffer accumulates the references as the leaf
accumulates the gradient.  The reference returns the stack as the
cotangent of an extra primal, because a JAX backward has no other way
out.  Without a buffer the backward runs exactly the non-probe code.

:func:`replicated_grad_psum` is the reference's identity whose backward
sums the gradient of a TP-replicated weight over the ``model`` group.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core.buckets import ParamPlan
from repro_torch.core.comm import (all_gather_flat, axis_size, dist_sync,
                                   dist_sync_buckets, dist_sync_runs, fp_mean,
                                   psum_scatter_flat)
from repro_torch.core.loco import SyncConfig


def _reject_stochastic_rounding(cfg: SyncConfig) -> None:
    """The backward has no generator input, so stochastic rounding cannot
    run here: fail loudly instead of silently rounding to nearest."""
    if cfg.strategy != "fp" and cfg.quant.stochastic_rounding:
        raise ValueError(
            "QuantConfig.stochastic_rounding is not supported on the "
            "in-backward hijack path (no generator reaches the backward); "
            "use dist_sync/sim_sync with an explicit generator, or disable "
            "stochastic_rounding.")


def _add_refs(probe: torch.Tensor, refs: torch.Tensor) -> None:
    """Accumulate a sync's reference stack into the first rows of its
    probe buffer (deeper buffers keep their extra rows zero)."""
    if refs.shape[0] > probe.shape[0]:
        raise ValueError(f"{refs.shape[0]} reference rows for a probe "
                         f"buffer of {probe.shape[0]}")
    probe[:refs.shape[0]].add_(refs)


class _GatherWithSync(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_chunk, state, cfg, group, step, axes, probe):
        # state (and the probe buffer) are read and written in backward
        # only: kept on ctx as they are (not saved for backward) because
        # backward updates them in place
        ctx.state, ctx.cfg, ctx.group, ctx.step = state, cfg, group, step
        ctx.axes, ctx.probe = axes, probe
        return all_gather_flat(w_chunk, group)

    @staticmethod
    def backward(ctx, g_full):
        # the synced shard is rounded to the gradient's dtype (bf16) before
        # the optimizer sees it, as in the reference
        out = dist_sync(g_full, ctx.state, ctx.cfg, ctx.group,
                        step=ctx.step, out_dtype=g_full.dtype, inplace=True,
                        axes=ctx.axes, probe=ctx.probe is not None)
        g_shard, new_state = out[0], out[1]
        if new_state is not ctx.state:
            ctx.state.copy_(new_state)
        if ctx.probe is not None:
            _add_refs(ctx.probe, out[2])
        return g_shard, None, None, None, None, None, None


def gather_with_sync(w_chunk: torch.Tensor, state: torch.Tensor,
                     cfg: SyncConfig, group,
                     step: int | None = None,
                     axes: tuple | None = None,
                     probe: torch.Tensor | None = None) -> torch.Tensor:
    """FSDP all-gather whose backward runs the configured sync strategy.

    w_chunk: (n/D,) local flat parameter chunk (bf16 on the wire)
    state:   this rank's compressor state, shape (n,) (full local-gradient
             size), updated in place by the backward.
    step:    step index for the cadence gate (None = step 0).
    axes:    the dp mesh axes a hierarchical config exchanges over
             (``comm.MeshAxis``, outermost first; None: one flat axis).
    probe:   an f32 ``(K, chunklen)`` buffer the backward adds the
             fidelity reference stack into (None: no probe).
    """
    _reject_stochastic_rounding(cfg)
    return _GatherWithSync.apply(w_chunk, state, cfg, group,
                                 0 if step is None else step, axes, probe)


class _GatherWithSyncPlan(torch.autograd.Function):
    """Gather whose backward runs ``sync``, a bucketed sync of one
    ParamPlan (:func:`~repro_torch.core.comm.dist_sync_runs` or
    ``dist_sync_buckets`` with the plan and group bound), and stores each
    unit's new state in its buffer where the encode kernel did not; with
    a probe buffer it runs the sync's probe form and adds the references
    into the buffer."""

    @staticmethod
    def forward(ctx, w_chunk, states, sync, group, step, probe):
        ctx.states, ctx.sync, ctx.step = states, sync, step
        ctx.probe = probe
        return all_gather_flat(w_chunk, group)

    @staticmethod
    def backward(ctx, g_full):
        out = ctx.sync(g_full, ctx.states, step=ctx.step,
                       out_dtype=g_full.dtype, inplace=True,
                       probe=ctx.probe is not None)
        g_shard, new_states = out[0], out[1]
        for st, ns in zip(ctx.states, new_states):
            if ns is not st:
                st.copy_(ns)
        if ctx.probe is not None:
            _add_refs(ctx.probe, out[2])
        return g_shard, None, None, None, None, None


def _reject_plan_stochastic_rounding(plan: ParamPlan) -> None:
    for b in plan.buckets:
        _reject_stochastic_rounding(b.sync)


def gather_with_sync_buckets(w_chunk: torch.Tensor, states: tuple,
                             plan: ParamPlan, group, coalesce: bool = True,
                             step: int | None = None,
                             overlap: bool = False,
                             axes: tuple | None = None,
                             probe: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """FSDP all-gather whose backward runs the bucketed sync schedule.

    w_chunk: (C,) local flat parameter chunk (C = plan.chunklen)
    states:  per-bucket compressor states, bucket b's of shape
             (seg_elems,) in its resolved state dtype (or a (1,) dummy
             when stateless), updated in place by the backward.
    coalesce: packed per-comm-group exchange (default), or one
             :func:`~repro_torch.core.comm.dist_sync` per bucket.
    overlap: pipeline the packed exchange over the plan's overlap stages
             (requires ``coalesce``; the same bits).
    axes:    as in :func:`gather_with_sync`, for hierarchical buckets.
    probe:   as in :func:`gather_with_sync` (requires ``overlap=False``).
    """
    _reject_plan_stochastic_rounding(plan)
    sync = functools.partial(dist_sync_buckets, plan=plan, group=group,
                             coalesce=coalesce, overlap=overlap, axes=axes)
    return _GatherWithSyncPlan.apply(w_chunk, tuple(states), sync, group,
                                     0 if step is None else step, probe)


def gather_with_sync_runs(w_chunk: torch.Tensor, run_states: tuple,
                          plan: ParamPlan, group,
                          step: int | None = None,
                          overlap: bool = False,
                          axes: tuple | None = None,
                          probe: torch.Tensor | None = None) -> torch.Tensor:
    """FSDP all-gather whose backward runs the coalesced bucketed schedule
    over run-space compressor states (one buffer per encode run, updated
    in place by the backward); the same result as
    :func:`gather_with_sync_buckets` in another state layout.  ``overlap``
    pipelines it within this one backward over the plan's overlap stages
    (:func:`~repro_torch.core.comm.dist_sync_runs`); ``axes`` and
    ``probe`` as in :func:`gather_with_sync` (a probe runs the flat
    schedule: ``overlap`` must be off)."""
    _reject_plan_stochastic_rounding(plan)
    sync = functools.partial(dist_sync_runs, plan=plan, group=group,
                             overlap=overlap, axes=axes)
    return _GatherWithSyncPlan.apply(w_chunk, tuple(run_states), sync, group,
                                     0 if step is None else step, probe)


class _GatherFp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_chunk, group):
        ctx.group = group
        return all_gather_flat(w_chunk, group)

    @staticmethod
    def backward(ctx, g_full):
        # bf16 wire (the paper's "16-bit Adam" baseline); mean in f32
        D = axis_size(ctx.group)
        g = psum_scatter_flat(g_full.to(torch.bfloat16), ctx.group)
        return fp_mean(g, D).to(g_full.dtype), None


def gather_fp(w_chunk: torch.Tensor, group) -> torch.Tensor:
    """Plain differentiable FSDP gather whose backward is the bf16
    reduce-scatter mean.  Used for small (non-LoCo) tensors."""
    return _GatherFp.apply(w_chunk, group)


class _SumGradsOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def replicated_grad_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``
    (the ``model`` process group).

    Wraps every weight that every tensor-parallel rank holds whole (norm
    scales, the MoE router, kv projections when kv heads < tp, ...), so
    each data-parallel rank's local gradient is the full gradient before
    LoCo sees it (the reference's ``replicated_grad_psum``).
    """
    return _SumGradsOverModel.apply(x, group)
