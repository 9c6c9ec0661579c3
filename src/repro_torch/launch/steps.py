"""Train-state init and the train step.

Port of ``repro.launch.steps.make_train_step`` with the monolithic sync or
the bucketed one (``RunConfig.bucket_bytes``/``policy``/``coalesce``, and
``overlap``, the reference's default pipelined stage schedule):

  FSDP flat-param chunks (core/flatparam) -> per-layer gather with the LoCo
  backward (core/hijack) -> model forward/backward -> microbatch
  accumulation (one sync per microbatch backward, like PyTorch FSDP) ->
  TP-aware global grad-norm clip -> sharded optimizer -> error reset
  (Eqn. 7).

At ``tp > 1`` the model runs tensor parallelism over the ``model`` group,
and sequence parallelism too where tp divides the sequence; every rank of
one data index trains on the same rows, and the norm and the loss are
reduced over the world.
Every division of the step's data by a count (microbatches, ranks, tp) is
one IEEE division on any device (``comm.divide``).

Under ``RunConfig.telemetry`` the step also computes the reference's
compression-health metrics (``telemetry/metrics``) from the pre-clip
synced gradients, the pre-reset error states and the update, and sends
their sums with the loss in its one all-reduce.

Each step makes the f32 master chunks autograd leaves (one per layer for
stacked groups, so each layer's synced shard lands in its own ``.grad``),
runs the microbatches, and writes the new chunks, optimizer moments and
(reset) error states back into the :class:`TrainState`.  The compressor
states are updated in place by each backward.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import buckets as BK
from repro_torch.core import codec as codec_lib
from repro_torch.core import flatparam as FP
from repro_torch.core import loco as loco_lib
from repro_torch.core import policy as POL
from repro_torch.core import wirepack as WP
from repro_torch.core.comm import divide
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig, maybe_reset
from repro_torch.models.transformer import DecoderLM, build_groups
from repro_torch.optim import optimizers as OPT
from repro_torch.optim.schedules import make_schedule
from repro_torch.telemetry import metrics as METRICS
from repro_torch.telemetry import profiler as PROF


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The fields of the reference's ``RunConfig`` that the port reads."""

    sync: SyncConfig = dataclasses.field(default_factory=SyncConfig)
    optimizer: str = "adam"
    lr: float = 3e-4
    schedule: str = "cosine"
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatch: int = 1          # per-rank microbatch size
    remat: bool = True
    # Bucketed sync scheduler (core/buckets + core/policy).  bucket_bytes > 0
    # partitions every loco param's gradient into size-targeted buckets;
    # `policy` resolves per-bucket wire configs (None = every bucket uses
    # `sync`).  Both unset = the monolithic path.
    bucket_bytes: int = 0
    policy: "POL.SyncPolicy | None" = None
    # Coalesced wire exchange (core/wirepack): one packed collective per
    # comm group per sync instead of one per bucket; the same bits.
    coalesce: bool = True
    # Backward-overlapped stage schedule (core/wirepack
    # build_overlap_schedule): each coalesced plan's sync runs as up to two
    # readiness-ordered stages whose asynchronous collectives overlap the
    # next stage's encode.  The same bits and state layout as the flat
    # schedule (off: --no-overlap); only coalesced bucketed plans change.
    overlap: bool = True
    # Compression-health metrics (telemetry/metrics): per-unit error
    # norms, saturation rates and scale stats beside the loss.  No
    # collective of their own: the packed vector rides the loss's one
    # all-reduce.
    telemetry: bool = False

    def wants_buckets(self) -> bool:
        return self.bucket_bytes > 0 or self.policy is not None


def build_sync_plan(run: RunConfig, groups,
                    topo: MeshTopo) -> "BK.SyncPlan | None":
    """Resolve RunConfig's bucketing knobs into a static SyncPlan."""
    if not run.wants_buckets():
        return None
    pol = run.policy if run.policy is not None else POL.uniform(run.sync)
    bcfg = BK.BucketConfig(
        target_bytes=run.bucket_bytes or BK.DEFAULT_TARGET_BYTES)
    return BK.make_sync_plan(groups, topo, bcfg, pol)


def state_fingerprint(run: RunConfig, groups, topo: MeshTopo,
                      plan: "BK.SyncPlan | None") -> dict:
    """Layout fingerprint of this run's train state, built from the
    *target* plan before any restore, so the checkpoint layer can compare
    it against the stored one and reshard (or fail loudly).  The state
    units follow ``run.coalesce``; the overlap schedule changes nothing.
    Equal, as JSON, to the reference's fingerprint of the same run (which
    adds a ``moe_a2a`` key only for ``block8+ef``, refused in the port)."""
    from repro_torch.state import build_fingerprint

    return build_fingerprint(groups, topo, run.sync, plan,
                             coalesce=run.coalesce)


def _validate_sync_configs(run: RunConfig, plan: "BK.SyncPlan | None",
                           topo: MeshTopo) -> None:
    """Reject, when the step is built and with the bucket named, the
    configs the in-backward sync cannot honor: stochastic rounding (no
    generator reaches the backward), strategies without a wire codec,
    cadence without state or off period boundaries, and what the port has
    not ported yet (top-k, hierarchical and multi-tier sync:
    ``NotImplementedError``).  Under ``run.coalesce`` the wire-group plans
    are built here too, so a packing problem names its parameter, and
    under ``run.overlap`` the overlap schedules, which refuse cadence
    buckets on a pipelined schedule."""
    cfgs = ([(f"{p.qualname}[{b.index}]", b.sync)
             for p in plan.params for b in p.buckets]
            if plan is not None else [("sync", run.sync)])
    for where, c in cfgs:
        WP.refuse_unported(where, c)
        if c.strategy != "fp" and c.quant.stochastic_rounding:
            raise ValueError(
                f"{where}: stochastic_rounding cannot run inside the "
                "training step (the hijack backward has no generator to "
                "thread; it would silently round to nearest). Use the "
                "post-grad dist_sync/sim_sync with an explicit generator, "
                "or disable stochastic_rounding.")
        if c.strategy != "fp" and c.strategy not in codec_lib.CODECS:
            raise ValueError(
                f"{where}: strategy {c.strategy!r} has no wire codec and "
                "cannot run in the training step (ef21 needs a "
                "receiver-side mean-estimate shard; use the post-grad "
                f"loco.sim_sync). Registered: {sorted(codec_lib.CODECS)}.")
        try:
            loco_lib.validate_cadence(c)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from None
    if plan is not None and run.coalesce:
        for p in plan.params:
            try:
                WP.build_group_plan(p, topo.dp)
                if run.overlap:
                    sched = WP.build_overlap_schedule(p, topo.dp)
                    if sched.pipelined:
                        for b in p.buckets:
                            if b.sync.every > 1:
                                raise ValueError(
                                    f"bucket {b.index} (tier 0): sync "
                                    f"cadence every={b.sync.every} cannot "
                                    "ride the pipelined overlap schedule "
                                    "(a stage piece cannot gate the whole "
                                    "run's accumulator); launch with "
                                    "--no-overlap.")
            except ValueError as e:
                raise ValueError(f"{p.qualname}: {e}") from None


def groups_inflight(run: RunConfig, plan: "BK.SyncPlan | None",
                    topo: MeshTopo) -> int:
    """Pipeline depth of this run's sync schedule, for the telemetry
    stream's step records: 1 for one sync region; under ``run.overlap``
    at most two stages' buffers are in flight, so min(2, max stages) over
    the plan's params."""
    if plan is None or not (run.coalesce and run.overlap):
        return 1
    depth = 1
    for p in plan.params:
        sched = WP.build_overlap_schedule(p, topo.dp)
        depth = max(depth, min(2, sched.n_stages))
    return depth


@dataclasses.dataclass
class TrainState:
    """One rank's train state: ``{group: {name: tensor}}`` trees of master
    chunks, compressor states and the optimizer's chunk-mirroring trees."""

    chunks: dict
    states: dict
    opt: tuple


def _make_opt(run: RunConfig) -> OPT.Optimizer:
    """The reference's rule: ``adafactor`` runs as ``adafactor_flat``
    (factored statistics need the logical shapes the flat chunks erase),
    and only adam, adamw and lamb take the run's weight decay."""
    name = run.optimizer
    if name == "adafactor":
        name = "adafactor_flat"
    kw = {}
    if name in ("adam", "adamw", "lamb"):
        kw["weight_decay"] = run.weight_decay
    return OPT.OPTIMIZERS[name](**kw)


def make_init(cfg: ArchConfig, run: RunConfig, topo: MeshTopo,
              device: torch.device, seed: int = 0) -> TrainState:
    groups = build_groups(cfg, topo.tp)
    chunks, states = FP.init_train_state(
        groups, run.sync, topo, device, seed,
        plan=build_sync_plan(run, groups, topo), coalesce=run.coalesce)
    return TrainState(chunks, states, _make_opt(run).init(chunks))


def reset_states(states: dict, step: int, groups, run: RunConfig,
                 plan: "BK.SyncPlan | None") -> dict:
    """Error reset (Eqn. 7) per state unit, each under its own resolved
    config (under the coalesced runtime a unit is one encode run, whose
    members share one config); the dummy states of non-loco params are
    left alone."""
    out = {}
    for g in groups:
        og = {}
        for info in g.infos:
            s = states[g.name][info.name]
            if plan is not None and info.loco:
                pp = plan.lookup(g.name, info.name)
                og[info.name] = tuple(
                    maybe_reset(sb, step, u.sync)
                    for sb, u in zip(s, FP.state_units(pp, run.coalesce)))
            elif info.loco:
                og[info.name] = maybe_reset(s, step, run.sync)
            else:
                og[info.name] = s
        out[g.name] = og
    return out


def _leaves(chunks: dict, groups) -> dict:
    """Autograd leaves over the master chunks, sharing their storage: one
    per tensor, one per layer for stacked groups."""
    out = {}
    for g in groups:
        og = {}
        for info in g.infos:
            c = chunks[g.name][info.name]
            rows = list(c) if g.stacked else [c]
            leaves = [r.detach().requires_grad_() for r in rows]
            og[info.name] = leaves if g.stacked else leaves[0]
        out[g.name] = og
    return out


def _grads(leaves: dict, groups, accum: int) -> dict:
    out = {}
    for g in groups:
        og = {}
        for info in g.infos:
            lv = leaves[g.name][info.name]
            grad = torch.stack([l.grad for l in lv]) if g.stacked else lv.grad
            og[info.name] = divide(grad, accum)
        out[g.name] = og
    return out


def make_train_step(cfg: ArchConfig, run: RunConfig, topo: MeshTopo,
                    device: torch.device, shape: ShapeConfig):
    """Returns ``step_fn(state, step, batch) -> metrics``.

    ``batch["tokens"]`` is the global ``(global_batch, seq_len + 1)`` batch;
    each rank trains on its ``global_batch / dp`` rows in microbatches of
    ``run.microbatch`` (the ranks of one data index, the same rows).
    ``metrics`` holds 0-dim tensors ``loss`` (the total loss, router
    losses included, mean over the dp x tp ranks), ``gnorm`` (pre-clip
    global norm) and ``lr``; MoE models add ``moe_aux`` and ``moe_z``, the
    router losses summed over layers, which ride the loss's one all-reduce
    and are divided by dp * tp like it.  Under ``run.telemetry`` the
    metrics of ``telemetry/metrics.metric_keys`` join them (0-dim CPU
    tensors): their sums ride the same all-reduce, undivided, and are
    finalized on the host.
    """
    model = DecoderLM(cfg, topo.tp, model_group=topo.model, sp=True)
    moe_metrics = bool(cfg.n_experts)
    groups = model.groups()
    opt = _make_opt(run)
    sched = make_schedule(run.schedule, run.lr, run.total_steps,
                          run.warmup_steps)
    sync = run.sync
    plan = build_sync_plan(run, groups, topo)
    _validate_sync_configs(run, plan, topo)
    if shape.global_batch % topo.dp:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over dp={topo.dp}")
    local_batch = shape.global_batch // topo.dp
    micro = min(run.microbatch, local_batch)
    if local_batch % micro:
        raise ValueError(f"local batch {local_batch} is not a multiple of "
                         f"the microbatch {micro}")
    accum = local_batch // micro
    mask = {g.name: {i.name: 1.0 if i.decay else 0.0 for i in g.infos}
            for g in groups}
    munits = (METRICS.metric_units(groups, sync, plan, topo, run.coalesce)
              if run.telemetry else ())

    def step_fn(ts: TrainState, step: int, batch: dict) -> dict:
        rows = batch["tokens"][topo.rank * local_batch:
                               (topo.rank + 1) * local_batch]
        mbs = rows.to(device).reshape(accum, micro, -1)
        leaves = _leaves(ts.chunks, groups)
        losses, mvs = [], []
        for i in range(accum):
            store = FP.TrainStore(groups, leaves, ts.states, sync, topo,
                                  step=step, plan=plan,
                                  coalesce=run.coalesce,
                                  overlap=run.overlap)
            loss, aux = model.loss_fn(store, {"tokens": mbs[i]},
                                      remat=run.remat)
            loss.backward()
            losses.append(loss.detach())
            if moe_metrics:
                mvs.append(torch.stack([aux["aux"], aux["z"]]).detach())
        grads = _grads(leaves, groups, accum)
        del leaves

        # ---- global grad-norm clip (TP replication-aware) -------------------
        local_sq = torch.zeros((), dtype=torch.float32, device=device)
        for g in groups:
            for info in g.infos:
                s2 = torch.sum(grads[g.name][info.name] ** 2)
                if info.tp_dim is None and topo.tp > 1:
                    s2 = divide(s2, topo.tp)  # every model rank holds it
                local_sq = local_sq + s2
        dist.all_reduce(local_sq, group=topo.world)
        gnorm = torch.sqrt(local_sq)
        if run.telemetry:
            # the pre-clip synced gradients and the pre-reset states
            with PROF.phase("metrics"):
                mrows = METRICS.unit_rows(munits, grads, ts.states, topo.tp,
                                          device)
        if run.clip_norm:
            cs = torch.clamp(run.clip_norm / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
            grads = OPT.tree_map(lambda g: g * cs, grads)

        lr = sched(step)
        chunks = ts.chunks
        with PROF.phase("apply"):
            ts.chunks, ts.opt = opt.update(grads, ts.opt, chunks,
                                           torch.tensor(step), lr, mask)
        mvec = None
        if run.telemetry:
            with PROF.phase("metrics"):
                mvec = torch.cat(mrows + [METRICS.global_tail(
                    chunks, ts.chunks, groups, topo.tp, device)])
        del chunks
        ts.states = reset_states(ts.states, step + 1, groups, run, plan)

        # microbatch means: summed in order, then divided (jnp.mean)
        parts = [divide(sum(losses[1:], losses[0]), accum)[None]]
        if moe_metrics:
            parts.append(divide(sum(mvs[1:], mvs[0]), accum))  # aux, z
        n_mean = sum(p.numel() for p in parts)
        if mvec is not None:
            parts.append(mvec)
        packed = torch.cat(parts)
        dist.all_reduce(packed, group=topo.world)
        # the loss and router losses are means over the ranks; the metric
        # sums stay sums
        means = divide(packed[:n_mean], topo.dp * topo.tp)
        metrics = {"loss": means[0], "gnorm": gnorm, "lr": lr}
        if moe_metrics:
            metrics["moe_aux"], metrics["moe_z"] = means[1], means[2]
        if mvec is not None:
            metrics.update(METRICS.finalize(packed[n_mean:].cpu(), munits))
        return metrics

    return step_fn
