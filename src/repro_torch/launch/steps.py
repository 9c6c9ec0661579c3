"""Train-state init and the train step; the serving steps.

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

Under ``RunConfig.fidelity_every = N`` every step with ``step % N == N -
1`` is a probe step (``telemetry/fidelity``): it runs the flat sync
schedule (the overlapped one's bits), hands each loco gather a zero f32
probe buffer, which the backwards fill with reference stacks summed over
the microbatches, and sends the fidelity sums behind the metric sums in
the same all-reduce; the syncs' reference reduces are its only extra
collectives.  Every other step runs the code of a run without probes.

A MoE model with the ``block8+ef`` activation codec carries its combine
residuals in ``states["_moe_a2a"]["ef"]``, ``(n_layers, 1, 1, state_len)``
bf16: each microbatch's forward reads it and the step stores the new
stack after that microbatch's backward (the recomputed forward of a
remat layer reads the same stack).

Each step makes the f32 master chunks autograd leaves (one per layer for
stacked groups, so each layer's synced shard lands in its own ``.grad``),
runs the microbatches, and writes the new chunks, optimizer moments and
(reset) error states back into the :class:`TrainState`.  The compressor
states are updated in place by each backward.  Under a profiler each
microbatch's loss and backward run inside ``loco/forward`` and
``loco/backward``, the gradient mean, norm and clip inside ``loco/clip``
and the update inside ``loco/apply`` (``telemetry/profiler``), and a
step on a card adds its allocator calls to ``profiler.COUNTERS``.

Serving (the reference's ``make_prefill_step`` and ``make_decode_step``):
``make_prefill_step`` runs a prompt batch into fresh caches and returns
the last position's local logits (inside ``loco/serve/prefill``);
``make_decode_step`` steps one token through the caches and samples
greedily over the vocab shards (inside ``loco/serve/decode``).  The batch
is cut over the data ranks when it has at least dp rows and replicated
otherwise; no collective crosses dp.  The cache's window is the caller's
argument: the reference sizes it to the prompt, so that from the first
decoded token on a full-attention model attends to a sliding window of
the prompt's length (ROADMAP.md C); :func:`serve_window` sizes it to the
whole generation.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import act_comm as ACT
from repro_torch.core import buckets as BK
from repro_torch.core import codec as codec_lib
from repro_torch.core import flatparam as FP
from repro_torch.core import loco as loco_lib
from repro_torch.core import policy as POL
from repro_torch.core import wirepack as WP
from repro_torch.core.comm import divide, sum_f64
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig, maybe_reset
from repro_torch.models import common as MC
from repro_torch.models import whisper as WH
from repro_torch.models.transformer import (DecoderLM, build_groups,
                                            init_decode_state)
from repro_torch.optim import optimizers as OPT
from repro_torch.optim.schedules import make_schedule
from repro_torch.telemetry import fidelity as FID
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
    # Gradient-fidelity probe cadence (telemetry/fidelity): steps with
    # step % N == N - 1 also measure the synced gradient against the
    # exact mean; 0 = never.  The other steps are those of a run without.
    fidelity_every: int = 0

    def wants_buckets(self) -> bool:
        return self.bucket_bytes > 0 or self.policy is not None


def build_model(cfg: ArchConfig, tp: int = 1, model_group=None,
                sp: bool = False):
    """The model of ``cfg``: the encoder-decoder (whisper) or the decoder
    (every other family)."""
    if cfg.enc_dec:
        return WH.EncDecLM(cfg, tp, model_group=model_group)
    return DecoderLM(cfg, tp, model_group=model_group, sp=sp)


def model_groups(cfg: ArchConfig, tp: int):
    """The parameter declarations of ``cfg``'s model on a rank of a
    ``tp``-way model group."""
    return (WH.build_groups if cfg.enc_dec else build_groups)(cfg, tp)


def build_sync_plan(run: RunConfig, groups,
                    topo: MeshTopo) -> "BK.SyncPlan | None":
    """Resolve RunConfig's bucketing knobs into a static SyncPlan."""
    if not run.wants_buckets():
        return None
    pol = run.policy if run.policy is not None else POL.uniform(run.sync)
    bcfg = BK.BucketConfig(
        target_bytes=run.bucket_bytes or BK.DEFAULT_TARGET_BYTES)
    return BK.make_sync_plan(groups, topo, bcfg, pol)


def is_probe_step(run: RunConfig, step: int) -> bool:
    """Is ``step`` a fidelity-probe step (the last of each period)?"""
    n = run.fidelity_every
    return n > 0 and step % n == n - 1


def ef_state_len(cfg: ArchConfig, run: RunConfig, shape: ShapeConfig,
                 topo: MeshTopo) -> int:
    """Length of one layer's MoE combine EF residual (0 without one): the
    exchange of one microbatch's tokens."""
    if not ACT.wants_ef(cfg):
        return 0
    micro = min(run.microbatch, shape.global_batch // topo.dp)
    return ACT.ef_state_len(cfg, micro * shape.seq_len, topo.tp)


def state_fingerprint(run: RunConfig, groups, topo: MeshTopo,
                      plan: "BK.SyncPlan | None",
                      arch: "ArchConfig | None" = None,
                      shape: "ShapeConfig | None" = None) -> dict:
    """Layout fingerprint of this run's train state, built from the
    *target* plan before any restore, so the checkpoint layer can compare
    it against the stored one and reshard (or fail loudly).  The state
    units follow ``run.coalesce``; the overlap schedule changes nothing.
    Given ``arch`` and ``shape``, a model with the ``block8+ef`` residual
    adds its geometry under ``moe_a2a``, so a codec flip or a resize is a
    named mismatch.  Equal, as JSON, to the reference's fingerprint of the
    same run."""
    from repro_torch.state import build_fingerprint

    fp = build_fingerprint(groups, topo, run.sync, plan,
                           coalesce=run.coalesce)
    if arch is not None and shape is not None and ACT.wants_ef(arch):
        fp["moe_a2a"] = {
            "codec": arch.moe_a2a_codec,
            "layers": arch.n_layers,
            "state_len": ef_state_len(arch, run, shape, topo),
            "dtype": "bfloat16",
        }
    return fp


def _validate_sync_configs(run: RunConfig, plan: "BK.SyncPlan | None",
                           topo: MeshTopo) -> None:
    """Reject, when the step is built and with the bucket named, the
    configs the in-backward sync cannot honor: stochastic rounding (no
    generator reaches the backward), strategies without a wire codec,
    cadence without state or off period boundaries, and hierarchical
    buckets on meshes or with codecs the tiered exchange cannot serve (a
    single pod, too few mesh axes for the tiers, fp, a stateful tier
    codec, tier cadence on the coalesced exchange).  Under
    ``run.coalesce`` the wire-group plans are built here too, so a packing
    problem names its parameter, and under ``run.overlap`` the overlap
    schedules, which refuse cadence and top-k buckets on a pipelined
    schedule.  The messages are the reference's."""
    cfgs = ([(f"{p.qualname}[{b.index}]", b.sync)
             for p in plan.params for b in p.buckets]
            if plan is not None else [("sync", run.sync)])
    for where, c in cfgs:
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
        if run.fidelity_every > 0 and c.strategy != "fp" and c.every > 1:
            raise ValueError(
                f"{where}: the fidelity probe cannot meter a tier-0 sync "
                f"cadence (every={c.every}): off-cadence steps return the "
                "accumulator instead of a synced gradient, so probe "
                "references and the synced shard would describe different "
                "steps. Drop --fidelity-every or the cadence (outer-tier "
                "cadence is fine — references are taken after the tier "
                "select).")
        if c.hierarchical:
            _validate_tiers(where, c, run, plan, topo)
    if plan is not None and run.coalesce:
        pods = max(topo.pods, 1)
        for p in plan.params:
            try:
                WP.build_group_plan(p, topo.dp, pods=pods)
                if run.overlap:
                    sched = WP.build_overlap_schedule(p, topo.dp, pods=pods)
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
                            if b.sync.strategy == "topk":
                                raise ValueError(
                                    f"bucket {b.index}: ragged "
                                    "(capacity-padded) topk leaves cannot "
                                    "ride the pipelined overlap schedule's "
                                    "stage pieces; launch with "
                                    "--no-overlap.")
            except ValueError as e:
                raise ValueError(f"{p.qualname}: {e}") from None


def _validate_tiers(where: str, c: SyncConfig, run: RunConfig,
                    plan: "BK.SyncPlan | None", topo: MeshTopo) -> None:
    """The hierarchical checks of :func:`_validate_sync_configs` for one
    bucket: the mesh has one axis per exchange leg with real outer
    groups, the bucket has a wire codec, every tier codec is valid, and a
    tier cadence runs only on the monolithic exchange."""
    tiers = loco_lib.sync_schedule(c)
    if len(tiers) == 1:
        if len(topo.dp_axes) != 2 or topo.pods < 2:
            raise ValueError(
                f"{where}: hierarchical sync needs a multi-pod "
                f"(pod, data) mesh; this mesh has dp axes "
                f"{topo.dp_axes!r} with {topo.pods} pod(s) — a "
                "size-1 pod axis would pay the stage-2 "
                "requantization error for zero DCN saving. Launch "
                "with --pods >= 2 or drop the +hier policy flag.")
    elif (len(topo.dp_axes) != 1 + len(tiers) or topo.pods < 2
          or topo.wans < 2):
        raise ValueError(
            f"{where}: a {len(tiers)}-tier sync schedule needs "
            f"{1 + len(tiers)} dp mesh axes with >= 2 devices per "
            f"outer axis; this mesh has dp axes {topo.dp_axes!r} "
            f"({topo.wans} wan group(s), {topo.pods} pod(s)). "
            "Launch with --wans >= 2 and --pods >= 2, or drop the "
            "+wan policy flag.")
    if c.strategy == "fp":
        raise ValueError(
            f"{where}: hierarchical sync has no meaning for the fp "
            "reduce-scatter baseline (there is no wire codec to "
            "stage); drop +hier for this bucket.")
    for t, tier in enumerate(tiers):
        try:
            loco_lib.validate_tier_codec(tier.sync)
        except ValueError as e:
            raise ValueError(f"{where} tier {t + 1}: {e}") from None
        if tier.every > 1 and plan is not None and run.coalesce:
            raise ValueError(
                f"{where} tier {t + 1}: tier cadence "
                f"every={tier.every} is only supported on the "
                "monolithic exchange (the coalesced in-plan "
                "two-stage leg has no own-slice bypass); launch "
                "with --no-coalesce.")


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
        sched = WP.build_overlap_schedule(p, topo.dp,
                                          pods=max(topo.pods, 1))
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


def _probe_shapes(groups, sync: SyncConfig, plan: "BK.SyncPlan | None",
                  topo: MeshTopo, coalesce: bool) -> dict:
    """Probe-buffer shape per loco param: ``(L?, K, chunklen)`` f32, K the
    rows its schedule emits (3 base rows; the monolithic multi-tier sync
    one more per non-final tier; per-bucket plans the deepest bucket's;
    the coalesced schedule 3, its in-plan tiers emitting none)."""
    out = {}
    for g in groups:
        og = {}
        for info in g.infos:
            if not info.loco:
                continue
            if plan is None:
                rows = FID.probe_rows(sync)
            elif coalesce:
                rows = 3
            else:
                pp = plan.lookup(g.name, info.name)
                rows = max(FID.probe_rows(b.sync) for b in pp.buckets)
            shp = (rows, info.chunklen(topo.tp, topo.dp))
            og[info.name] = ((g.n_layers,) + shp) if g.stacked else shp
        out[g.name] = og
    return out


def make_init(cfg: ArchConfig, run: RunConfig, topo: MeshTopo,
              device: torch.device, seed: int = 0,
              shape: "ShapeConfig | None" = None) -> TrainState:
    """This rank's initial train state.  A ``block8+ef`` MoE model adds
    its zero combine residuals under ``states["_moe_a2a"]``, which are
    activation-shaped: it needs the train ``shape``."""
    groups = model_groups(cfg, topo.tp)
    chunks, states = FP.init_train_state(
        groups, run.sync, topo, device, seed,
        plan=build_sync_plan(run, groups, topo), coalesce=run.coalesce)
    if ACT.wants_ef(cfg):
        if shape is None:
            raise ValueError(
                "moe_a2a_codec='block8+ef' carries an activation-shaped "
                "error state; pass the train ShapeConfig to make_init "
                "(make_init(cfg, run, topo, device, seed, shape)).")
        states[ACT.EF_STATE_KEY] = {"ef": torch.zeros(
            (cfg.n_layers, 1, 1, ef_state_len(cfg, run, shape, topo)),
            dtype=torch.bfloat16, device=device)}
    return TrainState(chunks, states, _make_opt(run).init(chunks))


def reset_states(states: dict, step: int, groups, run: RunConfig,
                 plan: "BK.SyncPlan | None") -> dict:
    """Error reset (Eqn. 7) per state unit, each under its own resolved
    config (under the coalesced runtime a unit is one encode run, whose
    members share one config); the dummy states of non-loco params and
    the MoE combine residuals are left alone."""
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
    if ACT.EF_STATE_KEY in states:
        out[ACT.EF_STATE_KEY] = states[ACT.EF_STATE_KEY]
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


def grad_norm(grads: dict, groups, topo: MeshTopo,
              device: torch.device) -> torch.Tensor:
    """The pre-clip global gradient norm over the dp x tp ranks.  Each
    leaf's squares are summed in f64 (a replicated leaf's divided by tp
    first, as the reference orders it: every model rank holds it), the
    local total is rounded once to f32 and all-reduced, and the root is
    correctly rounded: the CPU's bits on the card."""
    local = torch.zeros((), dtype=torch.float64, device=device)
    for g in groups:
        for info in g.infos:
            x = grads[g.name][info.name]
            s2 = sum_f64(x, x)
            if info.tp_dim is None and topo.tp > 1:
                s2 = divide(s2, topo.tp)
            local = local + s2
    local_sq = local.float()
    dist.all_reduce(local_sq, group=topo.world)
    return OPT._sqrt(local_sq)


def make_train_step(cfg: ArchConfig, run: RunConfig, topo: MeshTopo,
                    device: torch.device, shape: ShapeConfig,
                    finalize: bool = True):
    """Returns ``step_fn(state, step, batch) -> metrics``.

    ``batch["tokens"]`` is the global ``(global_batch, seq_len + 1)`` batch
    (an encoder-decoder's: ``(global_batch, dec_len + 1)`` tokens and
    ``batch["frames"]``, ``(global_batch, seq_len, d_model)``); each rank
    trains on its ``global_batch / dp`` rows in microbatches of
    ``run.microbatch`` (the ranks of one data index, the same rows).
    ``metrics`` holds 0-dim tensors ``loss`` (the total loss, router
    losses included, mean over the dp x tp ranks), ``gnorm`` (pre-clip
    global norm) and ``lr``; MoE models add ``moe_aux`` and ``moe_z``, the
    router losses summed over layers, which ride the loss's one all-reduce
    and are divided by dp * tp like it.  Under ``run.telemetry`` the
    metrics of ``telemetry/metrics.metric_keys`` join them (0-dim CPU
    tensors): their sums ride the same all-reduce, undivided, and are
    finalized on the host.  A probe step (``is_probe_step``) adds the
    ``telemetry/fidelity.fidelity_keys`` the same way.  ``finalize=False``
    leaves those sums unread on the host, as ``metrics["sums"]`` (the dry
    run's fake tensors have no values to read).
    """
    model = build_model(cfg, topo.tp, model_group=topo.model, sp=True)
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
    funits, probe_shapes = (), None
    if run.fidelity_every > 0:
        funits = FID.fidelity_units(groups, sync, plan, topo, run.coalesce)
        if not funits:
            raise ValueError(
                "fidelity_every > 0 has nothing to probe: every sync unit "
                "is the fp baseline (exact by construction). Drop "
                "--fidelity-every or give at least one unit a wire codec.")
        probe_shapes = _probe_shapes(groups, sync, plan, topo, run.coalesce)
    with_ef = ACT.wants_ef(cfg)

    def step_fn(ts: TrainState, step: int, batch: dict) -> dict:
        # this rank's rows of every batch tensor, cut into microbatches
        mbs = {k: v[topo.rank * local_batch:(topo.rank + 1) * local_batch]
               .to(device).reshape(accum, micro, *v.shape[1:])
               for k, v in batch.items()}
        alloc = PROF.alloc_counts(device)
        leaves = _leaves(ts.chunks, groups)
        probe = is_probe_step(run, step)
        pbufs = None
        if probe:
            # zero reference buffers; every loco gather's backward adds
            # its stack in, summed over the microbatches
            pbufs = {gn: {n: torch.zeros(shp, dtype=torch.float32,
                                         device=device)
                          for n, shp in og.items()}
                     for gn, og in probe_shapes.items()}
        ef = (ts.states[ACT.EF_STATE_KEY]["ef"].view(cfg.n_layers, -1)
              if with_ef else None)
        losses, mvs = [], []
        for i in range(accum):
            store = FP.TrainStore(groups, leaves, ts.states, sync, topo,
                                  step=step, plan=plan,
                                  coalesce=run.coalesce,
                                  overlap=run.overlap and not probe,
                                  probe=pbufs)
            kw = {} if ef is None else {"moe_a2a_state": ef}
            with PROF.phase("forward"):
                loss, aux = model.loss_fn(store, {k: v[i] for k, v in
                                                  mbs.items()},
                                          remat=run.remat, **kw)
            # the microbatch's new residuals, stored once: the recomputed
            # forwards of the backward read the old ones
            PROF.backward(loss, None if ef is None else
                          lambda: ef.copy_(aux["moe_a2a_state"]))
            losses.append(loss.detach())
            if moe_metrics:
                mvs.append(torch.stack([aux["aux"], aux["z"]]).detach())
        with PROF.phase("clip"):
            grads = _grads(leaves, groups, accum)
            del leaves

            # ---- global grad-norm clip (TP replication-aware) ---------------
            gnorm = grad_norm(grads, groups, topo, device)
            if run.telemetry:
                # the pre-clip synced gradients and the pre-reset states
                with PROF.phase("metrics"):
                    mrows = METRICS.unit_rows(munits, grads, ts.states,
                                              topo.tp, device)
            fvec = None
            if probe:
                # the references average over the microbatches like the
                # gradient: the fidelity of the step's synced mean
                with PROF.phase("probe"):
                    for og in pbufs.values():
                        for b in og.values():
                            b.copy_(divide(b, accum))
                    fvec = FID.local_vector(funits, grads, pbufs, topo.tp,
                                            device)
                del pbufs
            if run.clip_norm:
                cs = OPT.clip_scale(gnorm, run.clip_norm)
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
        if fvec is not None:
            parts.append(fvec)
        packed = torch.cat(parts)
        dist.all_reduce(packed, group=topo.world)
        # the loss and router losses are means over the ranks; the metric
        # and fidelity sums stay sums
        means = divide(packed[:n_mean], topo.dp * topo.tp)
        metrics = {"loss": means[0], "gnorm": gnorm, "lr": lr}
        if moe_metrics:
            metrics["moe_aux"], metrics["moe_z"] = means[1], means[2]
        tail = (packed[n_mean:].cpu()
                if mvec is not None or fvec is not None else None)
        PROF.count_alloc(alloc, device)
        if not finalize:
            metrics["sums"] = tail
            return metrics
        off = 0
        if mvec is not None:
            metrics.update(METRICS.finalize(tail[:mvec.numel()], munits))
            off = mvec.numel()
        if fvec is not None:
            metrics.update(FID.finalize(tail[off:], funits))
        return metrics

    return step_fn


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_window(cfg: ArchConfig, prompt_len: int, decode_steps: int) -> int:
    """KV slots that hold a whole generation: the prompt and every decoded
    token; for an encoder-decoder the decoder's start token and its decoded
    tokens, at most ``dec_len``."""
    if cfg.enc_dec:
        return min(1 + decode_steps, cfg.dec_len)
    return prompt_len + decode_steps


def serve_rows(batch: int, topo: MeshTopo) -> slice:
    """This rank's rows of a ``batch``-row serving batch: its ``batch /
    dp`` when ``batch >= dp``, else all of them (replicated)."""
    if batch < topo.dp:
        return slice(0, batch)
    if batch % topo.dp:
        raise ValueError(f"serving batch {batch} does not split over "
                         f"dp={topo.dp}")
    n = batch // topo.dp
    return slice(topo.rank * n, (topo.rank + 1) * n)


def greedy(logits: torch.Tensor, topo: MeshTopo) -> torch.Tensor:
    """(B, V_local) local logits -> (B, 1) int64 token ids: the argmax over
    the vocab shards of the model group, the padded tail included (the
    reference's ``pmax``/``pmin``): each rank's max and first argmax (plus
    ``tp_rank * V_local``); the group's max; the least id among the
    ranks that reach it."""
    lg = logits.float()
    arg = lg.argmax(dim=-1, keepdim=True)
    if topo.tp == 1:
        return arg
    top = lg.gather(-1, arg)
    arg = arg + topo.tp_rank * lg.shape[-1]
    gmax = MC.pmax_tp(top, topo.model)
    cand = torch.where(top >= gmax, arg, torch.full_like(arg, 2**30))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=topo.model)
    return cand


def make_prefill_step(cfg: ArchConfig, topo: MeshTopo, device: torch.device,
                      *, batch: int, window: int):
    """Returns ``prefill(params, batch) -> (local logits (B_l, V_local) of
    the last position, state)``: ``params`` a rank's serving tensors
    (``flatparam.init_serve_params``), ``batch`` the global ``{"tokens":
    (batch, S)}`` (an encoder-decoder's ``{"frames": (batch, S,
    d_model)}``), ``state`` the caches with a ``window``-token KV window
    (:func:`serve_window`).  An encoder-decoder encodes the frames and
    runs its start token (0) through the decoder, as the reference does."""
    model = build_model(cfg, topo.tp, model_group=topo.model)
    groups = model.groups()
    rows = serve_rows(batch, topo)

    @torch.inference_mode()
    def prefill(params: dict, batch_in: dict):
        with PROF.phase("serve/prefill"):
            store = FP.ServeStore(groups, params)
            if cfg.enc_dec:
                frames = batch_in["frames"][rows].to(device)
                memory = model.encode(store, frames, remat=False)
                state = model.init_decode_state(memory, frames.shape[0],
                                                window)
                tok0 = torch.zeros(frames.shape[0], 1, dtype=torch.int64,
                                   device=device)
                logits, state = model.decode_step(store, state, tok0)
                return logits[:, -1], state
            tokens = batch_in["tokens"][rows].to(device)
            state = init_decode_state(cfg, topo.tp, tokens.shape[0], window,
                                      device)
            logits, state = model.prefill(store, tokens, state, last=1)
            return logits[:, -1], state

    return prefill


def make_decode_step(cfg: ArchConfig, topo: MeshTopo, device: torch.device):
    """Returns ``decode(params, state, token) -> (next token (B_l, 1),
    local logits (B_l, V_local), state)``: one token per row through the
    caches (updated in place), sampled greedily (:func:`greedy`)."""
    model = build_model(cfg, topo.tp, model_group=topo.model)
    groups = model.groups()

    @torch.inference_mode()
    def decode(params: dict, state, token: torch.Tensor):
        with PROF.phase("serve/decode"):
            store = FP.ServeStore(groups, params)
            logits, state = model.decode_step(store, state, token)
            logits = logits[:, -1]
            return greedy(logits, topo), logits, state

    return decode
