"""Wire-traffic accounting for the bucketed sync scheduler.

Port of ``repro.telemetry.wire`` without its tier rows: predicts, from a
static :class:`~repro_torch.core.buckets.SyncPlan`, what each rank puts on
the wire per sync, from each strategy's ``codec.wire_shapes`` (so the
prediction byte-matches the encode's output tensors), and how many
collectives the coalesced and the per-bucket schedules launch; the MoE
activation wire's bytes per step (:func:`moe_a2a_report`); and the decoded
error-feedback norms of a train state.  The training CLI prints
:func:`format_report` of its plan and :func:`format_moe_a2a` at startup,
and writes :meth:`WireReport.record` into the telemetry stream.

Conventions (the reference's): byte counts are per rank per sync of one
parameter instance, times ``layers`` for stacked groups; ``fp`` buckets
count the bf16 reduce-scatter wire (2 bytes per element).  At ``tp > 1``
the plan is built from a rank's TP-local tensors, so the report gives
what that rank sends over its data group.  The port's dp
group is one flat group (one pod); hierarchical, multi-tier and top-k
buckets, and with them the reference's DCN/WAN split and tier legs, are
not ported yet (ROADMAP item 11) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.core import codec as codec_lib
from repro_torch.core import quantizer as Q
from repro_torch.core import wirepack as WP
from repro_torch.core.act_comm import a2a_geometry
from repro_torch.core.buckets import Bucket, ParamPlan, SyncPlan
from repro_torch.core.loco import SyncConfig, state_dtype
from repro_torch.telemetry import sink


def payload_bytes(n_elems: int, cfg: SyncConfig) -> int:
    """Bytes of the quantized payload for an ``(n_elems,)`` segment."""
    if cfg.strategy == "fp":
        return 2 * n_elems                      # bf16 reduce-scatter wire
    WP.refuse_unported("payload_bytes", cfg)
    return codec_lib.get_codec(cfg).wire_shapes(n_elems)["payload"].nbytes


def scale_bytes(n_elems: int, cfg: SyncConfig, dp: int = 1) -> int:
    """Bytes of the metadata leaves exchanged beside the payload (``gather``
    leaves count once per peer: each rank receives ``dp`` of them)."""
    if cfg.strategy == "fp":
        return 0
    WP.refuse_unported("scale_bytes", cfg)
    shapes = codec_lib.get_codec(cfg).wire_shapes(n_elems)
    return sum(leaf.nbytes * (dp if leaf.comm == "gather" else 1)
               for name, leaf in shapes.items() if name != "payload")


def effective_wire_bytes(n_elems: int, cfg: SyncConfig, dp: int = 1) -> int:
    """Meaningful wire bytes per sync; for the dense codecs the port has,
    payload plus scales."""
    return payload_bytes(n_elems, cfg) + scale_bytes(n_elems, cfg, dp=dp)


def state_bytes(n_elems: int, cfg: SyncConfig) -> int:
    """Resident bytes of the per-rank compressor state (not wire)."""
    if not cfg.needs_state():
        return 0
    return n_elems * state_dtype(cfg).itemsize


def flat_stage_bytes(n_elems: int, cfg: SyncConfig,
                     dp: int, dd: int) -> tuple[int, int]:
    """(intra-pod, inter-pod) attribution of a flat exchange's wire bytes:
    of the ``dp`` all-to-all rows (and gather copies) ``dd`` stay in the
    pod.  ``none`` leaves count as resident (intra-pod)."""
    if cfg.strategy == "fp":
        total = 2 * n_elems
        return total * dd // dp, total * (dp - dd) // dp
    WP.refuse_unported("flat_stage_bytes", cfg)
    ici = dcn = 0
    for leaf in codec_lib.get_codec(cfg).wire_shapes(n_elems).values():
        if leaf.comm == "split":
            per_row = leaf.nbytes // dp
            ici += per_row * dd
            dcn += per_row * (dp - dd)
        elif leaf.comm == "gather":
            ici += leaf.nbytes * dd
            dcn += leaf.nbytes * (dp - dd)
        else:
            ici += leaf.nbytes
    return ici, dcn


def _exchanged_leaves(cfg: SyncConfig, n_elems: int) -> int:
    """Wire leaves that cross the network (``none`` leaves don't)."""
    return sum(1 for leaf in codec_lib.get_codec(cfg).wire_shapes(n_elems)
               .values() if leaf.comm != "none")


def bucket_launches(b: Bucket) -> int:
    """Collectives one bucket issues per sync on the reference's
    un-coalesced schedule: one per exchanged wire leaf (one reduce-scatter
    for ``fp``).  The port's own ``coalesce=False`` oracle packs a bucket's
    ``split`` leaves into one all-to-all, so it launches fewer."""
    if b.sync.strategy == "fp":
        return 1
    WP.refuse_unported("bucket_launches", b.sync)
    return _exchanged_leaves(b.sync, b.seg_elems)


def plan_launches(plan: SyncPlan) -> dict[str, int]:
    """Collective launches per optimizer step and sync (each microbatch
    backward syncs once), trip-weighted by stacked-group ``layers``:
    ``per_bucket`` on the un-coalesced schedule, ``coalesced`` under the
    wire coalescer (one per comm group), ``comm_groups`` the packed buffers
    (equal to ``coalesced`` on the port's one flat dp group), and
    ``overlapped`` under the backward-overlapped schedule, where a comm
    group cut by a stage boundary launches once per stage it spans (>=
    ``coalesced``); ``pipeline_stages`` is the deepest per-param stage
    count (1 = nothing to pipeline)."""
    per_bucket = coalesced = overlapped = 0
    stages = 1
    for pp in plan.params:
        per_bucket += pp.layers * sum(map(bucket_launches, pp.buckets))
        D = pp.buckets[0].seg_elems // pp.buckets[0].chunk_elems
        coalesced += pp.layers * WP.build_group_plan(pp, D).launches()
        sched = WP.build_overlap_schedule(pp, D)
        overlapped += pp.layers * sched.launches()
        stages = max(stages, sched.n_stages)
    return {"per_bucket": per_bucket, "coalesced": coalesced,
            "comm_groups": coalesced, "overlapped": overlapped,
            "pipeline_stages": stages}


@dataclasses.dataclass(frozen=True)
class BucketWire:
    param: str
    bucket: int
    tensor_class: str
    strategy: str
    n_elems: int         # global segment elements (= local grad slice)
    payload: int         # bytes, per rank per sync, x layers
    scales: int
    state: int
    ici: int = 0         # intra-pod bytes (== wire on one pod)
    dcn: int = 0         # inter-pod bytes
    launches: int = 0    # un-coalesced collectives per sync, x layers

    @property
    def wire(self) -> int:
        return self.payload + self.scales


@dataclasses.dataclass(frozen=True)
class WireReport:
    """Per-sync wire accounting for a whole sync plan."""

    buckets: tuple[BucketWire, ...]
    total_wire: int      # bytes per rank per sync (payload + scales)
    fp32_bytes: int      # what an uncompressed fp32 exchange would move
    bf16_bytes: int      # the 16-bit Adam baseline wire
    state_bytes: int     # resident error-state footprint per rank
    launches_per_bucket: int = 0
    launches_coalesced: int = 0
    comm_groups: int = 0
    launches_overlapped: int = 0
    pipeline_stages: int = 1

    @property
    def ratio_vs_bf16(self) -> float:
        return self.total_wire / max(self.bf16_bytes, 1)

    @property
    def ratio_vs_fp32(self) -> float:
        return self.total_wire / max(self.fp32_bytes, 1)

    def by_class(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for b in self.buckets:
            out[b.tensor_class] = out.get(b.tensor_class, 0) + b.wire
        return out

    def record(self) -> dict:
        """The reference's ``wire_report`` record (telemetry/sink
        envelope) of a one-pod plan: every byte intra-pod; no tier rows
        yet (they come with hierarchical sync, ROADMAP item 11)."""
        ici = sum(b.ici for b in self.buckets)
        dcn = sum(b.dcn for b in self.buckets)
        return {
            **sink.envelope("wire_report"),
            "total_wire_bytes": self.total_wire,
            "fp32_bytes": self.fp32_bytes,
            "bf16_bytes": self.bf16_bytes,
            "state_bytes": self.state_bytes,
            "ratio_vs_bf16": self.ratio_vs_bf16,
            "pods": 1,
            "wans": 1,
            "ici_bytes": ici,
            "dcn_bytes": dcn,
            "wan_bytes": 0,
            "bf16_dcn_bytes": 0,
            "bf16_wan_bytes": 0,
            "dcn_ratio_vs_bf16": 0.0,
            "wan_ratio_vs_bf16": 0.0,
            "tiers": [],
            "by_class": self.by_class(),
            "n_buckets": len(self.buckets),
            "launches": {"per_bucket": self.launches_per_bucket,
                         "coalesced": self.launches_coalesced,
                         "comm_groups": self.comm_groups,
                         "overlapped": self.launches_overlapped,
                         "pipeline_stages": self.pipeline_stages},
        }

    def to_json(self) -> str:
        return json.dumps(self.record(), indent=2)


def bucket_wire(param: str, tclass: str, b: Bucket,
                layers: int) -> BucketWire:
    dp = b.seg_elems // b.chunk_elems
    ici, dcn = flat_stage_bytes(b.seg_elems, b.sync, dp, dp)
    return BucketWire(
        param=param, bucket=b.index, tensor_class=tclass,
        strategy=b.sync.strategy, n_elems=b.seg_elems,
        payload=layers * payload_bytes(b.seg_elems, b.sync),
        scales=layers * scale_bytes(b.seg_elems, b.sync, dp=dp),
        state=layers * state_bytes(b.seg_elems, b.sync),
        ici=layers * ici, dcn=layers * dcn,
        launches=layers * bucket_launches(b))


def plan_report(plan: SyncPlan) -> WireReport:
    """Static wire accounting for every bucket of the plan (one pod)."""
    rows = []
    fp32 = bf16 = 0
    for pp in plan.params:
        for b in pp.buckets:
            rows.append(bucket_wire(pp.qualname, pp.tensor_class, b,
                                    pp.layers))
            fp32 += pp.layers * 4 * b.seg_elems
            bf16 += pp.layers * 2 * b.seg_elems
    launches = plan_launches(plan)
    return WireReport(
        buckets=tuple(rows),
        total_wire=sum(r.wire for r in rows),
        fp32_bytes=fp32, bf16_bytes=bf16,
        state_bytes=sum(r.state for r in rows),
        launches_per_bucket=launches["per_bucket"],
        launches_coalesced=launches["coalesced"],
        comm_groups=launches["comm_groups"],
        launches_overlapped=launches["overlapped"],
        pipeline_stages=launches["pipeline_stages"])


def format_report(rep: WireReport, max_rows: int = 12) -> str:
    """Human-readable summary for the training log."""
    lines = [
        f"wire/step/device: {rep.total_wire / 2**20:.2f} MiB "
        f"({rep.ratio_vs_bf16:.3f}x of bf16 baseline, "
        f"{rep.ratio_vs_fp32:.3f}x of fp32); "
        f"error-state: {rep.state_bytes / 2**20:.2f} MiB; "
        f"buckets: {len(rep.buckets)}",
        f"  launches/step: {rep.launches_coalesced} coalesced "
        f"({rep.comm_groups} comm groups; {rep.launches_per_bucket} "
        f"per-bucket uncoalesced; {rep.launches_overlapped} overlapped "
        f"across {rep.pipeline_stages} pipeline stages)",
    ]
    for cls, byt in sorted(rep.by_class().items()):
        lines.append(f"  class {cls:<6} {byt / 2**20:8.2f} MiB")
    rows = sorted(rep.buckets, key=lambda r: -r.wire)[:max_rows]
    for r in rows:
        lines.append(f"  {r.param}[{r.bucket}] {r.strategy:<7}"
                     f" n={r.n_elems:>10,} wire={(r.wire) / 2**10:10.1f} KiB")
    if len(rep.buckets) > max_rows:
        lines.append(f"  ... {len(rep.buckets) - max_rows} more buckets")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# MoE activation wire (ep_a2a dispatch/combine, core/act_comm)
# ---------------------------------------------------------------------------

def moe_a2a_layer_bytes(cfg, n_tokens: int, tp: int) -> dict | None:
    """Per-layer, per-direction bytes of one ep_a2a slot-buffer exchange,
    byte-matched to what ``core/act_comm`` exchanges: the packed ``(tp,
    row_bytes)`` u8 buffer (int8 payload padded to the 512 granule + one
    f32 scale per block) or, for ``fp``, the bf16 ``(tp, El, cap, d)``
    buffer.  ``n_tokens`` is the microbatch's token count (micro *
    seq_len)."""
    if not getattr(cfg, "n_experts", 0) or cfg.moe_impl != "ep_a2a":
        return None
    g = a2a_geometry(cfg, n_tokens, tp)
    bf16 = tp * g["fp_row_bytes"]
    wire = bf16 if cfg.moe_a2a_codec == "fp" else tp * g["row_bytes"]
    return {"codec": cfg.moe_a2a_codec, "cap": g["cap"],
            "exchange_bytes": wire, "bf16_exchange_bytes": bf16}


def moe_a2a_report(cfg, shape, topo, microbatch: int) -> dict | None:
    """Per-step MoE dispatch traffic (None for models without ep_a2a):
    four exchanges per layer per microbatch (dispatch and combine, forward
    and backward), times the layers and the microbatches.  Every byte
    crosses the model group, which never leaves the pod: all ICI."""
    local_batch = shape.global_batch // topo.dp
    micro = min(microbatch, local_batch)
    accum = local_batch // micro
    per = moe_a2a_layer_bytes(cfg, micro * shape.seq_len, topo.tp)
    if per is None:
        return None
    exchanges = 4 * cfg.n_layers * accum
    step = per["exchange_bytes"] * exchanges
    bf16_step = per["bf16_exchange_bytes"] * exchanges
    return {
        "codec": per["codec"], "cap": per["cap"],
        "layers": cfg.n_layers, "exchanges_per_step": exchanges,
        "exchange_bytes": per["exchange_bytes"],
        "bf16_exchange_bytes": per["bf16_exchange_bytes"],
        "per_step_bytes": step, "bf16_per_step_bytes": bf16_step,
        "ratio_vs_bf16": step / max(bf16_step, 1),
        "ici_bytes": step, "dcn_bytes": 0,
    }


def format_moe_a2a(rep: dict) -> str:
    """Training-log line for the MoE activation wire."""
    return (
        f"moe_a2a/step/device: {rep['per_step_bytes'] / 2**20:.2f} MiB "
        f"@{rep['codec']} ({rep['ratio_vs_bf16']:.3f}x of bf16 "
        f"{rep['bf16_per_step_bytes'] / 2**20:.2f} MiB); "
        f"cap={rep['cap']}, {rep['exchanges_per_step']} exchanges/step "
        f"over {rep['layers']} layers (fwd+bwd, dispatch+combine); all ICI"
    )


# ---------------------------------------------------------------------------
# decoded error-feedback norms
# ---------------------------------------------------------------------------

def decoded_error(state: torch.Tensor, cfg: SyncConfig) -> torch.Tensor:
    """This rank's error-feedback buffer in f32 (what compensates the next
    step)."""
    if not cfg.needs_state():
        return torch.zeros(1, dtype=torch.float32, device=state.device)
    if cfg.strategy == "loco":
        return Q.error_decode(state, cfg.quant)
    return state.float()


def bucket_error_sq_norms(states, pplan: ParamPlan, coalesce: bool = True):
    """Squared L2 norm of each state unit's decoded error (this rank);
    :func:`repro_torch.telemetry.metrics.error_sq_norms`."""
    from repro_torch.telemetry import metrics

    return metrics.error_sq_norms(states, pplan, coalesce)


def error_sq_norm_local(states, groups, cfg: SyncConfig,
                        plan: SyncPlan | None, tp: int = 1,
                        coalesce: bool = True) -> torch.Tensor:
    """Sum of squared decoded-error norms over every parameter of this
    rank's state tree (per state unit under a plan).  TP-replicated
    params hold the same state on every model rank, so theirs count
    ``1/tp`` (the grad-norm convention); the caller sums over the ranks
    and takes the square root."""
    from repro_torch.core.flatparam import state_units

    parts = []
    for g in groups:
        for info in g.infos:
            s = states[g.name][info.name]
            rep = 1.0 / tp if (info.tp_dim is None and tp > 1) else 1.0
            if plan is not None and info.loco:
                pp = plan.lookup(g.name, info.name)
                for sb, u in zip(s, state_units(pp, coalesce)):
                    e = decoded_error(sb, u.sync)
                    parts.append(rep * torch.sum(e.float() ** 2))
            elif info.loco and cfg.needs_state():
                e = decoded_error(s, cfg)
                parts.append(rep * torch.sum(e.float() ** 2))
    total = torch.zeros((), dtype=torch.float32,
                        device=parts[0].device if parts else None)
    for p in parts:
        total = total + p
    return total
