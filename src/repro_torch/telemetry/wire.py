"""Wire-traffic accounting for the bucketed sync scheduler.

Port of ``repro.telemetry.wire``: predicts, from a static
:class:`~repro_torch.core.buckets.SyncPlan`, what each rank puts on the
wire per sync, from each strategy's ``codec.wire_shapes`` (so the
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
what that rank sends over its data group.  On a multi-pod mesh (``pods >
1``) every bucket splits into intra-pod (ICI), inter-pod (DCN) and, with
a WAN axis, cross-WAN bytes: a flat bucket by the destination of each
all-to-all row, a hierarchical one by leg (stage 1 intra-pod, tier 1
across pods, tier 2 across the WAN), and the tier rows (:class:`TierWire`)
give each leg's static capacity against its count-aware, cadence-amortized
effective bytes.
"""
from __future__ import annotations

import dataclasses
import json
import math

import torch

from repro_torch.core import codec as codec_lib
from repro_torch.core import quantizer as Q
from repro_torch.core import wirepack as WP
from repro_torch.core.act_comm import a2a_geometry
from repro_torch.core.buckets import Bucket, ParamPlan, SyncPlan
from repro_torch.core.loco import SyncConfig, state_dtype, sync_schedule
from repro_torch.telemetry import sink


def payload_bytes(n_elems: int, cfg: SyncConfig) -> int:
    """Bytes of the payload for an ``(n_elems,)`` segment.  A ragged codec
    (topk) has no single ``payload`` leaf: its payload is the
    capacity-padded index and value pair, counted at full capacity (what
    crosses the wire whatever the count; :func:`effective_wire_bytes` is
    the count-aware view)."""
    if cfg.strategy == "fp":
        return 2 * n_elems                      # bf16 reduce-scatter wire
    shapes = codec_lib.get_codec(cfg).wire_shapes(n_elems)
    if "payload" in shapes:
        return shapes["payload"].nbytes
    return sum(leaf.nbytes for leaf in shapes.values() if leaf.ragged)


def scale_bytes(n_elems: int, cfg: SyncConfig, dp: int = 1) -> int:
    """Bytes of the metadata leaves exchanged beside the payload (``gather``
    leaves count once per peer: each rank receives ``dp`` of them; a
    ragged codec's count header is metadata)."""
    if cfg.strategy == "fp":
        return 0
    shapes = codec_lib.get_codec(cfg).wire_shapes(n_elems)
    return sum(leaf.nbytes * (dp if leaf.comm == "gather" else 1)
               for name, leaf in shapes.items()
               if name != "payload" and not leaf.ragged)


def effective_wire_bytes(n_elems: int, cfg: SyncConfig, dp: int = 1) -> int:
    """Meaningful wire bytes per sync.  A ragged codec pads to its static
    capacity, but only the count's worth of slots carries information:
    topk moves the u32 count plus ``topk_k`` live (u16 index, bf16 value)
    pairs per TOPK_SEL block.  Dense codecs: payload plus scales."""
    if cfg.strategy == "topk":
        u = n_elems // codec_lib.TOPK_SEL
        return u * (4 + 4 * codec_lib.topk_k(cfg))
    return payload_bytes(n_elems, cfg) + scale_bytes(n_elems, cfg, dp=dp)


def state_bytes(n_elems: int, cfg: SyncConfig) -> int:
    """Resident bytes of the per-rank compressor state (not wire)."""
    if not cfg.needs_state():
        return 0
    return n_elems * state_dtype(cfg).itemsize


def _tier_axis_sizes(n_tiers: int, pods: int, wans: int) -> tuple[int, ...]:
    """Mesh-axis size per outer tier, innermost first (tier 1 crosses the
    ``pod`` axis, tier 2 the ``wan`` axis): at most two outer tiers, the
    mesh shapes the CLI builds."""
    if n_tiers > 2:
        raise ValueError(
            f"wire accounting supports at most 2 outer sync tiers "
            f"(DCN + WAN); got a {n_tiers}-tier schedule")
    return (pods, wans)[:n_tiers]


def tier_components(n_elems: int, cfg: SyncConfig, pods: int, dd: int,
                    wans: int = 1) -> list[tuple[int, int]]:
    """(payload, scales) bytes per exchange leg of the tiered schedule,
    innermost first: leg 0 is stage 1 (the bucket's codec, intra-pod),
    then one leg per outer tier of ``sync_schedule`` (tier 1 re-encodes
    the pod means across the ``pods`` pods, tier 2 those means across the
    ``wans`` WAN groups).  Each leg's segment is the previous leg's mean
    slice (``n -> n/dd -> n/(dd*pods)``), byte-matching the tensors
    ``comm.hierarchical_sync`` exchanges on that network."""
    tiers = sync_schedule(cfg)
    sizes = _tier_axis_sizes(len(tiers), pods, wans)
    legs = [(payload_bytes(n_elems, cfg), scale_bytes(n_elems, cfg, dp=dd))]
    n_t = n_elems // dd
    for tier, P in zip(tiers, sizes):
        legs.append((payload_bytes(n_t, tier.sync),
                     scale_bytes(n_t, tier.sync, dp=P)))
        n_t //= P
    return legs


def hier_stage_components(
        n_elems: int, cfg: SyncConfig,
        pods: int, dd: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """((payload, scales) per stage) of the classic two-stage exchange:
    the first two legs of :func:`tier_components`."""
    legs = tier_components(n_elems, cfg, pods, dd)
    return legs[0], legs[1]


def hier_stage_bytes(n_elems: int, cfg: SyncConfig,
                     pods: int, dd: int) -> tuple[int, int]:
    """(stage-1 intra-pod, stage-2 inter-pod) bytes of the two-stage
    exchange."""
    (p1, s1), (p2, s2) = hier_stage_components(n_elems, cfg, pods, dd)
    return p1 + s1, p2 + s2


def flat_stage_bytes(n_elems: int, cfg: SyncConfig,
                     dp: int, dd: int) -> tuple[int, int]:
    """(intra-pod, inter-pod) attribution of a flat exchange's wire bytes:
    of the ``dp`` all-to-all rows (and gather copies) ``dd`` stay in the
    pod.  ``none`` leaves count as resident (intra-pod)."""
    if cfg.strategy == "fp":
        total = 2 * n_elems
        return total * dd // dp, total * (dp - dd) // dp
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


def _axes(pods: int, wans: int = 1) -> int:
    """dp mesh axes a flat exchange crosses in the reference (2 on a
    multi-pod mesh, 3 with a WAN axis)."""
    return 1 + (pods > 1) + (wans > 1)


def _exchanged_leaves(cfg: SyncConfig, n_elems: int) -> int:
    """Wire leaves that cross the network (``none`` leaves don't)."""
    return sum(1 for leaf in codec_lib.get_codec(cfg).wire_shapes(n_elems)
               .values() if leaf.comm != "none")


def bucket_launches(b: Bucket, pods: int = 1, wans: int = 1) -> int:
    """Collectives one bucket issues per sync on the reference's
    un-coalesced schedule: one per exchanged wire leaf per mesh axis (a
    tiered bucket's legs cross one axis each; one reduce-scatter per axis
    for ``fp``).  The port's own ``coalesce=False`` oracle packs a
    bucket's ``split`` leaves into one all-to-all over one flat group, so
    it launches fewer."""
    if b.sync.strategy == "fp":
        return _axes(pods, wans)
    if b.sync.hierarchical and pods > 1:
        tiers = sync_schedule(b.sync)
        sizes = _tier_axis_sizes(len(tiers), pods, wans)
        dd = (b.seg_elems // b.chunk_elems) // math.prod(sizes)
        count = _exchanged_leaves(b.sync, b.seg_elems)
        n_t = b.seg_elems // dd
        for tier, P in zip(tiers, sizes):
            count += _exchanged_leaves(tier.sync, n_t)
            n_t //= P
        return count
    return _axes(pods, wans) * _exchanged_leaves(b.sync, b.seg_elems)


def plan_launches(plan: SyncPlan, pods: int = 1,
                  wans: int = 1) -> dict[str, int]:
    """Collective launches per optimizer step and sync (each microbatch
    backward syncs once), trip-weighted by stacked-group ``layers``:
    ``per_bucket`` on the reference's un-coalesced schedule, ``coalesced``
    under the wire coalescer (one per comm group: each group crosses one
    process group, the flat dp group or one mesh axis's, where the
    reference's flat groups launch once per mesh axis), ``comm_groups``
    the packed buffers (equal to ``coalesced``), and ``overlapped`` under
    the backward-overlapped schedule, where a comm group cut by a stage
    boundary launches once per stage it spans (>= ``coalesced``);
    ``pipeline_stages`` is the deepest per-param stage count (1 = nothing
    to pipeline).  A plan the coalescer refuses (a multi-tier schedule,
    which only the monolithic exchange runs) launches un-coalesced, and
    counts so, with one comm group per bucket."""
    per_bucket = coalesced = groups = overlapped = 0
    stages = 1
    for pp in plan.params:
        pb = pp.layers * sum(bucket_launches(b, pods, wans)
                             for b in pp.buckets)
        per_bucket += pb
        D = pp.buckets[0].seg_elems // pp.buckets[0].chunk_elems
        try:
            gp = WP.build_group_plan(pp, D, pods=max(pods, 1))
            sched = WP.build_overlap_schedule(pp, D, pods=max(pods, 1))
        except ValueError:
            coalesced += pb
            overlapped += pb
            groups += pp.layers * len(pp.buckets)
            continue
        coalesced += pp.layers * gp.launches()
        groups += pp.layers * len(gp.groups)
        overlapped += pp.layers * sched.launches()
        stages = max(stages, sched.n_stages)
    return {"per_bucket": per_bucket, "coalesced": coalesced,
            "comm_groups": groups, "overlapped": overlapped,
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
    dcn: int = 0         # inter-pod bytes (the stage-2 wire if hierarchical)
    wan: int = 0         # cross-WAN bytes (the tier-2 wire of a 3-tier one)
    hierarchical: bool = False
    launches: int = 0    # un-coalesced collectives per sync, x layers

    @property
    def wire(self) -> int:
        return self.payload + self.scales


@dataclasses.dataclass(frozen=True)
class TierWire:
    """Capacity against effective bytes of one exchange tier, plan-wide:
    ``capacity_bytes`` is the static wire per rank per sync (what the
    fixed-geometry collective moves each time it runs),
    ``effective_bytes`` the in-band-count bytes amortized over the tier's
    cadence (per step).  Both layer-weighted."""

    tier: int                    # 0 = innermost leg, 1 = DCN, 2 = WAN
    network: str                 # "ici" | "dcn" | "wan"
    strategies: tuple[str, ...]  # codecs contributing at this tier
    every: int                   # largest sync period at this tier (steps)
    capacity_bytes: int
    effective_bytes: float

    def record(self) -> dict:
        return {"tier": self.tier, "network": self.network,
                "strategies": list(self.strategies), "every": self.every,
                "capacity_bytes": self.capacity_bytes,
                "effective_bytes": self.effective_bytes}


@dataclasses.dataclass(frozen=True)
class WireReport:
    """Per-sync wire accounting for a whole sync plan."""

    buckets: tuple[BucketWire, ...]
    total_wire: int      # bytes per rank per sync (payload + scales)
    fp32_bytes: int      # what an uncompressed fp32 exchange would move
    bf16_bytes: int      # the 16-bit Adam baseline wire
    state_bytes: int     # resident error-state footprint per rank
    pods: int = 1        # the pod axis size the ICI/DCN split is for
    wans: int = 1        # the WAN axis size (1 = no WAN tier)
    ici_bytes: int = 0
    dcn_bytes: int = 0
    wan_bytes: int = 0
    bf16_dcn_bytes: int = 0  # the bf16 baseline's inter-pod share
    bf16_wan_bytes: int = 0  # the bf16 baseline's cross-WAN share
    tiers: tuple[TierWire, ...] = ()
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

    @property
    def dcn_ratio_vs_bf16(self) -> float:
        """Inter-pod bytes against the bf16 baseline's inter-pod share."""
        return self.dcn_bytes / max(self.bf16_dcn_bytes, 1)

    @property
    def wan_ratio_vs_bf16(self) -> float:
        """Cross-WAN bytes (per sync, at capacity) against the bf16
        baseline's cross-WAN share."""
        return self.wan_bytes / max(self.bf16_wan_bytes, 1)

    def by_class(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for b in self.buckets:
            out[b.tensor_class] = out.get(b.tensor_class, 0) + b.wire
        return out

    def record(self) -> dict:
        """The reference's ``wire_report`` record (telemetry/sink
        envelope)."""
        return {
            **sink.envelope("wire_report"),
            "total_wire_bytes": self.total_wire,
            "fp32_bytes": self.fp32_bytes,
            "bf16_bytes": self.bf16_bytes,
            "state_bytes": self.state_bytes,
            "ratio_vs_bf16": self.ratio_vs_bf16,
            "pods": self.pods,
            "wans": self.wans,
            "ici_bytes": self.ici_bytes,
            "dcn_bytes": self.dcn_bytes,
            "wan_bytes": self.wan_bytes,
            "bf16_dcn_bytes": self.bf16_dcn_bytes,
            "bf16_wan_bytes": self.bf16_wan_bytes,
            "dcn_ratio_vs_bf16": self.dcn_ratio_vs_bf16,
            "wan_ratio_vs_bf16": self.wan_ratio_vs_bf16,
            "tiers": [t.record() for t in self.tiers],
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


def bucket_wire(param: str, tclass: str, b: Bucket, layers: int,
                pods: int = 1, wans: int = 1) -> BucketWire:
    dp = b.seg_elems // b.chunk_elems
    hier = b.sync.hierarchical and pods > 1 and b.sync.strategy != "fp"
    wan = 0
    if hier:
        # tiered: the bucket codec's wire stays in the pod; each outer
        # tier's re-encode of the means crosses its own network
        tiers = sync_schedule(b.sync)
        sizes = _tier_axis_sizes(len(tiers), pods, wans)
        dd = dp // math.prod(sizes)
        legs = tier_components(b.seg_elems, b.sync, pods, dd, wans)
        pay = sum(p for p, _ in legs)
        sc = sum(s for _, s in legs)
        ici, dcn = sum(legs[0]), sum(legs[1])
        wan = sum(p + s for p, s in legs[2:])
    else:
        dd = dp // max(pods * wans, 1)
        pay = payload_bytes(b.seg_elems, b.sync)
        sc = scale_bytes(b.seg_elems, b.sync, dp=dp)
        ici, rest = flat_stage_bytes(b.seg_elems, b.sync, dp, dd)
        dcn = rest
        if wans > 1:
            # the rows beyond this WAN group's dd * pods cross the WAN
            _, wan = flat_stage_bytes(b.seg_elems, b.sync, dp, dd * pods)
            dcn = rest - wan
    return BucketWire(
        param=param, bucket=b.index, tensor_class=tclass,
        strategy=b.sync.strategy, n_elems=b.seg_elems,
        payload=layers * pay, scales=layers * sc,
        state=layers * state_bytes(b.seg_elems, b.sync),
        ici=layers * ici, dcn=layers * dcn, wan=layers * wan,
        hierarchical=hier,
        launches=layers * bucket_launches(b, pods, wans))


def bucket_tiers(b: Bucket, layers: int, pods: int = 1,
                 wans: int = 1) -> list[tuple[int, str, str, int, int, float]]:
    """(tier, network, strategy, period, capacity, effective) per exchange
    leg of one bucket, the rows :func:`plan_tiers` sums.  ``period`` is
    the leg's sync period in steps: tier 0 runs at the bucket cadence
    ``cfg.every``; an outer tier fires when its own gate and the bucket's
    are both on, so its period is the lcm of the two."""
    dp = b.seg_elems // b.chunk_elems
    cfg = b.sync
    period = max(cfg.every, 1)
    if not (cfg.hierarchical and pods > 1 and cfg.strategy != "fp"):
        cap = (payload_bytes(b.seg_elems, cfg)
               + scale_bytes(b.seg_elems, cfg, dp=dp))
        eff = effective_wire_bytes(b.seg_elems, cfg, dp=dp) / period
        return [(0, "ici", cfg.strategy, period, layers * cap, layers * eff)]
    tiers = sync_schedule(cfg)
    sizes = _tier_axis_sizes(len(tiers), pods, wans)
    dd = dp // math.prod(sizes)
    legs = tier_components(b.seg_elems, cfg, pods, dd, wans)
    rows = [(0, "ici", cfg.strategy, period, layers * sum(legs[0]),
             layers * effective_wire_bytes(b.seg_elems, cfg, dp=dd) / period)]
    nets = ("ici", "dcn", "wan")
    n_t = b.seg_elems // dd
    for t, (tier, P) in enumerate(zip(tiers, sizes)):
        p_t = math.lcm(period, max(tier.every, 1))
        rows.append((t + 1, nets[t + 1], tier.sync.strategy, p_t,
                     layers * sum(legs[t + 1]),
                     layers * effective_wire_bytes(n_t, tier.sync, dp=P)
                     / p_t))
        n_t //= P
    return rows


def plan_tiers(plan: SyncPlan, pods: int = 1,
               wans: int = 1) -> tuple[TierWire, ...]:
    """The per-bucket tier legs summed into plan-wide tier rows."""
    agg: dict[int, dict] = {}
    for pp in plan.params:
        for b in pp.buckets:
            for t, net, strat, period, cap, eff in bucket_tiers(
                    b, pp.layers, pods, wans):
                a = agg.setdefault(t, {"network": net, "strategies": set(),
                                       "every": 1, "cap": 0, "eff": 0.0})
                a["strategies"].add(strat)
                a["every"] = max(a["every"], period)
                a["cap"] += cap
                a["eff"] += eff
    return tuple(
        TierWire(tier=t, network=a["network"],
                 strategies=tuple(sorted(a["strategies"])), every=a["every"],
                 capacity_bytes=a["cap"], effective_bytes=a["eff"])
        for t, a in sorted(agg.items()))


def plan_report(plan: SyncPlan, pods: int = 1, wans: int = 1) -> WireReport:
    """Static wire accounting for every bucket of the plan; ``pods`` and
    ``wans`` are the mesh's pod and WAN axis sizes (1: the ICI/DCN split
    is degenerate, everything intra-pod)."""
    rows = []
    fp32 = bf16 = bf16_dcn = bf16_wan = 0
    for pp in plan.params:
        for b in pp.buckets:
            rows.append(bucket_wire(pp.qualname, pp.tensor_class, b,
                                    pp.layers, pods=pods, wans=wans))
            fp32 += pp.layers * 4 * b.seg_elems
            bf16 += pp.layers * 2 * b.seg_elems
            # the baseline's flat exchange by destination row: of the dp
            # rows, dp/wans stay in the WAN group and dp/(pods*wans) in
            # the pod
            bf16_dcn += (pp.layers * 2 * b.seg_elems * (pods - 1)
                         // max(pods * wans, 1))
            bf16_wan += (pp.layers * 2 * b.seg_elems * (wans - 1)
                         // max(wans, 1))
    launches = plan_launches(plan, pods=pods, wans=wans)
    return WireReport(
        buckets=tuple(rows),
        total_wire=sum(r.wire for r in rows),
        fp32_bytes=fp32, bf16_bytes=bf16,
        state_bytes=sum(r.state for r in rows),
        pods=pods, wans=wans,
        ici_bytes=sum(r.ici for r in rows),
        dcn_bytes=sum(r.dcn for r in rows),
        wan_bytes=sum(r.wan for r in rows),
        bf16_dcn_bytes=bf16_dcn, bf16_wan_bytes=bf16_wan,
        tiers=plan_tiers(plan, pods=pods, wans=wans),
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
    if rep.pods > 1:
        lines.append(
            f"  ICI {rep.ici_bytes / 2**20:8.2f} MiB | "
            f"DCN {rep.dcn_bytes / 2**20:8.2f} MiB "
            f"({rep.dcn_ratio_vs_bf16:.3f}x of bf16 DCN share; "
            f"{sum(1 for b in rep.buckets if b.hierarchical)} "
            f"hierarchical buckets)")
    if rep.wans > 1:
        lines.append(
            f"  WAN {rep.wan_bytes / 2**20:8.2f} MiB per sync "
            f"({rep.wan_ratio_vs_bf16:.3f}x of bf16 WAN share)")
    # tier rows only when they say more than the headline (cadence, a
    # ragged effective below capacity, or a multi-tier schedule)
    if len(rep.tiers) > 1 or any(
            t.every > 1 or t.effective_bytes < t.capacity_bytes
            for t in rep.tiers):
        for t in rep.tiers:
            lines.append(
                f"  tier {t.tier} ({t.network}) every={t.every:<3} "
                f"capacity {t.capacity_bytes / 2**20:8.2f} MiB/sync | "
                f"effective {t.effective_bytes / 2**20:8.2f} MiB/step "
                f"[{'+'.join(t.strategies)}]")
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
    if cfg.strategy in ("loco", "topk"):
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
