"""Wire-traffic accounting for the bucketed sync scheduler.

Port of the flat-stage part of ``repro.telemetry.wire``: predicts, from a
static :class:`~repro_torch.core.buckets.SyncPlan`, what each rank puts on
the wire per sync, from each strategy's ``codec.wire_shapes`` (so the
prediction byte-matches the encode's output tensors), and how many
collectives the coalesced and the per-bucket schedules launch.  The
training CLI prints :func:`format_report` of its plan at startup.

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

from repro_torch.core import codec as codec_lib
from repro_torch.core import wirepack as WP
from repro_torch.core.buckets import Bucket, SyncPlan
from repro_torch.core.loco import SyncConfig, state_dtype


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
