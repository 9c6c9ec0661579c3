"""Compression-health metrics of the train step.

Port of ``repro.telemetry.metrics``.  The step can observe what the LoCo
backward leaves behind: the *synchronized* gradient chunks and the updated
error-feedback states (the wire payloads live only inside the backward).
From those it derives, per state unit:

* **error-state metrics** (exact): the decoded squared error norm, the
  share of stored error values pinned at the error codec's bound (f8
  +-448, int8 +-127) and the non-finite count;
* **quantizer probe** (a proxy): the unit's slice of the synchronized
  gradient re-quantised with the unit's own wire config
  (``Codec.grad_metrics``): saturation at the int4/int8 bounds and the
  log2-scale range;
* **global ratios**: the parameter and update squared norms.

No collective of its own: every metric is a sum, packed into one f32
vector that rides the step's one ``all_reduce`` of the loss
(``launch/steps``), so the step issues the same collectives with the
metrics on or off.  Rates and means are taken after the reduction
(:func:`finalize`).  The schema is static: :func:`metric_units` derives
one :class:`MetricUnit` per non-fp state unit from the plan (encode runs
under ``coalesce``, buckets otherwise, the whole chunk on the monolithic
path), with the reference's keys.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import codec as codec_lib
from repro_torch.core import flatparam as FP
from repro_torch.core.buckets import SyncPlan
from repro_torch.core.comm import divide
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig

# Per-unit slots of the packed metrics vector.  All are plain sums over
# the dp x tp ranks (TP-replicated params pre-divided by tp, the grad-norm
# convention), so one all-reduce sums everything at once.
UNIT_FIELDS = (
    "sat_cnt",         # values at the quantizer's qmin/qmax bound
    "sat_tot",         # values probed
    "scale_l2_sum",    # sum of log2(scale) over probe scales
    "scale_l2_sqsum",  # sum of log2(scale)^2
    "scale_cnt",       # probe scales counted
    "scale_bad",       # non-finite probe scales (NaN/Inf gradient detector)
    "err_sq",          # decoded error-feedback squared norm
    "err_sat_cnt",     # stored error values pinned at the codec bound
    "err_tot",         # stored error values
    "err_bad",         # non-finite decoded error values
)
GLOBAL_FIELDS = ("param_sq", "update_sq")
NF = len(UNIT_FIELDS)


@dataclasses.dataclass(frozen=True)
class MetricUnit:
    """Static description of one metered state unit (schema row)."""

    key: str              # "group/param[unit]": prefix of the metric keys
    group: str
    name: str
    unit: int             # index into the per-param state tuple (-1 = bare)
    offset: int           # chunk-space start of the probe slice
    chunk_elems: int      # chunk-space length of the probe slice
    sync: SyncConfig
    tp_replicated: bool
    stateful: bool


def metric_units(groups, sync: SyncConfig, plan: "SyncPlan | None",
                 topo: MeshTopo,
                 coalesce: bool = True) -> tuple[MetricUnit, ...]:
    """One schema row per non-fp state unit, in state-tuple order.

    Units follow the stored state layout (``FP.state_units``): encode runs
    under ``coalesce``, buckets otherwise, the whole chunk on the
    monolithic path.  ``fp`` units have no wire codec to probe and no
    error state and are skipped (their state-tuple slots stay, which is
    why each row records its tuple index).
    """
    out = []
    for g in groups:
        for info in g.infos:
            if not info.loco:
                continue
            rep = info.tp_dim is None and topo.tp > 1
            if plan is None:
                if sync.strategy == "fp":
                    continue
                out.append(MetricUnit(
                    key=f"{g.name}/{info.name}", group=g.name, name=info.name,
                    unit=-1, offset=0,
                    chunk_elems=info.chunklen(topo.tp, topo.dp),
                    sync=sync, tp_replicated=rep,
                    stateful=sync.needs_state()))
                continue
            units = FP.state_units(plan.lookup(g.name, info.name), coalesce)
            for ui, u in enumerate(units):
                if u.sync.strategy == "fp":
                    continue
                key = (f"{g.name}/{info.name}" if len(units) == 1
                       else f"{g.name}/{info.name}[{ui}]")
                out.append(MetricUnit(
                    key=key, group=g.name, name=info.name, unit=ui,
                    offset=u.offset, chunk_elems=u.chunk_elems, sync=u.sync,
                    tp_replicated=rep, stateful=u.sync.needs_state()))
    return tuple(out)


def _unit_state(u: MetricUnit, states):
    s = states[u.group][u.name]
    return s[u.unit] if u.unit >= 0 else s


def _state_metric_sums(codec, st) -> dict:
    """State metrics of one unit, given its state buffer or pieces of it
    (a tuple): every field is an elementwise sum, so pieces add up."""
    parts = st if isinstance(st, (tuple, list)) else (st,)
    acc: dict = {}
    for p in parts:
        for k, v in codec.state_metrics(p).items():
            acc[k] = acc[k] + v if k in acc else v
    return acc


def _unit_local(u: MetricUnit, grads, states, tp: int,
                device: torch.device) -> torch.Tensor:
    """(NF,) f32 sums for one unit on this rank (before the reduction)."""
    seg = grads[u.group][u.name][..., u.offset:u.offset + u.chunk_elems]
    codec = codec_lib.get_codec(u.sync)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    vals = {f: zero for f in UNIT_FIELDS}
    vals.update(codec.grad_metrics(seg.reshape(-1)))
    if u.stateful:
        vals.update(_state_metric_sums(codec, _unit_state(u, states)))
    vec = torch.stack([vals[f].float().reshape(()) for f in UNIT_FIELDS])
    if u.tp_replicated:
        # identical on every TP rank: pre-divide so the dp x tp sum counts
        # one copy (counts turn fractional, every derived rate is exact)
        vec = divide(vec, tp)
    return vec


def _norm_sq_local(leaf, groups, tp: int,
                   device: torch.device) -> torch.Tensor:
    """TP-replication-aware local squared norm of the chunk-shaped tensors
    ``leaf(group, name)``, taken one tensor at a time (so an update's
    difference is never held as a whole tree)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for g in groups:
        for info in g.infos:
            s2 = torch.sum(leaf(g.name, info.name).float() ** 2)
            if info.tp_dim is None and tp > 1:
                s2 = divide(s2, tp)
            total = total + s2
    return total


def unit_rows(units: tuple[MetricUnit, ...], grads, states, tp: int,
              device: torch.device) -> list[torch.Tensor]:
    """The per-unit part of :func:`local_vector`: one ``(NF,)`` row per
    unit, from the pre-clip synced gradients and the pre-reset states."""
    return [_unit_local(u, grads, states, tp, device) for u in units]


def global_tail(chunks, new_chunks, groups, tp: int,
                device: torch.device) -> torch.Tensor:
    """The trailing ``(param_sq, update_sq)`` of :func:`local_vector`."""
    return torch.stack([
        _norm_sq_local(lambda g, n: chunks[g][n], groups, tp, device),
        _norm_sq_local(lambda g, n: new_chunks[g][n] - chunks[g][n], groups,
                       tp, device)])


def local_vector(units: tuple[MetricUnit, ...], grads, states, chunks,
                 new_chunks, groups, tp: int,
                 device: torch.device) -> torch.Tensor:
    """The packed local metrics vector: ``len(units) * NF + 2`` f32 sums.

    ``grads`` is the *pre-clip* synchronized gradient tree, ``states`` the
    pre-reset compressor states; the trailing globals are the parameter
    and update squared norms (``chunks`` before, ``new_chunks`` after the
    optimizer).  The caller sums this over the dp x tp ranks, then calls
    :func:`finalize`.  The train step computes the rows before the clip
    and the tail after the update, so it holds no second gradient tree.
    """
    rows = unit_rows(units, grads, states, tp, device)
    return torch.cat(rows + [global_tail(chunks, new_chunks, groups, tp,
                                         device)])


def _unit_keys(u: MetricUnit) -> tuple[str, ...]:
    ks = (f"{u.key}/sat_rate", f"{u.key}/scale_log2_mean",
          f"{u.key}/scale_log2_std")
    if u.stateful:
        ks += (f"{u.key}/err_sq", f"{u.key}/err_sat_rate")
    ks += (f"{u.key}/nonfinite",)
    return ks


GLOBAL_KEYS = ("err_norm", "sat_rate", "param_norm", "update_norm",
               "update_ratio", "nonfinite")


def metric_keys(units: tuple[MetricUnit, ...]) -> tuple[str, ...]:
    """Every key :func:`finalize` emits, in order."""
    out: list[str] = []
    for u in units:
        out.extend(_unit_keys(u))
    out.extend(GLOBAL_KEYS)
    return tuple(out)


def finalize(red: torch.Tensor,
             units: tuple[MetricUnit, ...]) -> dict[str, torch.Tensor]:
    """Reduced packed vector -> flat ``{key: 0-dim f32}`` metrics.  Every
    operation is an IEEE f32 one, so the values are the same on any
    device."""
    out: dict[str, torch.Tensor] = {}
    one = torch.ones((), dtype=torch.float32, device=red.device)
    sat_c = sat_t = err_sq = bad = torch.zeros_like(one)
    for i, u in enumerate(units):
        v = dict(zip(UNIT_FIELDS, red[i * NF:(i + 1) * NF]))
        out[f"{u.key}/sat_rate"] = v["sat_cnt"] / torch.maximum(v["sat_tot"],
                                                                one)
        cnt = torch.maximum(v["scale_cnt"], one)
        mean = v["scale_l2_sum"] / cnt
        var = v["scale_l2_sqsum"] / cnt - mean ** 2
        out[f"{u.key}/scale_log2_mean"] = mean
        out[f"{u.key}/scale_log2_std"] = torch.sqrt(torch.clamp(var, min=0.0))
        if u.stateful:
            out[f"{u.key}/err_sq"] = v["err_sq"]
            out[f"{u.key}/err_sat_rate"] = (
                v["err_sat_cnt"] / torch.maximum(v["err_tot"], one))
        out[f"{u.key}/nonfinite"] = v["scale_bad"] + v["err_bad"]
        sat_c = sat_c + v["sat_cnt"]
        sat_t = sat_t + v["sat_tot"]
        err_sq = err_sq + v["err_sq"]
        bad = bad + v["scale_bad"] + v["err_bad"]
    param_sq, update_sq = red[len(units) * NF], red[len(units) * NF + 1]
    pn = torch.sqrt(param_sq)
    un = torch.sqrt(update_sq)
    out["err_norm"] = torch.sqrt(err_sq)
    out["sat_rate"] = sat_c / torch.maximum(sat_t, one)
    out["param_norm"] = pn
    out["update_norm"] = un
    out["update_ratio"] = un / torch.clamp(pn, min=1e-12)
    out["nonfinite"] = bad
    return out


# ---------------------------------------------------------------------------
# per-unit error norms outside the step (checkpoint inspection, tests)
# ---------------------------------------------------------------------------

def error_sq_norms(states, pplan, coalesce: bool = True) -> tuple:
    """Squared L2 norm of each state unit's decoded error (this rank)."""
    out = []
    for s, u in zip(states, FP.state_units(pplan, coalesce)):
        if u.sync.needs_state():
            e = codec_lib.get_codec(u.sync).state_decode(s)
            out.append(torch.sum(e.float() ** 2))
        else:
            out.append(torch.zeros((), dtype=torch.float32, device=s.device))
    return tuple(out)
