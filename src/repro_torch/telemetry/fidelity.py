"""Gradient-fidelity probes: the sampled true-mean shadow sync.

Port of ``repro.telemetry.fidelity``.  On a probe step
(``RunConfig.fidelity_every``) the backward of each loco parameter adds a
reference stack to a probe buffer beside its synchronized chunk: the rows
of one extra reduce-scatter over the same dp group
(``core/comm._probe_reduce``):

* row 0 ``true``  -- the exact f32 mean of the raw per-rank gradient,
* row 1 ``comp``  -- the mean of the *live* roundtrip ``decode(encode(g +
  e))``, decoded from the wire the sync sent (no second encode),
* row 2 ``nc``    -- the mean of the counterfactual roundtrip
  ``decode(encode(g))`` from a zero error state,
* rows 3+ -- for a multi-tier schedule, the exact mean of each non-final
  tier's output over the dp axes it has not crossed yet.

The buffers accumulate over the step's microbatches like the gradient:
compensation telescopes, so its gain over the uncompensated encode shows
only once several syncs are summed.  From the accumulated buffers each
unit contributes plain sums (:data:`FID_FIELDS`, then one squared stage
deviation per stage), packed into one vector that rides the probe step's
loss all-reduce; :func:`finalize` turns the reduced vector into::

    {unit}/fid_cos         cos(sync, true)
    {unit}/fid_rel_l2      |sync - true| / |true|
    {unit}/fid_comp_gain   |nc - true| / |comp - true|   (> 1: EF helps)
    {unit}/fid_stage{s}_rel  |R_s - R_{s-1}| / |true|    (multi-tier only)

and the norm-weighted globals ``fidelity/cos``, ``fidelity/rel_l2`` and
``fidelity/comp_gain``.  The chain ``R_0 = true, R_1 = comp``, the mid-tier
references, ``R_S = sync`` telescopes: the stage deviations sum, as
vectors, to the end-to-end deviation.

The units are the health metrics' (``telemetry/metrics.metric_units``):
one per non-fp state unit; fp units are exact and carry no rows.  The
sums run on the device, in f64 rounded once (``comm.sum_f64``), so the
card gives the CPU's sums; :func:`finalize` runs on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import loco as loco_lib
from repro_torch.core.comm import divide, sum_f64
from repro_torch.core.loco import SyncConfig
from repro_torch.telemetry.metrics import MetricUnit, metric_units

# Per-unit base slots (before the S per-stage deviation slots).  All plain
# sums over the dp x tp ranks, TP-replicated rows pre-divided by tp.
FID_FIELDS = (
    "true_sq",       # |true|^2
    "sync_sq",       # |sync|^2
    "dot",           # <sync, true>
    "dev_sq",        # |sync - true|^2
    "comp_dev_sq",   # |comp - true|^2   (live compensated roundtrip)
    "nc_dev_sq",     # |nc - true|^2     (counterfactual, zero error state)
)
NBASE = len(FID_FIELDS)
_TINY = 1e-20

FidelityUnit = MetricUnit  # the same geometry: one per non-fp state unit


def fidelity_units(groups, sync, plan, topo, coalesce: bool = True):
    """The probe's units are the health metrics' (non-fp state units)."""
    return metric_units(groups, sync, plan, topo, coalesce)


def n_stages(cfg: SyncConfig) -> int:
    """Sync stages of one unit: 1 (flat) plus one per outer tier."""
    if cfg.strategy == "fp":
        return 1
    return 1 + len(loco_lib.sync_schedule(cfg))


def probe_rows(cfg: SyncConfig) -> int:
    """Rows of the reference stack one unit's sync emits: the 3 base rows
    and one mid-tier reference per non-final tier (the coalesced
    two-stage legs emit 3: their only tier is final)."""
    return 3 + max(0, n_stages(cfg) - 2)


def unit_fields(u: MetricUnit) -> int:
    """Packed slots of one unit: the base fields and S stage deviations."""
    return NBASE + n_stages(u.sync)


def vector_len(units) -> int:
    return sum(unit_fields(u) for u in units)


def _unit_local(u: MetricUnit, grads, probes, tp: int) -> torch.Tensor:
    """``(unit_fields,)`` f32 sums of one unit on this rank.

    ``grads`` is the synchronized (accumulated, pre-clip) gradient tree,
    ``probes`` the matching accumulated reference tree whose leaves are
    ``(..., K, chunk)`` stacks (K >= probe_rows; rows past a unit's own
    stay zero and are never read).  A leading layer axis sums into the
    fields like any other element axis.
    """
    sl = slice(u.offset, u.offset + u.chunk_elems)
    sync = grads[u.group][u.name][..., sl].float()
    p = probes[u.group][u.name][..., :, sl].float()
    true, comp, nc = p[..., 0, :], p[..., 1, :], p[..., 2, :]

    def sq(x):
        return sum_f64(x, x)

    dev = sync - true
    fields = [sq(true), sq(sync), sum_f64(sync, true), sq(dev),
              sq(comp - true), sq(nc - true)]
    S = n_stages(u.sync)
    # the telescoping chain: R_0 = true, R_1 = comp, mid tiers, R_S = sync
    chain = [true, sync] if S == 1 else (
        [true, comp] + [p[..., 3 + i, :] for i in range(S - 2)] + [sync])
    for a, b in zip(chain[:-1], chain[1:]):
        fields.append(sq(b - a))
    vec = torch.stack(fields).float()
    if u.tp_replicated:
        vec = divide(vec, tp)  # the same on every TP rank (grad-norm rule)
    return vec


def local_vector(units, grads, probes, tp: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """The packed local fidelity vector: ``vector_len(units)`` f32 sums,
    for the caller to sum over the dp x tp ranks."""
    rows = [_unit_local(u, grads, probes, tp) for u in units]
    return (torch.cat(rows) if rows
            else torch.zeros((0,), dtype=torch.float32, device=device))


def _unit_keys(u: MetricUnit) -> tuple[str, ...]:
    ks = (f"{u.key}/fid_cos", f"{u.key}/fid_rel_l2", f"{u.key}/fid_comp_gain")
    S = n_stages(u.sync)
    if S >= 2:
        ks += tuple(f"{u.key}/fid_stage{s}_rel" for s in range(1, S + 1))
    return ks


GLOBAL_KEYS = ("fidelity/cos", "fidelity/rel_l2", "fidelity/comp_gain")


def fidelity_keys(units) -> tuple[str, ...]:
    """Every key :func:`finalize` emits, in order."""
    out: list[str] = []
    for u in units:
        out.extend(_unit_keys(u))
    out.extend(GLOBAL_KEYS)
    return tuple(out)


def finalize(red: torch.Tensor, units) -> dict[str, torch.Tensor]:
    """The reduced packed vector -> flat ``{key: 0-dim f32}`` fidelity
    metrics (on the vector's device; the step passes a CPU copy)."""
    out: dict[str, torch.Tensor] = {}
    tiny = torch.full((), _TINY, dtype=torch.float32, device=red.device)
    zero = torch.zeros((), dtype=torch.float32, device=red.device)
    tot = {f: zero for f in FID_FIELDS}
    off = 0
    for u in units:
        nf = unit_fields(u)
        v = dict(zip(FID_FIELDS, red[off:off + NBASE]))
        stage = red[off + NBASE:off + nf]
        off += nf
        t = torch.maximum(v["true_sq"], tiny)
        out[f"{u.key}/fid_cos"] = v["dot"] / torch.sqrt(
            t * torch.maximum(v["sync_sq"], tiny))
        out[f"{u.key}/fid_rel_l2"] = torch.sqrt(v["dev_sq"] / t)
        out[f"{u.key}/fid_comp_gain"] = torch.sqrt(
            v["nc_dev_sq"] / torch.maximum(v["comp_dev_sq"], tiny))
        S = n_stages(u.sync)
        if S >= 2:
            for s in range(S):
                out[f"{u.key}/fid_stage{s + 1}_rel"] = torch.sqrt(
                    stage[s] / t)
        for f in FID_FIELDS:
            tot[f] = tot[f] + v[f]
    t = torch.maximum(tot["true_sq"], tiny)
    out["fidelity/cos"] = tot["dot"] / torch.sqrt(
        t * torch.maximum(tot["sync_sq"], tiny))
    out["fidelity/rel_l2"] = torch.sqrt(tot["dev_sq"] / t)
    out["fidelity/comp_gain"] = torch.sqrt(
        tot["nc_dev_sq"] / torch.maximum(tot["comp_dev_sq"], tiny))
    return out


# ---------------------------------------------------------------------------
# vector-level oracle (tests, benchmarks): plain math on whole vectors
# ---------------------------------------------------------------------------

def fidelity_stats(sync, true) -> dict:
    """Oracle cos / rel_l2 of one synced-vs-true vector pair (numpy)."""
    s = np.asarray(sync, np.float32).reshape(-1)
    t = np.asarray(true, np.float32).reshape(-1)
    ts = np.maximum(np.sum(t * t), np.float32(_TINY))
    return {
        "cos": np.sum(s * t) / np.sqrt(ts * np.maximum(np.sum(s * s),
                                                       np.float32(_TINY))),
        "rel_l2": np.sqrt(np.sum((s - t) ** 2) / ts),
    }
