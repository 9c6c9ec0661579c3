"""Structured JSONL metrics sink and the shared record envelope.

A copy of ``repro.telemetry.sink`` (the port imports nothing of
``repro``), with the reference's schema version, kinds and field names, so
either package's validator accepts the other's stream.  Every record is
one JSON line carrying the common envelope::

    {"schema_version": 2, "kind": "<kind>", "t": <unix seconds>, ...}

Kinds
-----
* ``header``  -- once per run: run arguments, the train-state fingerprint
  (``repro_torch.state.build_fingerprint``), the topology and, for MoE
  models on the ``ep_a2a`` exchange, the activation-wire report.
* ``step``    -- per logged step: step, loss/gnorm/lr, step_ms, the
  sync schedule's ``groups_inflight`` and the flat metrics tree
  (``telemetry/metrics``).
* ``warning`` -- a health monitor fired: monitor name, message, value.
* ``summary`` -- once at the end: the first step's seconds (``compile_s``,
  the reference's name), later step-time percentiles, tokens/s, wire MiB
  per step, peak error norm, warning count.
* ``wire_report`` -- ``WireReport.record``'s envelope (static accounting).
* ``bench``   -- a benchmark's envelope.
* ``fidelity`` (schema v2) -- per probe step (``--fidelity-every``): the
  step and the flat fidelity metrics (cos / rel_l2 / comp_gain per unit
  and global, per-stage attribution) of ``telemetry/fidelity``.

v1 records of the original kinds still validate.  The validator is
hand-rolled (no jsonschema) and doubles as a CLI::

    python -m repro_torch.telemetry.sink run.jsonl --expect-healthy

which exits non-zero on any malformed record and (with
``--expect-healthy``) on any ``warning`` record in the stream.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

SCHEMA_VERSION = 2
KINDS = ("header", "step", "warning", "summary", "wire_report", "bench",
         "fidelity")
# kinds that existed under schema v1: v1 records of these still validate
_V1_KINDS = ("header", "step", "warning", "summary", "wire_report", "bench")


def envelope(kind: str, **fields) -> dict:
    """The common record envelope every emitter shares."""
    assert kind in KINDS, kind
    return {"schema_version": SCHEMA_VERSION, "kind": kind,
            "t": time.time(), **fields}


# ---------------------------------------------------------------------------
# health monitors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds for the loud-warning monitors.

    ``err_norm_max`` is an absolute divergence ceiling; ``err_growth_max``
    fires on relative growth vs the smallest error norm seen (a diverging
    error-feedback state grows without bound while gradients do not).
    ``sat_rate_max`` flags a quantizer pinned at its bounds (block-mode
    absmax scaling puts >= 1/block of values at the bound by construction,
    so a healthy rate is a few percent).  Non-finite values always warn.

    The fidelity monitors are *sustained-window* checks
    over consecutive ``fidelity`` records: a single noisy probe is
    expected, ``fid_window`` probes in a row below ``fid_cos_min`` (the
    synced gradient no longer points where the true mean does) or under
    ``fid_gain_min`` compensation gain (error feedback making fidelity
    WORSE than the uncompensated encode) are not.
    """

    err_norm_max: float = 1e4
    err_growth_max: float = 50.0
    sat_rate_max: float = 0.5
    fid_cos_min: float = 0.8
    fid_gain_min: float = 1.0
    fid_window: int = 3


class HealthMonitor:
    """Stateful step-record checks; returns warning records to append."""

    def __init__(self, cfg: HealthConfig | None = None):
        self.cfg = cfg or HealthConfig()
        self._err_min: float | None = None
        self._fid_low = 0     # consecutive probes with cos < fid_cos_min
        self._fid_nogain = 0  # consecutive probes with gain < fid_gain_min

    def check(self, rec: dict) -> list[dict]:
        cfg, out = self.cfg, []
        m = rec.get("metrics", {})
        scalars = {"loss": rec.get("loss"), "gnorm": rec.get("gnorm"), **m}
        for k, v in scalars.items():
            if isinstance(v, (int, float)) and not math.isfinite(v):
                out.append(self._warn("nonfinite", f"{k} is {v}", v))
        if m.get("nonfinite", 0):
            out.append(self._warn(
                "nonfinite_values",
                f"{m['nonfinite']:.0f} non-finite scale/error values "
                "in-graph (NaN/Inf gradient or diverged error state)",
                m["nonfinite"]))
        en = m.get("err_norm")
        if isinstance(en, (int, float)) and math.isfinite(en) and en > 0:
            if en > cfg.err_norm_max:
                out.append(self._warn(
                    "err_divergence",
                    f"error-feedback norm {en:.3e} exceeds absolute "
                    f"threshold {cfg.err_norm_max:.1e}", en))
            if self._err_min is not None and en > cfg.err_growth_max * self._err_min:
                out.append(self._warn(
                    "err_growth",
                    f"error-feedback norm {en:.3e} grew {en / self._err_min:.0f}x "
                    f"over the run minimum {self._err_min:.3e}", en))
            self._err_min = en if self._err_min is None else min(self._err_min, en)
        sr = m.get("sat_rate")
        if isinstance(sr, (int, float)) and sr > cfg.sat_rate_max:
            out.append(self._warn(
                "saturation",
                f"quantizer saturation rate {sr:.2%} exceeds "
                f"{cfg.sat_rate_max:.0%} (scale pinned at the clip bound)",
                sr))
        fc = m.get("fidelity/cos")
        if isinstance(fc, (int, float)) and math.isfinite(fc):
            self._fid_low = self._fid_low + 1 if fc < cfg.fid_cos_min else 0
            if self._fid_low >= cfg.fid_window:
                out.append(self._warn(
                    "fidelity_collapse",
                    f"synced-gradient cosine {fc:.4f} below "
                    f"{cfg.fid_cos_min} for {self._fid_low} consecutive "
                    "probes (compression loss dominating the gradient)",
                    fc))
        fg = m.get("fidelity/comp_gain")
        if isinstance(fg, (int, float)) and math.isfinite(fg):
            self._fid_nogain = (self._fid_nogain + 1
                                if fg < cfg.fid_gain_min else 0)
            if self._fid_nogain >= cfg.fid_window:
                out.append(self._warn(
                    "negative_comp_gain",
                    f"compensation gain {fg:.3f} < {cfg.fid_gain_min} for "
                    f"{self._fid_nogain} consecutive probes (error "
                    "feedback making fidelity worse than the "
                    "uncompensated encode)", fg))
        return out

    @staticmethod
    def _warn(monitor: str, message: str, value) -> dict:
        print(f"TELEMETRY WARNING [{monitor}]: {message}",
              file=sys.stderr, flush=True)
        return envelope("warning", monitor=monitor, message=message,
                        value=float(value))


# ---------------------------------------------------------------------------
# the sink
# ---------------------------------------------------------------------------

class MetricsSink:
    """Append-only JSONL stream with periodic flush and a run finalizer."""

    def __init__(self, path: str, header: dict | None = None,
                 flush_every: int = 20,
                 health: HealthConfig | None = None):
        self.path = path
        self._f = open(path, "a")
        self._since_flush = 0
        self.flush_every = flush_every
        self.monitor = HealthMonitor(health)
        self.n_warnings = 0
        if header is not None:
            self.write(envelope("header", **header))

    def write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        self._f.flush()
        self._since_flush = 0

    def step(self, step: int, *, loss: float, gnorm: float, lr: float,
             step_ms: float | None, metrics: dict,
             groups_inflight: int | None = None) -> None:
        rec = envelope("step", step=step, loss=loss, gnorm=gnorm, lr=lr,
                       step_ms=step_ms, metrics=metrics)
        if groups_inflight is not None:
            # static pipeline depth of the sync schedule: 1 = one sync
            # region, 2 = the overlapped schedule's two stages in flight
            rec["groups_inflight"] = groups_inflight
        self.write(rec)
        for w in self.monitor.check(rec):
            self.n_warnings += 1
            self.write(w)

    def fidelity(self, step: int, *, metrics: dict) -> None:
        """One probe-step fidelity record + health checks."""
        rec = envelope("fidelity", step=step, metrics=metrics)
        self.write(rec)
        for w in self.monitor.check(rec):
            self.n_warnings += 1
            self.write(w)

    def summary(self, **fields) -> None:
        self.write(envelope("summary", warnings=self.n_warnings, **fields))

    def close(self) -> None:
        self.flush()
        self._f.close()


def percentiles(xs: list[float], qs=(50, 90, 99)) -> dict[str, float]:
    """Nearest-rank percentiles of a small sample (no numpy needed)."""
    if not xs:
        return {f"p{q}": float("nan") for q in qs}
    s = sorted(xs)
    return {f"p{q}": s[min(len(s) - 1, int(round(q / 100 * (len(s) - 1))))]
            for q in qs}


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

_REQUIRED: dict[str, dict[str, type | tuple]] = {
    "header": {"run": dict, "topo": dict},
    "step": {"step": int, "loss": (int, float), "gnorm": (int, float),
             "lr": (int, float), "metrics": dict},
    "warning": {"monitor": str, "message": str, "value": (int, float)},
    "summary": {"steps": int, "warnings": int},
    "wire_report": {"total_wire_bytes": int},
    "bench": {"bench": str, "results": dict},
    "fidelity": {"step": int, "metrics": dict},
}


def validate_record(rec) -> list[str]:
    """Schema errors of one decoded record ([] = valid)."""
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    errs = []
    kind = rec.get("kind")
    sv = rec.get("schema_version")
    # back-compat read path: v1 streams predate the fidelity kind and
    # remain valid for the kinds that existed then
    if sv != SCHEMA_VERSION and not (sv == 1 and kind in _V1_KINDS):
        errs.append(f"schema_version={sv!r} "
                    f"(expected {SCHEMA_VERSION}, or 1 for v1-era kinds)")
    if kind not in KINDS:
        return errs + [f"unknown kind {kind!r}"]
    if not isinstance(rec.get("t"), (int, float)):
        errs.append("missing/non-numeric t")
    for field, ty in _REQUIRED[kind].items():
        v = rec.get(field)
        if v is None or (not isinstance(v, ty)) or isinstance(v, bool):
            errs.append(f"{kind}.{field}: expected {ty}, got {type(v).__name__}")
    if kind in ("step", "fidelity"):
        m = rec.get("metrics")
        if isinstance(m, dict):
            for k, v in m.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    errs.append(f"{kind}.metrics[{k!r}] is not a number")
    return errs


def validate_stream(path: str) -> dict:
    """Validate a JSONL file; returns {kinds: {kind: n}, errors: [...]}."""
    kinds: dict[str, int] = {}
    errors: list[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {i}: invalid JSON ({e})")
                continue
            for e in validate_record(rec):
                errors.append(f"line {i}: {e}")
            if isinstance(rec, dict):
                kinds[rec.get("kind", "?")] = kinds.get(rec.get("kind", "?"), 0) + 1
    return {"kinds": kinds, "errors": errors}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate a telemetry JSONL stream against the sink schema.")
    ap.add_argument("path")
    ap.add_argument("--expect-healthy", action="store_true",
                    help="also fail if the stream contains warning records")
    args = ap.parse_args(argv)
    res = validate_stream(args.path)
    print(f"{args.path}: " + ", ".join(
        f"{n} {k}" for k, n in sorted(res["kinds"].items())))
    for e in res["errors"]:
        print(f"  SCHEMA ERROR: {e}", file=sys.stderr)
    if res["errors"]:
        return 1
    if args.expect_healthy and res["kinds"].get("warning", 0):
        print(f"  {res['kinds']['warning']} warning record(s) in a run "
              "expected healthy", file=sys.stderr)
        return 2
    if not res["kinds"].get("step"):
        print("  no step records in stream", file=sys.stderr)
        return 3
    print("  schema OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
