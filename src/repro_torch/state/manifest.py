"""Checkpoint manifest v2: history, checksums, and layout fingerprints.

Port of ``repro.state.manifest``, in the same JSON format.  The manifest
records, per checkpoint:

* the data file name and a crc32 **checksum per stored array**, so
  ``latest_step``/``restore`` can detect a torn or corrupted file and fall
  back to the previous entry instead of crashing;
* a **fingerprint**: the topology (dp/tp/pods/axes) plus, per parameter,
  the logical layout (numel/padlen/chunklen) and the full per-state-unit
  wire configs with their state dtypes.  ``restore`` compares the stored
  fingerprint against the target run's and either loads directly (equal),
  reshards through logical space (``reshard=True``,
  :mod:`repro_torch.state.reshard`), or fails loudly naming every
  differing field.  The port's fingerprint of a configuration equals the
  reference's, the mesh's ``pods``, ``wans`` and dp axes included.

The manifest keeps **history** (newest last); ``--ckpt-keep`` prunes it to
the newest N entries and deletes the files of the rest.  All writes go
through tmp + ``os.replace`` so the manifest never references a checkpoint
that was not fully written.
"""
from __future__ import annotations

import json
import os
import warnings

from repro_torch.core import buckets as BK
from repro_torch.core import flatparam as FP
from repro_torch.core.loco import SyncConfig, sync_schedule
from repro_torch.core.quantizer import QuantConfig
from repro_torch.core.wirepack import dtype_name
from repro_torch.state import serial

MANIFEST = "manifest.json"
VERSION = 2


class CheckpointMismatch(ValueError):
    """Restore-target layout differs from the checkpoint's fingerprint."""


def ckpt_file(step: int) -> str:
    return f"ckpt_{step:08d}.npz"


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _bucket_dict(b: BK.Bucket) -> dict:
    c = b.sync
    d = {
        "offset": b.offset,
        "chunk_elems": b.chunk_elems,
        "seg_elems": b.seg_elems,
        "strategy": c.strategy,
        "bits": c.quant.bits,
        "mode": c.quant.mode,
        "block": c.quant.block,
        "scale": c.quant.scale,
        "error_codec": c.quant.error_codec,
        "error_scale": c.quant.error_scale,
        "beta": c.beta,
        "reset_every": c.reset_every,
        "hierarchical": c.hierarchical,
        "needs_state": c.needs_state(),
        "every": c.every,
        "topk_frac": c.topk_frac if c.strategy == "topk" else None,
    }
    n, dt = FP.bucket_state_struct(b)
    d["state_len"] = n
    d["state_dtype"] = dtype_name(dt)
    if c.hierarchical:
        s2 = c.stage2_sync()
        d["stage2"] = {"strategy": s2.strategy, "bits": s2.quant.bits,
                       "mode": s2.quant.mode}
        d["tiers"] = {
            f"tier{t + 1}": {
                "strategy": tier.sync.strategy, "bits": tier.sync.quant.bits,
                "mode": tier.sync.quant.mode, "every": tier.every,
                "topk_frac": (tier.sync.topk_frac
                              if tier.sync.strategy == "topk" else None)}
            for t, tier in enumerate(sync_schedule(c))}
    else:
        d["stage2"] = None
        d["tiers"] = {}
    return d


def bucket_sync_config(bd: dict) -> SyncConfig:
    """The state-relevant SyncConfig of a fingerprint bucket: enough for
    the codec's ``state_decode``/``state_encode``."""
    return SyncConfig(
        strategy=bd["strategy"],
        quant=QuantConfig(bits=bd["bits"], mode=bd["mode"], block=bd["block"],
                          scale=bd["scale"], error_codec=bd["error_codec"],
                          error_scale=bd["error_scale"]),
        beta=bd["beta"], reset_every=bd["reset_every"],
        every=bd.get("every", 1),
        topk_frac=bd.get("topk_frac") or 0.01)


def build_fingerprint(groups, topo, sync: SyncConfig,
                      plan: "BK.SyncPlan | None",
                      coalesce: bool = True) -> dict:
    """Serialize the full train-state layout of one run configuration.

    ``plan=None`` (the monolithic path) is described through
    :func:`repro_torch.core.buckets.monolithic_sync_plan`, so both paths
    share one geometry; ``planned`` records which one the stored tree used
    (planned runs store per-unit state tuples, monolithic runs bare
    arrays).  The recorded ``buckets`` are the STATE units the tree stores
    (:func:`repro_torch.core.flatparam.state_units`): one per encode run
    under ``coalesce``, one per bucket otherwise.  The overlap schedule
    changes none of it.  ``topo`` needs ``dp`` and ``tp``; its ``pods``,
    ``wans`` and ``dp_axes`` default to one flat ``data`` axis.
    """
    planned = plan is not None
    if plan is None:
        plan = BK.monolithic_sync_plan(groups, topo, sync)
    params = []
    for g in groups:
        layers = g.n_layers if g.stacked else 1
        for info in g.infos:
            p = {
                "group": g.name,
                "name": info.name,
                "loco": bool(info.loco),
                "stacked": bool(g.stacked),
                "layers": layers,
                "numel": info.numel_local(topo.tp),
                "padlen": info.padlen(topo.tp, topo.dp),
                "chunklen": info.chunklen(topo.tp, topo.dp),
            }
            if info.loco:
                pp = plan.lookup(g.name, info.name)
                p["buckets"] = [_bucket_dict(b)
                                for b in FP.state_units(pp, coalesce)]
            else:
                p["buckets"] = []
            params.append(p)
    return {
        "version": VERSION,
        "topo": {"dp": topo.dp, "tp": topo.tp,
                 "pods": getattr(topo, "pods", 1),
                 "wans": getattr(topo, "wans", 1),
                 "dp_axes": list(getattr(topo, "dp_axes", ("data",)))},
        "planned": planned,
        "params": params,
    }


def _diff_value(path: str, a, b, out: list[str]) -> None:
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            _diff_value(f"{path}.{k}" if path else k,
                        a.get(k, "<absent>"), b.get(k, "<absent>"), out)
    elif a != b:
        out.append(f"{path}: checkpoint={a!r} target={b!r}")


def fingerprint_diff(src: dict, tgt: dict) -> list[str]:
    """Human-readable list of every field that differs (empty = identical)."""
    out: list[str] = []
    _diff_value("topo", src.get("topo"), tgt.get("topo"), out)
    _diff_value("planned", src.get("planned"), tgt.get("planned"), out)
    # MoE activation-wire EF state (the reference's ``block8+ef``, which
    # the port refuses): absent-vs-present IS a mismatch — a codec flip
    # would otherwise silently drop or fabricate the error history
    _diff_value("moe_a2a", src.get("moe_a2a"), tgt.get("moe_a2a"), out)
    sp = {f"{p['group']}/{p['name']}": p for p in src.get("params", [])}
    tp = {f"{p['group']}/{p['name']}": p for p in tgt.get("params", [])}
    for q in sorted(set(sp) | set(tp)):
        if q not in sp:
            out.append(f"params[{q}]: absent in checkpoint")
            continue
        if q not in tp:
            out.append(f"params[{q}]: absent in target")
            continue
        a, b = dict(sp[q]), dict(tp[q])
        ab, bb = a.pop("buckets"), b.pop("buckets")
        _diff_value(f"params[{q}]", a, b, out)
        if len(ab) != len(bb):
            out.append(f"params[{q}].n_buckets: checkpoint={len(ab)} "
                       f"target={len(bb)}")
        else:
            for i, (x, y) in enumerate(zip(ab, bb)):
                _diff_value(f"params[{q}].buckets[{i}]", x, y, out)
    return out


# ---------------------------------------------------------------------------
# manifest I/O
# ---------------------------------------------------------------------------

def load_manifest(ckpt_dir: str) -> dict:
    """Load (and v1-upgrade) the manifest; empty history if none exists."""
    mf = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(mf):
        return {"version": VERSION, "history": []}
    with open(mf) as f:
        m = json.load(f)
    if "history" not in m:  # v1: {"latest": step} — no checksums/fingerprint
        step = m.get("latest")
        hist = ([{"step": step, "file": ckpt_file(step),
                  "checksums": None, "fingerprint": None}]
                if step is not None else [])
        return {"version": VERSION, "history": hist}
    return m


def save_manifest(ckpt_dir: str, manifest: dict) -> None:
    mf = os.path.join(ckpt_dir, MANIFEST)
    tmp = mf + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mf)


def add_entry(ckpt_dir: str, step: int, checksums: dict[str, int],
              fingerprint: "dict | None", keep: int = 0) -> dict:
    """Append a history entry (replacing any same-step one) and prune."""
    m = load_manifest(ckpt_dir)
    m["version"] = VERSION
    m["history"] = [e for e in m["history"] if e["step"] != step]
    m["history"].append({"step": step, "file": ckpt_file(step),
                         "checksums": checksums, "fingerprint": fingerprint})
    m["history"].sort(key=lambda e: e["step"])
    if keep > 0:
        for e in m["history"][:-keep]:
            try:
                os.remove(os.path.join(ckpt_dir, e["file"]))
            except OSError:
                pass
        m["history"] = m["history"][-keep:]
    save_manifest(ckpt_dir, m)
    return m


def find_entry(ckpt_dir: str, step: int) -> "dict | None":
    for e in load_manifest(ckpt_dir)["history"]:
        if e["step"] == step:
            return e
    return None


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------

def verify_checksums(entry: dict, stored: dict) -> "str | None":
    """Check already-loaded arrays against an entry's recorded checksums.

    Split from :func:`verify_entry` so ``restore`` can verify the arrays it
    just read instead of loading and crc-ing the file a second time.
    """
    sums = entry.get("checksums")
    if sums is None:
        return None  # v1 entry: loadable is the best check available
    if set(sums) != set(stored):
        return f"{entry['file']}: key set differs from manifest"
    actual = serial.checksums(stored)
    bad = [k for k, v in sums.items() if actual[k] != v]
    if bad:
        return f"{entry['file']}: checksum mismatch on {bad[:3]}"
    return None


def verify_entry(ckpt_dir: str, entry: dict) -> "str | None":
    """None if the entry's data file is present and intact, else the reason."""
    path = os.path.join(ckpt_dir, entry["file"])
    if not os.path.exists(path):
        return f"{entry['file']}: missing"
    try:
        stored = serial.load_npz(path)
    except Exception as e:  # torn zip / truncated write
        return f"{entry['file']}: unreadable ({e})"
    return verify_checksums(entry, stored)


def latest_valid_entry(ckpt_dir: str) -> "dict | None":
    """Newest history entry that passes verification, warning per skip."""
    hist = load_manifest(ckpt_dir)["history"]
    for e in reversed(hist):
        reason = verify_entry(ckpt_dir, e)
        if reason is None:
            return e
        warnings.warn(
            f"checkpoint step {e['step']} failed integrity check "
            f"({reason}); falling back to the previous manifest entry")
    return None
