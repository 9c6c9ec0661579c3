"""The dry run's markdown tables from its JSON records (port of
``repro.analysis.report``): the roofline, the collective bytes by kind,
the fidelity probe's overhead and runs, and the two meshes side by side.

  PYTHONPATH=src python -m repro_torch.analysis.report \\
      [--dir experiments/dryrun_torch]

The tables are the reference's; the fit mark (a peak over the device's
memory) is set at the H100's memory (``roofline.HBM_BYTES``) in place of
the reference's 16 GiB.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.analysis import roofline as RL

# the reference's order, with deepseek-v3-moe (which the reference's
# tables leave out) where configs.all_archs.ASSIGNED has it
ARCH_ORDER = [
    "chameleon-34b", "mixtral-8x7b", "qwen3-moe-30b-a3b", "deepseek-v3-moe",
    "minicpm-2b",
    "gemma2-27b", "zamba2-2.7b", "whisper-small", "command-r-35b",
    "mamba2-2.7b", "h2o-danube-1.8b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: str, mesh: str = None, sync: str = "loco"):
    recs = {}
    for f in glob.glob(os.path.join(dir_, "*.json")):
        r = json.load(open(f))
        if sync and r.get("sync") != sync:
            continue
        if mesh and r.get("mesh") != mesh:
            continue
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def _fmt_bytes(b):
    return f"{b/2**30:.2f}"


def roofline_table(recs, mesh="16x16"):
    lines = [
        "| arch | shape | persistent GiB | peak GiB (CPU) | FLOPs/dev | HBM B/dev | "
        "wire B/dev | compute s | memory s | collective s | dominant | "
        "useful-FLOPs ratio |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"| {a} | {s} | — | — | — | — | — | — | — | — | "
                             f"skipped: {r['reason']} | — |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {a} | {s} | ERROR | | | | | | | | {r['error'][:60]} | |")
                continue
            rf = r["roofline"]
            fit = "" if r["memory"]["peak_bytes"] <= RL.HBM_BYTES else " ⚠"
            ratio = r.get("useful_flops_ratio")
            rat = f"{ratio:.2f}" if ratio else "n/a"
            lines.append(
                f"| {a} | {s} | {_fmt_bytes(r['memory']['argument_bytes'])} | "
                f"{_fmt_bytes(r['memory']['peak_bytes'])}{fit} | "
                f"{r['flops_per_device']:.2e} | {r['hbm_bytes_per_device']:.2e} | "
                f"{r['collectives']['wire_bytes']:.2e} | "
                f"{rf['compute_s']:.4f} | {rf['memory_s']:.4f} | "
                f"{rf['collective_s']:.4f} | {rf['dominant'].replace('_s','')} | "
                f"{rat} |")
    return "\n".join(lines)


def collective_table(recs, mesh="16x16", shape="train_4k"):
    lines = [
        "| arch | all-gather | all-reduce | all-to-all | reduce-scatter | total wire "
        "| overlap |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        r = recs.get((a, shape, mesh))
        if not r or r["status"] != "ok":
            continue
        bk = r["collectives"]["bytes_by_kind"]
        ov = r.get("overlap")
        if ov:  # nested {overlapped, legacy} since the PR 7 scheduler
            ov = ov.get("overlapped", ov)
        ovs = f"{ov['overlap_fraction']:.0%}" if ov else "n/a"
        lines.append(
            f"| {a} | " + " | ".join(
                f"{bk.get(k, 0)/2**30:.2f}" for k in
                ("all-gather", "all-reduce", "all-to-all", "reduce-scatter"))
            + f" | {r['collectives']['wire_bytes']/2**30:.2f} GiB | {ovs} |")
    return "\n".join(lines)


def fidelity_overhead_table(recs, mesh="16x16", shape="train_4k"):
    """Probe cadence + predicted probe-step overhead (dryrun --fidelity-every
    records, DESIGN.md §17): extra wire bytes are the reference reduces,
    extra launches include the probe's flat schedule vs the pipelined one."""
    lines = ["| arch | cadence | probe wire | extra wire | extra launches |",
             "|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        r = recs.get((a, shape, mesh))
        if not r or r.get("status") != "ok" or not r.get("fidelity"):
            continue
        f = r["fidelity"]
        xl = ", ".join(f"{k} {v:+d}"
                       for k, v in sorted(f["extra_launches"].items())) or "none"
        lines.append(
            f"| {a} | every {f['every']} | "
            f"{f['probe_wire_bytes'] / 2**20:.2f} MiB | "
            f"{f['extra_wire_bytes'] / 2**20:+.2f} MiB | {xl} |")
    return "\n".join(lines)


def fidelity_run_table(jsonl_path: str):
    """Probe-step fidelity trace from a --metrics-jsonl stream (the sink's
    ``fidelity`` records): global cosine / relative L2 / compensation gain
    per probe, worst unit by cosine."""
    rows = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "fidelity":
                rows.append((rec.get("step"), rec.get("metrics", {})))
    lines = ["| step | cos | rel_l2 | comp_gain | worst unit (cos) |",
             "|---|---|---|---|---|"]
    nan = float("nan")
    for step, m in rows:
        unit_cos = {k[:-len("/fid_cos")]: v for k, v in m.items()
                    if k.endswith("/fid_cos") and not k.startswith("fidelity")}
        worst = min(unit_cos, key=unit_cos.get) if unit_cos else "n/a"
        wtxt = (f"{worst} ({unit_cos[worst]:.4f})" if unit_cos else "n/a")
        lines.append(f"| {step} | {m.get('fidelity/cos', nan):.4f} | "
                     f"{m.get('fidelity/rel_l2', nan):.4f} | "
                     f"{m.get('fidelity/comp_gain', nan):.3f} | {wtxt} |")
    return "\n".join(lines)


def compare_meshes(recs_all):
    lines = ["| arch | shape | single-pod wire | 2-pod wire | single-pod dom | 2-pod dom |",
             "|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r1 = recs_all.get((a, s, "16x16"))
            r2 = recs_all.get((a, s, "2x16x16"))
            if not (r1 and r2) or r1["status"] != "ok" or r2["status"] != "ok":
                continue
            lines.append(
                f"| {a} | {s} | {r1['collectives']['wire_bytes']/2**30:.2f} GiB | "
                f"{r2['collectives']['wire_bytes']/2**30:.2f} GiB | "
                f"{r1['roofline']['dominant'].replace('_s','')} | "
                f"{r2['roofline']['dominant'].replace('_s','')} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--jsonl", default=None, metavar="FILE",
                    help="also render the fidelity-probe trace from a "
                         "--metrics-jsonl stream's fidelity records")
    args = ap.parse_args()
    recs = load(args.dir)
    print("## Roofline (single-pod 16x16, sync=loco)\n")
    print(roofline_table(recs, args.mesh))
    print("\n## Collective bytes by kind (train_4k)\n")
    print(collective_table(recs))
    if any(r.get("fidelity") for r in recs.values()):
        print("\n## Fidelity-probe overhead (train_4k)\n")
        print(fidelity_overhead_table(recs, args.mesh))
    print("\n## Mesh comparison\n")
    print(compare_meshes(recs))
    if args.jsonl:
        print("\n## Fidelity probes\n")
        print(fidelity_run_table(args.jsonl))


if __name__ == "__main__":
    main()
