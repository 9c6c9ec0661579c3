"""One run of one benchmark cell, driven by ``BENCHMARK.json`` and data files.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The harness finds everything else by name:

* ``bench/configs/<config>.json``: the model's sizes as the reference
  reads them, the program's architecture (``arch``) and what was cut;
* ``bench/traffic/<traffic>.json``: the job or the request mix, and the
  loop that drives it (``loop``);
* ``bench/loops/<loop>.py``: ``run(cell, seed, seconds, trace, device,
  t0)``, which builds the program, times the window and checks the
  outputs against the reference;
* ``bench/limits/<workload>.json``: the limit of each compared number;
* ``bench/metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric,
  ``None`` where the run has nothing for it to read.

So a later cell, configuration, traffic mix or metric is new files and
new entries, never an edit.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench")
# top-level module names that may not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# build and kernel caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": ".bench_cache/triton",
          "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}
# the caching allocator grows its segments instead of cutting new ones:
# h2o-danube-1.8b's training step peaks at 69.5 GiB of the card's 79.2,
# and with fixed segments its window's first Adam update failed on 10.8
# GiB held in half-used segments
ALLOC_CONF = "expandable_segments:True"


def environment() -> None:
    """The run's environment, set before ``torch`` touches the card."""
    for k, v in CACHES.items():
        os.environ[k] = os.path.join(ROOT, v)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def load_module(path: str, name: str):
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def cell(sp: dict, workload: str) -> dict:
    """The cell ``workload`` with its configuration, traffic and limits."""
    for w in sp["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    return {"workload": w,
            "config": load_json(BENCH, "configs", w["config"] + ".json"),
            "traffic": load_json(BENCH, "traffic", w["traffic"] + ".json"),
            "limits": load_json(BENCH, "limits", w["name"] + ".json")}


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(sp: dict, workload: str) -> list[dict]:
    return [m for m in sp["end_to_end"] if applies(m, workload)]


def per_layer(sp: dict, workload: str) -> list[dict]:
    """The per-layer metrics of a cell: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(sp, workload)}
    return [m for m in sp["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def read_metrics(entries: list[dict], ctx: dict) -> dict:
    out = {}
    for m in entries:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        v = load_module(path, "bench_metric_" + m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({n for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def port_arch(c: dict):
    """The program's architecture for configuration ``c``: its registered
    ``arch`` with the file's values, after checking that the two agree
    on every key the file does not list under ``reduced``."""
    from repro_torch.configs.base import get_arch

    base = get_arch(c["arch"])
    fields = {f.name for f in dataclasses.fields(base)} - {"name", "source"}
    have = dict(dataclasses.asdict(base), head_dim=base.hd)
    keys = sorted(k for k in c if k in fields)
    differ = [k for k in keys if k not in c["reduced"] and have[k] != c[k]]
    if differ:
        raise SystemExit(f"{c['name']}: the program's {c['arch']} differs "
                         f"from the configuration file in {differ}")
    return dataclasses.replace(base, **{k: c[k] for k in keys})


def stage(t0: float, what: str) -> None:
    """One line on standard error: ``what`` and the seconds since ``t0``."""
    print(f"at {time.perf_counter() - t0:.3f} s: {what}", file=sys.stderr,
          flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(sp: dict, c: dict, seed: int, seconds: float, trace: bool,
             device, t0: float, fault: str | None = None) -> dict:
    """Run the cell and assemble its result line (a dict; ``checks``,
    each compared number with its limit, comes last)."""
    name = c["workload"]["name"]
    loop = load_module(os.path.join(BENCH, "loops",
                                    c["traffic"]["loop"] + ".py"),
                       "bench_loop_" + c["traffic"]["loop"])
    res = loop.run(c, seed, seconds, trace, device, t0, fault=fault)
    if trace:
        metrics = read_metrics(per_layer(sp, name), res["ctx"])
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in end_to_end(sp, name)}
    checks = {k: {"value": v, "limit": c["limits"][k]}
              for k, v in res["checks"].items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": res["device_kind"], "count": 1,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": all(x["value"] <= x["limit"] for x in checks.values()),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = res["ctx"]["trace"]["busy_s"]
        dev["window_s"] = res["ctx"]["trace_window_s"]
        out["breakdown"] = res["ctx"]["trace"]["breakdown"]
    out["checks"] = checks
    return out


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sp = spec()
    c = cell(sp, args.workload)
    environment()
    import torch

    need = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(sp, c, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t0)
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, x in out["checks"].items():
        print(f"check {k} {x['value']!r} limit {x['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
