"""The readings that a cell's limits are set from, on the card.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control 4,5,6] [--fault half_batch:7,8,9] [--seconds S]

For each of ``--seeds`` it runs the cell as a benchmark run does, with a
window of ``--seconds`` (0 for a training cell: its readings need none),
and prints the numbers it compares with the reference.  ``--control``
seeds read the control instead: the reference itself, computed with fp8
matmul inputs, in the program's place (training: its steps against the
float32 reference's; serving: at each position of the program's served
sequences, the gap of the token that fp8 ranks first).  ``--fault
kind:seeds`` plants a fault in the program (``half_batch``: half of the
rows left out and the mean taken over the rest; ``frozen``: a step that
returns its state unchanged; ``token``: a served token altered where it
is produced).  Every reading is one JSON line on standard output.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench import harness  # noqa: E402


def control_train(c, seed, device):
    from bench import inputs
    from bench.loops import train as TL

    t = dict(c["traffic"], max_seconds=1)
    B, S = t["global_batch"], t["seq_len"]
    batches = inputs.tokens(c["config"]["vocab"], t["n_clusters"],
                            (t["setup_steps"], B, S + 1), seed, device)
    ref = TL.reference(c["config"], t, seed, device, batches)
    ctl = TL.reference(c["config"], t, seed, device, batches, fp8=True)
    return TL.compare(ctl, ref)


def control_serve(c, seed, device, seconds):
    from bench.loops import serve as SL

    res = SL.run(c, seed, seconds, False, device, time.perf_counter())
    gaps = SL.reference_gaps(c["config"], c["traffic"], seed, device,
                             res["served"], fp8=True)
    return {"token_gap": max(gaps)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    harness.environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    sp = harness.spec()
    c = harness.cell(sp, args.workload)
    serve = c["traffic"]["loop"] == "serve"
    jobs = [("program", int(s)) for s in args.seeds.split(",") if s]
    jobs += [("control", int(s)) for s in args.control.split(",") if s]
    for f in args.fault:
        kind, seeds = f.split(":")
        jobs += [(kind, int(s)) for s in seeds.split(",") if s]
    for mode, seed in jobs:
        t0 = time.perf_counter()
        line = {"workload": args.workload, "mode": mode, "seed": seed,
                "card": harness.card_line()}
        if mode == "control":
            line["checks"] = (control_serve(c, seed, device, args.seconds)
                              if serve else control_train(c, seed, device))
        else:
            out = harness.run_cell(sp, c, seed, args.seconds, False, device,
                                   t0, fault=None if mode == "program"
                                   else mode)
            line["checks"] = {k: v["value"] for k, v in out["checks"].items()}
            line["metrics"] = {k: v["value"]
                               for k, v in out["metrics"].items()}
            line["memory_peak_bytes"] = out["device"]["memory_peak_bytes"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
