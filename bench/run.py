"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics; the last line of standard
output is the result as one JSON object, and the last lines of standard
error are the numbers compared with the reference, each beside its limit.
Without a card (or with fewer than the cell asks for) it exits 2 and
prints no result.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
