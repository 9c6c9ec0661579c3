"""``correct`` at a size the CPU holds: the program against the reference
on sound runs, and a run driven with the timed path broken underneath
(each fault a cell can have), or with the fp8 control in the program's
place, comes out not correct.  The harness's look for a card is skipped;
the rest of a run is the benchmark's own."""
import time

import pytest
import torch

from bench import harness
from bench.tests.tiny import tiny

SEED = 2**31 + 977
TRAIN = ["mixtral-8x7b.train-8k", "h2o-danube-1.8b.train-16k"]
SERVE = "h2o-danube-1.8b.serve-8k"


def run(workload, fault=None, seconds=0.0, trace=False, seed=SEED):
    return harness.run_cell(harness.spec(), tiny(workload), seed, seconds,
                            trace, torch.device("cpu"), time.perf_counter(),
                            fault=fault)


@pytest.mark.parametrize("workload", TRAIN + [SERVE])
def test_sound_run_is_correct(workload):
    out = run(workload, seconds=0.5 if workload == SERVE else 0.0)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["half_batch", "frozen"])
def test_train_fault_is_not_correct(workload, fault):
    out = run(workload, fault=fault)
    assert not out["correct"], out["checks"]


def test_served_token_altered_is_not_correct():
    out = run(SERVE, fault="token", seconds=0.5)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_fp8_control_in_the_programs_place_is_not_correct(workload):
    from bench import inputs
    from bench.loops import train as TL

    c = tiny(workload)
    t = dict(c["traffic"])
    batches = inputs.tokens(c["config"]["vocab"], t["n_clusters"],
                            (t["setup_steps"], t["global_batch"],
                             t["seq_len"] + 1), SEED, "cpu")
    ref = TL.reference(c["config"], t, SEED, "cpu", batches)
    ctl = TL.reference(c["config"], t, SEED, "cpu", batches, fp8=True)
    checks = TL.compare(ctl, ref)
    assert any(v > c["limits"][k] for k, v in checks.items()), checks


def test_serve_fp8_control_is_not_correct():
    from bench.loops import serve as SL

    c = tiny(SERVE)
    res = SL.run(c, SEED, 0.5, False, torch.device("cpu"),
                 time.perf_counter())
    gaps = SL.reference_gaps(c["config"], c["traffic"], SEED, "cpu",
                             res["served"], fp8=True)
    assert max(gaps) > c["limits"]["token_gap"], max(gaps)


def test_traced_run_reads_what_the_cpu_has():
    """A ``--trace 1`` run on the CPU: the host-clock and span readers
    find their numbers, the device ones (no card) return nothing; a
    host-paced cell reads its rate alone."""
    out = run(TRAIN[0], seconds=0.3, trace=True)
    m = out["metrics"]
    assert "train_mfu" in m and "sync_host_ms" in m
    assert "fused_compress_roofline" not in m
    assert "device_idle.train" not in m
    assert "train_tokens_per_s.host_paced" not in m
    assert out["device"]["busy_s"] == 0.0
    m = run(TRAIN[1], seconds=0.3, trace=True)["metrics"]
    assert list(m) == ["train_tokens_per_s.host_paced"]
