"""The window's record of how the host paced it (``bench/pacing.py``) and
the roofline share of training's attention kernels
(``bench/metrics/attention_roofline.py``)."""
import gc
import os
import statistics

import pytest

from bench import flops as FL
from bench import harness
from bench import pacing as PC
from bench.harness import load_module


def test_step_summary_quartiles_first_steps_and_outliers():
    times = [2.0, 1.5, 1.1, 1.0, 1.0, 1.3, 1.0, 1.0, 0.9, 1.0]
    s = PC.summary(times, 100.0, [])
    q1, med, q3 = statistics.quantiles(times, n=4)
    assert (s["count"], s["q1"], s["median"], s["q3"]) == (10, q1, med, q3)
    assert (s["min"], s["max"]) == (0.9, 2.0)
    assert s["first"] == [2.0, 1.5, 1.1]
    assert s["rest_median"] == 1.0
    # over 1.2 x the median (1.0): the first two steps and the sixth
    assert s["outliers"] == [0, 1, 5]
    assert s["gc"] == {} and s["gc_s_in_outliers"] == 0.0
    line = PC.line(s, times)
    assert line.startswith("window steps: 10, median 1.0000 s")
    assert f"cpus {sorted(os.sched_getaffinity(0))}" in line
    assert line.endswith("steps 2.0000 1.5000 1.1000 1.0000 1.0000 1.3000 "
                         "1.0000 1.0000 0.9000 1.0000")
    assert PC.summary([], 0.0, []) == {"count": 0}
    assert PC.line({"count": 0}, []) == "window steps: none"


def test_collections_fall_in_the_step_they_started_in():
    times = [1.0, 1.0, 2.5, 1.0]  # steps end at 11, 12, 14.5 and 15.5
    events = [(0, 10.2, 0.001), (2, 12.1, 0.8), (0, 13.0, 0.002),
              (1, 15.0, 0.01)]
    s = PC.summary(times, 10.0, events)
    # the stalled third step holds the full collection and one young one
    assert s["outliers"] == [2]
    assert s["gc_s_in_outliers"] == pytest.approx(0.802)
    assert s["gc"] == {0: [2, pytest.approx(0.003), 0.002],
                       1: [1, 0.01, 0.01], 2: [1, 0.8, 0.8]}


def test_collections_are_recorded_while_entered():
    with PC.Collections() as c:
        gc.collect(1)
    gc.collect(1)
    assert c not in gc.callbacks
    assert [g for g, _, _ in c.events] == [1]
    assert c.events[0][2] >= 0.0


ROOFLINE = load_module(os.path.join(harness.BENCH, "metrics",
                                    "attention_roofline.py"),
                       "bench_metric_attention_roofline_test")


def attn_ctx(window, kernels, units=1):
    c = {"n_layers": 2, "n_heads": 4, "head_dim": 16, "window": window}
    t = {"seq_len": 8, "global_batch": 6, "microbatch": 3}
    return {"kind": "train", "config": c, "traffic": t, "trace_units": units,
            "peaks": {"bf16_flops": 1e12},
            "trace": {"kernels": kernels, "busy_s": 1.0, "ranges": {},
                      "host_ranges": {}, "device_launches": 1}}


@pytest.mark.parametrize("window,pairs", [(8, 36), (3, 21)])
def test_attention_roofline_against_hand_counts(window, pairs):
    # seq 8: with no window query i sees i + 1 keys (36 pairs); with a
    # window of 3, 1 + 2 + 3 * 6 = 21.  Per call (microbatch 3, 4 heads
    # of 16): forward 4 x 16 per pair and head; the backward 10 x 16, its
    # dQ (2) in dq and its scores, dP, dV and dK (8) in dk/dv.
    per_pair = 3 * 4 * 16 * pairs
    calls = {"attention_fwd": 2 * 2 * 2, "attention_bwd_dq": 2 * 2,
             "attention_bwd_dkdv": 2 * 2}
    assert FL.attention_calls(attn_ctx(window, {})["config"],
                              attn_ctx(window, {})["traffic"]) == calls
    work = per_pair * (4 * 8 + 10 * 4)
    # half of the peak: the kernels took twice the bound's time
    ms = 2 * 1e3 * work / 1e12
    kernels = {"void attention_fwd_kernel<16>(Args)": [ms / 2, 8],
               "void attention_bwd_dq_kernel<16>(Args)": [ms / 4, 4],
               "void attention_bwd_dkdv_kernel<16>(Args)": [ms / 4, 4],
               "nvjet_tst_192x192": [5.0, 40]}
    assert ROOFLINE.read(attn_ctx(window, kernels)) == pytest.approx(50.0)


def test_attention_roofline_reads_only_the_steps_calls():
    full = {"attention_fwd_kernel<16>": [1.0, 8],
            "attention_bwd_dq_kernel<16>": [1.0, 4],
            "attention_bwd_dkdv_kernel<16>": [1.0, 4]}
    assert ROOFLINE.read(attn_ctx(8, full)) is not None
    # two traced steps need twice the calls
    assert ROOFLINE.read(attn_ctx(8, full, units=2)) is None
    short = dict(full, **{"attention_bwd_dq_kernel<16>": [1.0, 3]})
    assert ROOFLINE.read(attn_ctx(8, short)) is None
    assert ROOFLINE.read(attn_ctx(8, {})) is None
    ctx = attn_ctx(8, full)
    ctx["trace"] = None
    assert ROOFLINE.read(ctx) is None
    assert ROOFLINE.read(dict(attn_ctx(8, full), kind="serve")) is None


def test_window_times_whole_steps_back_to_back():
    from bench.loops import train as TL

    seen = []

    def step_fn(ts, step, batch):
        seen.append((step, batch["tokens"]))
        return {"loss": float("nan") if step == 5 else 1.0}

    feed = [10, 11, 12]
    times, t_start, events, failed = TL.window(step_fn, None, feed, 3, 0.05)
    assert len(times) >= 3 and failed == 1
    assert seen[:3] == [(3, 10), (4, 11), (5, 12)]
    assert len(seen) == len(times)
    # one step in flight: every loss but the last two was read in time
    assert sum(times) >= 0.05 and sum(times[:-2]) < 0.05
    assert TL.window(step_fn, None, feed, 3, 0.0)[0] == []


def test_window_reads_each_loss_steps_late_and_waits_for_all():
    """A step's loss is read once ``ahead`` more steps are out; when the
    time is up nothing more is sent, and the window ends after the last
    loss in flight is read."""
    from bench.loops import train as TL

    log = []

    class Loss:
        def __init__(self, step):
            self.step = step

        def __float__(self):
            log.append(("read", self.step))
            return 1.0

    def step_fn(ts, step, batch):
        log.append(("sent", step))
        return {"loss": Loss(step)}

    times, _, _, failed = TL.window(step_fn, None, [0], 0, 0.05, ahead=3)
    n = len(times)
    assert n > 3 and failed == 0 and sum(times) >= 0.05
    assert [s for k, s in log if k == "sent"] == list(range(n))
    assert [s for k, s in log if k == "read"] == list(range(n))
    for s in range(n - 3):
        assert log.index(("read", s)) > log.index(("sent", s + 3))
    # the last step sent, the loss three before it read, then the three
    # in flight
    assert log[-5:] == [("sent", n - 1)] + [("read", s)
                                             for s in range(n - 4, n)]


@pytest.mark.parametrize("step_s,ahead", [(0.345, 12), (1.4, 3), (4.0, 1),
                                          (9.0, 1), (0.0, 1)])
def test_ahead_steps_cover_ahead_seconds(step_s, ahead):
    from bench.loops import train as TL

    assert TL.ahead_steps(step_s) == ahead
    if 0 < step_s <= TL.AHEAD_S:
        assert TL.AHEAD_S <= ahead * step_s < TL.AHEAD_S + step_s


def test_setup_is_frozen_for_the_window_only():
    """Set-up's objects are out of the collector's reach in the window
    (and the traced steps), and back in it for the reference."""
    import time

    import torch

    from bench.loops import train as TL
    from bench.tests.tiny import tiny

    frozen, real = [], TL.window

    def window(*a):
        frozen.append(gc.get_freeze_count())
        return real(*a)

    before = gc.get_freeze_count()
    TL.window = window
    try:
        res = TL.run(tiny("h2o-danube-1.8b.train-16k"), 2**31 + 977, 0.2,
                     False, torch.device("cpu"), time.perf_counter())
    finally:
        TL.window = real
    assert frozen and frozen[0] > before
    assert gc.get_freeze_count() <= before
    steps = res["ctx"]["steps"]
    assert steps["count"] == res["ctx"]["window_steps"] >= 1
    assert steps["ahead"] >= 1
    assert steps["min"] <= steps["median"] <= steps["max"]
    assert res["ctx"]["window_s"] >= 0.2


def test_host_paced_rate_is_the_window_tokens_over_its_time():
    rate = load_module(os.path.join(harness.BENCH, "metrics",
                                    "train_tokens_per_s.host_paced.py"),
                       "host_paced").read
    t = {"global_batch": 8, "seq_len": 2048}
    ctx = {"kind": "train", "traffic": t, "window_steps": 15,
           "window_s": 20.5}
    assert rate(ctx) == 15 * 8 * 2048 / 20.5
    assert rate(dict(ctx, window_steps=0)) is None
    assert rate(dict(ctx, kind="serve")) is None
