"""The readers of the program's phase spans and allocator counter, on
synthetic trace summaries: each metric's arithmetic per step or per
request, None where its span or counter is missing or the cell is of the
other kind, and the sync and update metrics unmoved by the new names."""
import sys
import types

import pytest

from bench import harness
from bench.spans import PROFILER

SPEC = harness.spec()
NEW = {"forward_ms": "loco/forward", "backward_ms": "loco/backward",
       "gather_ms": "loco/gather", "clip_ms": "loco/clip"}
SERVE = ("prefill_device_ms", "decode_host_ms")


def read(name, ctx):
    m = [x for x in SPEC["per_layer"] if x["name"] == name]
    got = harness.read_metrics(m, ctx)
    return got[name]["value"] if name in got else None


def train_ctx(ranges, host_ranges=None, units=2):
    return {"kind": "train", "trace_units": units, "accum": 2,
            "traffic": {"sync": "loco"},
            "trace": {"busy_s": 1.0, "device_launches": 10, "kernels": {},
                      "ranges": dict(ranges),
                      "host_ranges": dict(host_ranges or {})}}


def serve_ctx(ranges, host_ranges, units=1, decode_steps=16):
    return dict(train_ctx(ranges, host_ranges, units), kind="serve",
                decode_steps=decode_steps)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_train_span_per_step(metric):
    ctx = train_ctx({NEW[metric]: 30.0, "loco/apply": 5.0})
    assert read(metric, ctx) == 15.0
    assert read(metric, train_ctx({NEW[metric]: 30.0}, units=3)) == 10.0
    # the host time is not the device span
    assert read(metric, train_ctx({}, {NEW[metric]: 30.0})) is None
    assert read(metric, train_ctx({"loco/apply": 5.0})) is None
    assert read(metric, dict(ctx, trace=None)) is None
    assert read(metric, serve_ctx({NEW[metric]: 30.0}, {})) is None


def test_serve_spans_per_request_and_decode_step():
    ctx = serve_ctx({"loco/serve/prefill": 3960.0,
                     "loco/serve/decode": 100.0},
                    {"loco/serve/prefill": 50.0,
                     "loco/serve/decode": 640.0})
    assert read("prefill_device_ms", ctx) == 3960.0
    assert read("decode_host_ms", ctx) == 40.0
    two = serve_ctx({"loco/serve/prefill": 7920.0},
                    {"loco/serve/decode": 1280.0}, units=2)
    assert read("prefill_device_ms", two) == 3960.0
    assert read("decode_host_ms", two) == 40.0
    for name in SERVE:
        assert read(name, serve_ctx({}, {})) is None
        assert read(name, dict(ctx, trace=None)) is None
        assert read(name, dict(ctx, kind="train")) is None


def test_alloc_calls_reads_the_programs_counter(monkeypatch):
    ctx = train_ctx({})
    prof = types.ModuleType(PROFILER)
    monkeypatch.setitem(sys.modules, PROFILER, prof)
    # a program without the counter (or before it counted anything)
    assert read("alloc_calls", ctx) is None
    prof.COUNTERS = {}
    assert read("alloc_calls", ctx) is None
    prof.COUNTERS = {"num_alloc_retries": 0, "num_device_alloc": 0,
                     "num_device_free": 0}
    assert read("alloc_calls", ctx) == 0.0
    prof.COUNTERS = {"num_alloc_retries": 1, "num_device_alloc": 6,
                     "num_device_free": 3}
    assert read("alloc_calls", ctx) == 5.0
    assert read("alloc_calls", dict(ctx, trace=None)) is None
    assert read("alloc_calls", serve_ctx({}, {})) is None
    monkeypatch.delitem(sys.modules, PROFILER)
    assert read("alloc_calls", ctx) is None


def test_sync_and_apply_unmoved_by_new_names():
    base_host = {"loco/encode": 10.0, "loco/exchange": 4.0,
                 "loco/decode": 6.0, "loco/exchange/g0": 2.0,
                 "loco/apply": 1.0}
    base_dev = {"loco/apply": 107.6, "loco/encode": 3.0}
    new = {"loco/forward": 90.0, "loco/backward": 170.0,
           "loco/gather": 60.0, "loco/clip": 12.0,
           "loco/serve/prefill": 3960.0, "loco/serve/decode": 40.0}
    for name in ("sync_host_ms", "apply_ms"):
        plain = read(name, train_ctx(base_dev, base_host))
        both = read(name, train_ctx({**base_dev, **new},
                                    {**base_host, **new}))
        assert plain is not None and plain == both
    assert read("sync_host_ms", train_ctx(base_dev, base_host)) == 11.0
    # and no new name falls under the sync's phases or is the update's
    for n in new:
        assert n != "loco/apply"
        assert not any(n == p or n.startswith(p + "/")
                       for p in ("loco/encode", "loco/exchange",
                                 "loco/decode"))
