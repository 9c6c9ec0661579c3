"""``attention_ms`` reads the program's ``loco/attention`` span: its
device-side extent per traced training step, and None without the span
(a program whose training attention has no span), without a trace, or in
a serving cell."""
from bench import harness

SPEC = harness.spec()


def read(ctx):
    m = [x for x in SPEC["per_layer"] if x["name"] == "attention_ms"]
    got = harness.read_metrics(m, ctx)
    return got["attention_ms"]["value"] if "attention_ms" in got else None


def ctx(ranges, host_ranges=None, units=2, kind="train"):
    return {"kind": kind, "trace_units": units, "accum": 2,
            "traffic": {"sync": "loco"},
            "trace": {"busy_s": 1.0, "device_launches": 10, "kernels": {},
                      "ranges": dict(ranges),
                      "host_ranges": dict(host_ranges or {})}}


def test_attention_ms_is_the_span_per_step():
    spans = {"loco/attention": 300.0, "loco/forward": 700.0}
    assert read(ctx(spans)) == 150.0
    assert read(ctx(spans, units=3)) == 100.0


def test_attention_ms_is_none_without_the_span():
    assert read(ctx({"loco/forward": 700.0})) is None
    assert read(ctx({}, {"loco/attention": 300.0})) is None
    assert read(dict(ctx({"loco/attention": 300.0}), trace=None)) is None
    assert read(ctx({"loco/attention": 300.0}, kind="serve")) is None
