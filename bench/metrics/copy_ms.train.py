"""``copy_ms.train`` (ms per step): device time of the dtype copies and
memcpys (``bench/trace.kernel_class``) per traced training step."""
from bench.trace import class_ms


def read(ctx):
    s = ctx["trace"]
    if ctx["kind"] != "train" or s is None or not s["device_launches"]:
        return None
    return class_ms(s, "dtype copies and memcpy") / ctx["trace_units"]
