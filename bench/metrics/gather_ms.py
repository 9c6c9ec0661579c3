"""``gather_ms`` (ms per step): the device-side span of the program's
``loco/gather`` ranges (``core/flatparam.materialize``: the bf16 cast and
the FSDP gather, in the forward and in remat's recomputation) per traced
step."""
from bench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train", "loco/gather")
