"""``clip_ms`` (ms per step): the device-side span of the program's
``loco/clip`` range (the gradient stack and mean over the microbatches,
the global norm and the clip multiply) per traced step."""
from bench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train", "loco/clip")
