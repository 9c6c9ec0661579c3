"""``attention_ms`` (ms per step): the device-side span of the program's
``loco/attention`` ranges (training's attention, forward, remat and
backward) per traced step."""
from bench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train", "loco/attention")
