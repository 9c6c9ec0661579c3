"""``forward_ms`` (ms per step): the device-side span of the program's
``loco/forward`` ranges (each microbatch's loss) per traced step."""
from bench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train", "loco/forward")
