"""``backward_ms`` (ms per step): the device-side span of the program's
``loco/backward`` ranges (each microbatch's backward, its recomputed
forward and the gradient sync inside) per traced step."""
from bench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train", "loco/backward")
