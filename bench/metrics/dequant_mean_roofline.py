"""``dequant_mean_roofline`` (%): the HBM bound of the traced
``dequant_mean`` calls (``bench/flops.dequant_bytes`` of each sync's
length) over their device time."""
from bench.trace import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "dequant_mean", "dequant")
