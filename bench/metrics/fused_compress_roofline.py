"""``fused_compress_roofline`` (%): the HBM bound of the traced
``fused_compress`` calls (``bench/flops.compress_bytes`` of each sync's
length) over their device time."""
from bench.trace import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "fused_compress", "compress")
