"""``decode_host_ms`` (ms per decode step): host time in the program's
``loco/serve/decode`` ranges per traced decode step; the in-program
counterpart of ``decode_ms_per_step``."""
from bench.spans import host_ms


def read(ctx):
    ms = host_ms(ctx, "serve", "loco/serve/decode")
    return None if ms is None else ms / ctx["decode_steps"]
