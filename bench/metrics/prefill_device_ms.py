"""``prefill_device_ms`` (ms per request): the device-side span of the
program's ``loco/serve/prefill`` range per traced request; the
in-program counterpart of ``prefill_ms``."""
from bench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "serve", "loco/serve/prefill")
