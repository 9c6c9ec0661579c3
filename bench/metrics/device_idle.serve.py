"""``device_idle.serve`` (%): the share of the traced requests' wall time in
which no operation ran on the card."""
from bench.trace import idle_share


def read(ctx):
    return idle_share(ctx) if ctx["kind"] == "serve" else None
