"""``device_idle.train`` (%): the share of the traced training steps' wall
time in which no operation ran on the card."""
from bench.trace import idle_share


def read(ctx):
    return idle_share(ctx) if ctx["kind"] == "train" else None
