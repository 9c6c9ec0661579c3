"""``sync_host_ms`` (ms per step): host time in the program's
``loco/encode``, ``loco/exchange`` and ``loco/decode`` ranges (the
gradient sync of ``core/comm``) per traced step."""

PHASES = ("loco/encode", "loco/exchange", "loco/decode")


def read(ctx):
    s = ctx["trace"]
    if ctx["kind"] != "train" or s is None:
        return None
    ms = [v for k, v in s["host_ranges"].items()
          if any(k == p or k.startswith(p + "/") for p in PHASES)]
    return sum(ms) / ctx["trace_units"] if ms else None
