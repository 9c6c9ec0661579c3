"""``apply_ms`` (ms per step): the GPU-side span of the program's
``loco/apply`` range (the optimizer update) per traced step."""


def read(ctx):
    s = ctx["trace"]
    if ctx["kind"] != "train" or s is None or "loco/apply" not in s["ranges"]:
        return None
    return s["ranges"]["loco/apply"] / ctx["trace_units"]
