"""``decode_ms_per_step`` (ms): the window's decode wall time over its
decode steps."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["decode_s"]:
        return None
    return 1e3 * sum(ctx["decode_s"]) / (len(ctx["decode_s"])
                                         * ctx["decode_steps"])
