"""``prefill_ms`` (ms): the mean wall time of a request's prefill (to its
first token) over the window's requests."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["prefill_s"]:
        return None
    return 1e3 * sum(ctx["prefill_s"]) / len(ctx["prefill_s"])
