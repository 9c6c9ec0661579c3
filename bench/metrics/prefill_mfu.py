"""``prefill_mfu`` (%): a prefill's model FLOPs (``bench/flops``) over its
mean wall time in the window, as a share of the card's bf16 peak."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["prefill_s"]:
        return None
    mean_s = sum(ctx["prefill_s"]) / len(ctx["prefill_s"])
    return 100.0 * ctx["prefill_flops"] / mean_s / ctx["peaks"]["bf16_flops"]
