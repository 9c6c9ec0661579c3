"""``train_mfu`` (%): the model FLOPs of the window's steps (``bench/flops``)
over its wall time, as a share of the card's bf16 peak."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["window_steps"]:
        return None
    rate = ctx["flops_per_step"] * ctx["window_steps"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["bf16_flops"]
