"""``train_tokens_per_s.host_paced`` (tokens/s): the window's tokens over
its wall time, as ``train_tokens_per_s`` takes them, in a cell whose step
the host paces: there the rate follows the host's speed from run to run
by more than a bound can hold, so it is read here and judged nowhere."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["window_steps"]:
        return None
    t = ctx["traffic"]
    return (ctx["window_steps"] * t["global_batch"] * t["seq_len"]
            / ctx["window_s"])
