"""``attention_roofline`` (%): the operations of the traced calls of
training's attention kernels (``bench/flops.attention_call_flops``) over
their device time, as a share of the card's bf16 peak.  Nothing to read
unless the calls counted are exactly the traced steps' attention calls
(``bench/flops.attention_calls``)."""
from bench import flops as FL
from bench.trace import kernel_calls


def read(ctx):
    s = ctx["trace"]
    if ctx["kind"] != "train" or s is None:
        return None
    c, t = ctx["config"], ctx["traffic"]
    work = ms = 0.0
    for kernel, calls in FL.attention_calls(c, t).items():
        k_ms, k_calls = kernel_calls(s, kernel)
        if not k_calls or k_calls != calls * ctx["trace_units"]:
            return None
        work += k_calls * FL.attention_call_flops(c, t, kernel)
        ms += k_ms
    return 100.0 * work / ctx["peaks"]["bf16_flops"] / (ms / 1e3)
