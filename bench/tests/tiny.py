"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files, loops and reference, with every size listed under ``reduced``.

The limits are this size's own: a cell's limits were set from its
readings on the card at its full size (PERF.md), and a model of width 128
rounds differently.  These were set from this size's readings on the
tests' seed: sound runs read at most 5.5e-4, 0.0057 and 0.0012 (loss,
first gradient, change), the fp8 control at least 1.27e-3, 0.0217 and
1.19e-3, half of the batch left out 8.1e-3, 0.048 and 0.0171; served
tokens 0.0 sound, 0.467 under the fp8 control, 2.2 with one altered."""
from bench import harness

SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab=1024, window=48)


def tiny(workload: str) -> dict:
    c = harness.cell(harness.spec(), workload)
    cfg = dict(c["config"], **SMALL)
    if cfg.get("n_experts"):
        cfg["n_experts"] = 4
    cfg["reduced"] = sorted(set(c["config"]["reduced"]) | set(SMALL)
                            | ({"n_experts"} if cfg.get("n_experts")
                               else set()))
    t = dict(c["traffic"])
    if t["loop"] == "train":
        t.update(seq_len=64, global_batch=4, microbatch=2, trace_steps=1,
                 pool_per_second=2)
    else:
        t.update(batch=2, prompt_len=96, decode_steps=4, check_requests=2,
                 pool_per_second=2)
    limits = ({"loss_gap": 1e-3, "grad1_gap": 0.015, "change_gap": 0.002}
              if t["loop"] == "train" else {"token_gap": 0.2})
    return dict(c, config=cfg, traffic=t, limits=limits)
