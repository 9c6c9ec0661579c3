"""The benchmark's arithmetic: model FLOPs of a step or a prefill, and the
bytes the LoCo kernels must move.

Model FLOPs count each matmul of the forward pass as 2 per multiply-add
(the embedding lookup is none, the output head is), an attention score
and its value product as ``4 * head_dim`` per visible (query, key) pair
and head, the causal window's pairs only, and a training step as three
forward passes (the backward is two), with no recomputation: the usual
definition of MFU.  A MoE layer counts the ``top_k`` experts a token
chooses and the router.

The operations of training's attention kernels count what the
algorithm needs (:data:`ATTENTION_HD`): the forward's scores and value
product at each forward call, the recomputation in the backward
included; the backward's scores, dP, dV, dK and dQ once, however the
kernels split them.  So their roofline share reads the same work
whatever implements them.

Kernel bytes are copies of the program's ``chip_smoke.compress_bytes``
and ``dequant_bytes``: each input read once and each output written
once.
"""
from __future__ import annotations

from bench.reference.model import leaves
from bench.reference.train import padded


def params_per_token(c: dict) -> tuple[int, int]:
    """(matmul parameters a token passes per layer, those of the head)."""
    d, H, KV, hd, f = (c["d_model"], c["n_heads"], c["n_kv_heads"],
                       c["head_dim"], c["d_ff"])
    attn = 2 * d * H * hd + 2 * d * KV * hd
    ffn = (c["top_k"] * 3 * d * f + d * c["n_experts"]
           if c.get("n_experts") else 3 * d * f)
    return attn + ffn, d * c["vocab"]


def pairs(S: int, window: int) -> int:
    """Visible (query, key) pairs of one causal sequence of S tokens."""
    w = min(S, window)
    return w * (w + 1) // 2 + (S - w) * w


def attn_flops(c: dict, S: int) -> int:
    """Forward FLOPs of one sequence's attention cores over all layers."""
    return 4 * c["n_heads"] * c["head_dim"] * pairs(S, c["window"]) \
        * c["n_layers"]


def train_step_flops(c: dict, seq_len: int, global_batch: int) -> int:
    layer, head = params_per_token(c)
    tokens = seq_len * global_batch
    fwd = 2 * (layer * c["n_layers"] + head) * tokens \
        + attn_flops(c, seq_len) * global_batch
    return 3 * fwd


def prefill_flops(c: dict, prompt_len: int, batch: int) -> int:
    """A prompt batch's prefill, the head on the last position only."""
    layer, head = params_per_token(c)
    return (2 * layer * c["n_layers"] * prompt_len * batch + 2 * head * batch
            + attn_flops(c, prompt_len) * batch)


# operations per visible (query, key) pair, head and unit of head_dim
# that one call of each of training's attention kernels is counted for:
# the scores and the value product forward; the backward's 10 (the
# scores, dP, dV, dK and dQ, 2 each), with dQ in dq and the rest in dk/dv
# (dq recomputes the scores and dP, which count once)
ATTENTION_HD = {"attention_fwd": 4, "attention_bwd_dq": 2,
                "attention_bwd_dkdv": 8}


def attention_calls(c: dict, t: dict) -> dict[str, int]:
    """The calls of each attention kernel one training step makes: per
    layer and microbatch, the forward, its recomputation in the backward,
    and one of each backward kernel."""
    per = c["n_layers"] * (t["global_batch"] // t["microbatch"])
    return {"attention_fwd": 2 * per, "attention_bwd_dq": per,
            "attention_bwd_dkdv": per}


def attention_call_flops(c: dict, t: dict, kernel: str) -> int:
    """Operations of one call of ``kernel`` at the step's microbatch."""
    return (ATTENTION_HD[kernel] * c["head_dim"] * c["n_heads"]
            * pairs(t["seq_len"], c["window"]) * t["microbatch"])


def compress_bytes(n: int, g_bytes: int = 2) -> float:
    """fused_compress at 4 bits with the f8 error: g and e read; payload,
    new e and scales written."""
    return n * g_bytes + n + n / 2 + n + n / 256 * 4


def dequant_bytes(n: int, D: int = 1, out_bytes: int = 2) -> float:
    """dequant_mean at 4 bits: D payload and scale rows read, the mean
    written."""
    return D * (n / 2 + n / 256 * 4) + n * out_bytes


def loco_lengths(c: dict, t: dict) -> list[int]:
    """The flat length of every LoCo sync one microbatch's backward makes
    (one per leaf and layer at or above ``loco_min_numel``)."""
    return [padded(lf.numel) for lf in leaves(c) for _ in range(lf.rows)
            if lf.numel >= t["loco_min_numel"]]
