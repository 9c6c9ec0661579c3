"""Layer library of the dense decoder at ``tp = 1``.

Port of the training path of ``repro.models.common``: norms, the linears,
rotary embeddings, causal attention, embedding / logits / cross entropy and
the head layout.  Tensor parallelism is not ported yet, so the reference's
``model``-axis psums are the identity here and ``col_linear``/``row_linear``
are plain matmuls.

Attention is plain tensor ops: scores and softmax in f32 over bf16 inputs
that were scaled in f32 and rounded back to bf16, as the reference does
(``common.py`` blockwise attention).  With the keys in one block (the
reference's block is 512 keys) the result is the reference's online
softmax exactly; the port always takes one block.
"""
from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = -1e30


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm(x, scale, bias=None, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def norm(kind: str, x, scale, eps=1e-5):
    if kind == "rmsnorm":
        return rmsnorm(x, scale, eps)
    return layernorm(x, scale, None, eps)


# ---------------------------------------------------------------------------
# linears (tp = 1: the reference's column/row-parallel matmuls, no psum)
# ---------------------------------------------------------------------------

def col_linear(x, w):
    """(.., d) @ (d, f) -> (.., f)."""
    return x @ w


def row_linear(x, w):
    """(.., f) @ (f, d) -> (.., d)."""
    return x @ w


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, hd); positions: (S,) absolute positions.  Half-split
    layout: the first and second halves of each head rotate together."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs[None, :]         # (S, half)
    ang = ang[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# causal attention
# ---------------------------------------------------------------------------

def causal_attention(q, k, v, scale: float | None = None):
    """q, k, v: (B, S, H, hd) (k/v already expanded to the q heads) ->
    (B, S, H, hd) in q's dtype."""
    S, hd = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).to(q.dtype).transpose(1, 2)     # (B, H, S, hd)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    s = torch.matmul(qf.float(), kt.float().transpose(-1, -2))
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vt.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# embedding / logits / cross entropy
# ---------------------------------------------------------------------------

def embed(emb, ids):
    """emb: (V, d); ids: (B, S) token ids -> (B, S, d)."""
    return torch.nn.functional.embedding(ids, emb)


def logits(x, w_head):
    """x: (B, S, d); w_head: (d, V) -> (B, S, V)."""
    return x @ w_head


def xent(logits_, targets, vocab: int):
    """Mean cross entropy over (B, S) targets, in f32, with the reference's
    formulation: log-sum-exp around a max that carries no gradient."""
    lg = logits_.float()
    if lg.shape[-1] > vocab:  # padded vocab tail
        lg = lg.masked_fill(torch.arange(lg.shape[-1], device=lg.device)
                            >= vocab, NEG_INF)
    m = lg.amax(dim=-1).detach()
    se = torch.exp(lg - m[..., None]).sum(dim=-1)
    lse = m + torch.log(se)
    tl = torch.gather(lg, -1, targets[..., None])[..., 0]
    return torch.mean(lse - tl)


# ---------------------------------------------------------------------------
# head layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """Static resolution of GQA head padding / replication for a TP degree."""

    n_heads: int          # original q heads
    n_kv: int             # original kv heads
    head_dim: int
    tp: int
    h_pad: int            # padded q heads (multiple of tp)
    kv_pad: int           # padded kv heads (multiple of tp) if sharded
    kv_sharded: bool      # kv >= tp -> shard; else replicate

    @staticmethod
    def make(n_heads: int, n_kv: int, head_dim: int, tp: int) -> "HeadLayout":
        kv_sharded = n_kv >= tp
        if kv_sharded:
            kv_pad = pad_to_multiple(n_kv, tp)
            group = n_heads // n_kv
            h_pad = kv_pad * group
        else:
            kv_pad = n_kv
            h_pad = pad_to_multiple(n_heads, tp)
        return HeadLayout(n_heads, n_kv, head_dim, tp, h_pad, kv_pad,
                          kv_sharded)

    @property
    def hl(self) -> int:  # local q heads
        return self.h_pad // self.tp

    @property
    def kvl(self) -> int:  # local kv heads
        return self.kv_pad // self.tp if self.kv_sharded else self.n_kv

    def kv_map(self, device) -> torch.Tensor:
        """(hl,) indices into the local kv head axis for each local q head
        (tp = 1: kv heads are never replicated across ranks)."""
        group = self.n_heads // self.n_kv
        return torch.arange(self.hl, device=device) // group


def expand_kv(k, kv_map):
    """k: (B, S, KVl, hd) -> (B, S, Hl, hd) by gathering per-q-head kv."""
    if kv_map.shape[0] == k.shape[2]:
        return k  # one kv head per q head: the gather is the identity
    return torch.index_select(k, 2, kv_map)
