"""Plain float32 PyTorch reference of the benchmark's decoders.

A decoder-only transformer as its papers describe it (Mistral's layout:
pre-norm RMSNorm blocks, rotary embeddings in the half-split layout,
grouped-query attention with a causal sliding window, a SwiGLU MLP or a
top-k mixture of SwiGLU experts, an untied output head), written from the
configuration file alone.  Nothing here imports ``jax``, the JAX package
or the program under test.

The mixture of experts follows what the measured program states for its
``tp_dense`` schedule (the configuration's ``capacity_factor``): softmax
router in float32, the top-k probabilities renormalised, each expert
taking at most ``ceil(T * k / E * capacity_factor)`` of a microbatch's T
tokens in the order of (token, choice), the rest dropped; the Switch
load-balance loss and the router z-loss, weighted by the configuration.

``fp8=True`` is the benchmark's control: every linear layer's two inputs
are rounded to float8_e4m3 with one scale per tensor (its absolute
maximum at 448) in the forward pass, as an fp8 matmul would take them;
gradients pass straight through.  Everything else stays float32.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

F8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight tensor: ``shape`` per layer, ``layers`` (None: not
    stacked), how it is drawn (``ones`` or ``normal`` with ``scale``) and
    whether Adam's L2 term decays it."""

    group: str
    name: str
    shape: tuple
    layers: int | None
    init: str
    scale: float
    decay: bool

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def rows(self) -> int:
        return self.layers or 1


def leaves(c: dict) -> list[Leaf]:
    """The weights of configuration ``c`` (a configuration file's dict)."""
    d, H, KV, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    f, V, L = c["d_ff"], c["vocab"], c["n_layers"]

    def mat(group, name, shape, layers=L):
        return Leaf(group, name, tuple(shape), layers, "normal",
                    1.0 / math.sqrt(shape[-2]), True)

    def ones(group, name, layers=L):
        return Leaf(group, name, (d,), layers, "ones", 1.0, False)

    out = [Leaf("embed", "tok", (V, d), None, "normal", 0.02, True),
           ones("final", "norm_f", None), mat("final", "head", (d, V), None),
           ones("block", "norm1"), mat("block", "wq", (d, H * hd)),
           mat("block", "wk", (d, KV * hd)), mat("block", "wv", (d, KV * hd)),
           mat("block", "wo", (H * hd, d)), ones("block", "norm2")]
    if c.get("n_experts"):
        E = c["n_experts"]
        out += [mat("block", "router", (d, E)),
                mat("block", "w1", (E, d, f)), mat("block", "w2", (E, f, d)),
                mat("block", "w3", (E, d, f))]
    else:
        out += [mat("block", "w1", (d, f)), mat("block", "w2", (f, d)),
                mat("block", "w3", (d, f))]
    return out


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3 under one per-tensor scale, with a
    straight-through gradient."""
    xd = x.detach()
    s = F8_MAX / xd.abs().amax().clamp(min=1e-30)
    y = (xd * s).to(torch.float8_e4m3fn).float() / s
    return x + (y - xd)


class Decoder:
    """The reference forward passes over float32 weights ``W``:
    ``{(group, name): tensor}``, a stacked leaf ``(layers, *shape)``."""

    def __init__(self, c: dict, fp8: bool = False, q_block: int = 1024):
        self.c, self.fp8, self.q_block = c, fp8, q_block
        self.hd = c["head_dim"]
        self.rep = c["n_heads"] // c["n_kv_heads"]

    def mm(self, a, w):
        return q8(a) @ q8(w) if self.fp8 else a @ w

    def norm(self, x, s):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["norm_eps"]) * s

    def rope(self, x, pos):
        half = self.hd // 2
        freqs = 1.0 / (self.c["rope_theta"] ** (
            torch.arange(half, dtype=torch.float64, device=x.device) / half))
        ang = (pos.double()[:, None] * freqs[None])[None, :, None]
        cos, sin = ang.cos().float(), ang.sin().float()
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, p, x, pos):
        """Causal attention of positions ``pos`` (consecutive, from 0) over
        themselves within the window, in blocks of ``q_block`` queries."""
        B, S, _ = x.shape
        H, KV, hd, win = (self.c["n_heads"], self.c["n_kv_heads"], self.hd,
                          self.c["window"])
        q = self.rope(self.mm(x, p["wq"]).view(B, S, H, hd), pos)
        k = self.rope(self.mm(x, p["wk"]).view(B, S, KV, hd), pos)
        v = self.mm(x, p["wv"]).view(B, S, KV, hd)
        q = q.transpose(1, 2) / math.sqrt(hd)
        k = k.repeat_interleave(self.rep, 2).transpose(1, 2)
        v = v.repeat_interleave(self.rep, 2).transpose(1, 2)
        outs = []
        for q0 in range(0, S, self.q_block):
            q1 = min(S, q0 + self.q_block)
            k0 = max(0, q0 - win + 1)
            s = q[:, :, q0:q1] @ k[:, :, k0:q1].transpose(-1, -2)
            qp, kp = pos[q0:q1, None], pos[None, k0:q1]
            s = s.masked_fill((kp > qp) | (kp <= qp - win), float("-inf"))
            outs.append(torch.softmax(s, -1) @ v[:, :, k0:q1])
        o = torch.cat(outs, 2).transpose(1, 2).reshape(B, S, H * hd)
        return self.mm(o, p["wo"])

    def mlp(self, p, x):
        h = torch.nn.functional.silu(self.mm(x, p["w1"])) * self.mm(x, p["w3"])
        return self.mm(h, p["w2"]), None, None

    def moe(self, p, x):
        c = self.c
        B, S, d = x.shape
        E, k = c["n_experts"], c["top_k"]
        x2 = x.reshape(B * S, d)
        T = x2.shape[0]
        logits = self.mm(x2, p["router"])
        probs = torch.softmax(logits, -1)
        topv, topi = probs.topk(k, -1)
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = max(1, math.ceil(T * k / E * c["capacity_factor"]))
        y = torch.zeros_like(x2)
        flat_e = topi.reshape(-1)          # choice (t, j) at t * k + j
        for e in range(E):
            idx = (flat_e == e).nonzero()[:, 0][:cap]
            if idx.numel() == 0:
                continue
            tok, j = idx // k, idx % k
            xe = x2[tok]
            he = (torch.nn.functional.silu(self.mm(xe, p["w1"][e]))
                  * self.mm(xe, p["w3"][e]))
            ye = self.mm(he, p["w2"][e]) * topv[tok, j][:, None]
            y = y.index_add(0, tok, ye)
        frac = torch.bincount(flat_e, minlength=E).float() / (T * k)
        aux = E * (frac * probs.mean(0)).sum()
        z = (torch.logsumexp(logits, -1) ** 2).mean()
        return y.view(B, S, d), aux, z

    def layer(self, p, x, pos):
        x = x + self.attention(p, self.norm(x, p["norm1"]), pos)
        ffn = self.moe if self.c.get("n_experts") else self.mlp
        y, aux, z = ffn(p, self.norm(x, p["norm2"]))
        zero = x.new_zeros(())
        return x + y, zero if aux is None else aux, zero if z is None else z

    def hidden(self, W, tokens, remat: bool = False):
        """tokens (B, S) -> (final normed hidden (B, S, d), router aux, z)
        summed over layers."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = W[("embed", "tok")][tokens]
        aux = z = x.new_zeros(())
        names = [n for (g, n) in W if g == "block"]
        for l in range(self.c["n_layers"]):
            p = {n: W[("block", n)][l] for n in names}
            if remat:
                x, a, zz = checkpoint(self.layer, p, x, pos,
                                      use_reentrant=False)
            else:
                x, a, zz = self.layer(p, x, pos)
            aux, z = aux + a, z + zz
        return self.norm(x, W[("final", "norm_f")]), aux, z

    def loss(self, W, tokens, remat: bool = True):
        """Mean next-token cross entropy of ``tokens`` (B, S + 1) plus the
        weighted router losses: the training objective."""
        h, aux, z = self.hidden(W, tokens[:, :-1], remat)
        logits = self.mm(h, W[("final", "head")])
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        if self.c.get("n_experts"):
            ce = ce + self.c["aux_loss_coef"] * aux \
                + self.c["router_z_coef"] * z
        return ce

    @torch.no_grad()
    def last_logits(self, W, tokens, n: int):
        """Logits (B, n, V) of the last ``n`` positions of ``tokens``."""
        h, _, _ = self.hidden(W, tokens)
        return self.mm(h[:, -n:], W[("final", "head")])


def no_tf32():
    """Float32 matmuls in float32: TF32 off for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
