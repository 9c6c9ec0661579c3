"""Manual-tensor-parallel layer library of the decoder.

Port of the training path of ``repro.models.common``: norms, the parallel
linears, rotary embeddings, attention (causal, windowed, or over every
key), the vocab-parallel embedding / logits / cross entropy, the head
layout, and the ``model`` group collectives of Megatron-style tensor and
sequence parallelism.

Conventions (the reference's): activations ``(B, S, d)`` are replicated
over the ``model`` group, or under sequence parallelism (``sp``) each rank
holds the ``(B, S/tp, d)`` sequence shard between blocks; weights are
TP-sharded by their ``ParamInfo.tp_dim``; a column-parallel matmul gives
local features, a row-parallel one partial sums, finished by one psum (or
under ``sp`` one reduce-scatter over the sequence) per block.  Every
collective takes the ``model`` process group; a ``group`` of None means
``tp = 1``, where the functions issue no collective at all.

The collectives are ``torch.autograd.Function``s whose backward is the
transpose the reference's ``shard_map`` (``check_vma=False``) gives each
forward:

=========================  ===========================
forward                    backward
all-gather (sequence)      reduce-scatter (sequence)
reduce-scatter (sequence)  all-gather (sequence)
psum                       psum
=========================  ===========================

and ``hijack.replicated_grad_psum`` (identity forward, psum backward) for
the TP-replicated weights.  So, as in the reference, a rank's gradient is
that of the sum of the ``tp`` ranks' losses (each rank's loss is the full
loss: ``tp`` times its gradient, clipped by the global norm).
``torch.distributed``'s tensor collectives split dim 0, so a sequence
(dim 1) collective moves that axis to the front and makes it contiguous.

Attention: scores and softmax in f32 over bf16 inputs that were scaled in
f32 and rounded back to bf16, as the reference does (``common.py``
blockwise attention).  Training's :func:`attention` takes the fused
kernels of :mod:`repro_torch.kernels.attention` (an online softmax over
key tiles, on the card) where their rule allows, and otherwise, as their
plain version does on the CPU, every key in one block, where the
reference's online softmax takes 512-key blocks (ROADMAP.md C).

Serving runs the reference's online softmax, :func:`blockwise_attention`,
over absolute query and key positions (a key slot at position -1 is
empty): a prompt in 512-key blocks and query tiles
(:func:`prefill_attention`), a decode step in one block over its cache
(:func:`attention_at`).  Serving also adds the ring
:class:`KVCache` and the context-parallel cache of the reference
(``build_cp_cache``, ``cp_append``, ``cp_decode_attention``): when kv
heads are fewer than tp, each model rank keeps ``W / tp`` slots of the
window, and a decode step merges the ranks' softmax statistics.  They
run under ``torch.inference_mode`` and need no autograd.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist

from repro_torch.core.comm import all_gather_flat, psum_scatter_flat
from repro_torch.kernels import attention as KA
from repro_torch.telemetry.profiler import phase

NEG_INF = -1e30


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if torch.is_inference_mode_enabled():
        # serving: the same products in place on one f32 copy of x (a
        # 32,768-token prompt's norm held three)
        xf = x.to(torch.float32, copy=True) if xf is x else xf
        return xf.mul_(torch.rsqrt(var + eps)).mul_(scale.float()).to(
            x.dtype)
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
# model-group collectives
# ---------------------------------------------------------------------------

def tp_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def tp_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather(x, dim: int, group):
    """All-gather along ``dim`` in rank order."""
    return all_gather_flat(x.movedim(dim, 0), group).movedim(0, dim)


def _scatter(x, dim: int, group):
    """Sum over the group, keeping this rank's block of ``dim``."""
    return psum_scatter_flat(x.movedim(dim, 0), group).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def _all_reduce(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum_tp(x, group):
    """Sum over the ``model`` group (backward: the sum of the gradients)."""
    return _Psum.apply(x, group)


def all_gather_tp(x, group, dim: int = 0):
    """All-gather along ``dim`` over the ``model`` group (backward: the
    reduce-scatter)."""
    return _AllGather.apply(x, dim, group)


def sp_gather(x, group):
    """(B, S/tp, d) activation shard -> (B, S, d) (sequence-parallel
    entry of a block, and exit before the final norm)."""
    return _AllGather.apply(x, 1, group)


def sp_scatter_sum(x_partial, group):
    """Partial (B, S, d) -> summed (B, S/tp, d) shard."""
    return _ReduceScatter.apply(x_partial, 1, group)


# ---------------------------------------------------------------------------
# parallel linears (no bias, per the ported archs)
# ---------------------------------------------------------------------------

def col_linear(x, w):
    """(.., d) @ (d, f_local) -> (.., f_local); purely local."""
    return x @ w


def row_linear(x_local, w, group=None, sp: bool = False):
    """(.., f_local) @ (f_local, d) -> (.., d), finished over the model
    group by a psum or, under ``sp``, a reduce-scatter over the sequence
    (the caller's S/tp shard); at ``tp = 1`` (``group`` None) the plain
    matmul."""
    y = x_local @ w
    if group is None:
        return y
    return sp_scatter_sum(y, group) if sp else psum_tp(y, group)


def activation(kind: str, a, b=None):
    """The MLP's activation (``repro.models.moe._activation``):
    ``silu(a) * b`` (swiglu), ``gelu(a) * b`` (geglu), ``gelu(a)`` (gelu);
    GELU is JAX's default, the tanh approximation."""
    if kind == "swiglu":
        return torch.nn.functional.silu(a) * b
    g = torch.nn.functional.gelu(a, approximate="tanh")
    return g * b if kind == "geglu" else g


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
# scalar scales and soft caps, with the reference's rounding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rounded(s: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(s, dtype=torch.float32).to(dtype))


def scale_by(x, s: float):
    """``x * s`` as the reference computes it: JAX rounds a Python scalar to
    the array's dtype (weak typing) before it multiplies, so a bf16
    activation is multiplied by ``s`` rounded to bf16 (``4608 ** 0.5`` is
    68.0 there).  The rounded value is exact in the f32 that torch computes
    a bf16 product in, on the CPU and on the card alike."""
    return x * _rounded(s, x.dtype)


# XLA's f32 tanh on the CPU (the reference's): a [13/6] rational
# approximation, its two Horner loops in fused multiply-adds, the input
# clamped where the approximation reaches +-1 and passed through below
# 4e-4.
_TANH_CLAMP = 7.99881172180175781
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)


def _fma(a, b, c):
    """f32 ``a * b + c`` as XLA's CPU code contracts it into one fused
    multiply-add: the product is exact in f64, and the f64 sum rounded to
    f32 is the fused result but where the two roundings tie (the
    reference's bits on 10^6 inputs, tests/test_torch_archs.py).  One
    ``addcmul`` pass computes in f64 (``a`` is made f64, so the inputs
    promote) and writes f32."""
    a = a.double()
    if not isinstance(c, torch.Tensor):
        c = torch.full((), c, dtype=torch.float64, device=a.device)
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.float32, device=a.device)
    return torch.addcmul(c, a, b, out=out)


def _horner(x2d, coeffs):
    """The polynomial in f32 fused multiply-adds (f32 coefficients) at
    ``x2d``, the f32 argument held in f64 (shared by both loops)."""
    acc = torch.full_like(x2d, coeffs[0], dtype=torch.float32)
    for c in coeffs[1:]:
        acc = _fma(x2d, acc, _rounded(c, torch.float32))
    return acc


def _xla_tanh(x):
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2d = (xc * xc).double()
    num = xc * _horner(x2d, _TANH_NUM)
    return torch.where(x.abs() < 4e-4, x, num / _horner(x2d, _TANH_DEN))


class _Tanh(torch.autograd.Function):
    """f32 tanh with the reference's bits (every op IEEE, so the card gives
    the CPU's) and its backward as JAX transposes tanh's derivative and
    XLA fuses it: ``t = g * (1 - y)``, then ``fma(t, y, t)``."""

    @staticmethod
    def forward(ctx, x):
        y = _xla_tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        t = g * (1 - y)
        return _fma(t, y, t)


def soft_cap(x, cap: float):
    """``cap * tanh(x / cap)``, as the reference computes it: XLA divides by
    a constant as a multiply by its f32 reciprocal, and its tanh is
    :func:`_xla_tanh`.  On a bf16 ``x`` (the decode step's final cap, which
    the reference takes on its bf16 logits) each of the three results is
    rounded to bf16, as XLA rounds them there; no gradient."""
    inv = _rounded(1.0 / cap, torch.float32)
    if x.dtype == torch.float32:
        return cap * _Tanh.apply(x * inv)
    y = (x.float() * inv).to(x.dtype)
    t = _xla_tanh(y.float()).to(x.dtype)
    return (t.float() * _rounded(cap, x.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _normalize(q, l, acc):
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, causal: bool = True, window: int | None = None,
              softcap: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, H, hd) (already expanded to the q
    heads) -> (B, Sq, H, hd) in q's dtype.  ``causal``: query i sees keys
    j <= i (positions 0..S-1 on both sides, so Sk == Sq); otherwise every
    key (encoder self-attention, cross-attention with Sk != Sq).
    ``window`` (causal only): query i sees keys j with ``i - window < j <=
    i`` (``window`` keys, its own included); ``softcap``: the f32 scores
    are soft-capped (:func:`soft_cap`) before the mask.  Causal bf16
    attention without a soft cap over q, k, v of one shape with a head dim
    the kernels take goes to :func:`repro_torch.kernels.attention.attention`
    (``takes``); every other call is every key in one block of
    :func:`blockwise_attention` (ROADMAP.md C).  Inside span
    ``loco/attention``."""
    with phase("attention"):
        if KA.takes(q, k, v, causal, softcap):
            return KA.attention(q, k, v, window)
        q_pos, k_pos = (torch.arange(x.shape[1], device=q.device)
                        for x in (q, k))
        return blockwise_attention(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, softcap=softcap,
                                   block_k=k.shape[1])


# ---------------------------------------------------------------------------
# vocab-parallel embedding / logits / cross entropy
# ---------------------------------------------------------------------------

def vocab_parallel_embed(emb, ids, group=None, sp: bool = False):
    """emb: (V_local, d) local slice; ids: (B, S) global token ids ->
    (B, S, d), or under ``sp`` the (B, S/tp, d) sequence shard."""
    if group is None:
        return torch.nn.functional.embedding(ids, emb)
    vl = emb.shape[0]
    local = ids - tp_rank(group) * vl
    ok = (local >= 0) & (local < vl)
    e = torch.nn.functional.embedding(local.clamp(0, vl - 1), emb)
    e = torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                  device=e.device))
    return sp_scatter_sum(e, group) if sp else psum_tp(e, group)


def vocab_parallel_logits(x, w_head):
    """x: (B, S, d); w_head: (d, V_local) -> local logits (B, S, V_local)."""
    return x @ w_head


def vocab_parallel_xent(local_logits, targets, vocab: int, group=None,
                        softcap: float | None = None):
    """Mean cross entropy over TP-sharded logits, in f32, with the
    reference's formulation: the logits soft-capped (``softcap``,
    :func:`soft_cap`), then log-sum-exp around a max that carries no
    gradient (gathered from every rank), the padded vocab tail (columns
    ``>= vocab``, on the last rank) masked.  local_logits: (B, S, V_local);
    targets: (B, S) global ids < vocab."""
    lg = local_logits.float()
    if softcap is not None:
        lg = soft_cap(lg, softcap)
    vl = lg.shape[-1]
    col0 = tp_rank(group) * vl
    if col0 + vl > vocab:  # padded vocab tail
        lg = lg.masked_fill(torch.arange(col0, col0 + vl, device=lg.device)
                            >= vocab, NEG_INF)
    m = lg.amax(dim=-1).detach()
    if group is not None:
        with torch.no_grad():
            m = all_gather_flat(m[None], group).amax(dim=0)
    se = torch.exp(lg - m[..., None]).sum(dim=-1)
    if group is not None:
        se = psum_tp(se, group)
    lse = m + torch.log(se)
    if group is None:
        tl = torch.gather(lg, -1, targets[..., None])[..., 0]
    else:
        local_t = targets - col0
        ok = (local_t >= 0) & (local_t < vl)
        tl = torch.gather(lg, -1, local_t.clamp(0, vl - 1)[..., None])[..., 0]
        tl = psum_tp(torch.where(ok, tl, torch.zeros((), device=tl.device)),
                     group)
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

    @property
    def kv_identity(self) -> bool:
        """Each local q head has its own local kv head, in order."""
        return self.kv_sharded and self.n_heads == self.n_kv

    def kv_map(self, device, rank: int = 0) -> torch.Tensor:
        """(hl,) indices into the local kv head axis for each local q head
        of model rank ``rank``."""
        group = self.n_heads // self.n_kv
        if self.kv_sharded:
            return torch.arange(self.hl, device=device) // group
        # kv replicated over the model group: map by the *global* q index
        gq = rank * self.hl + torch.arange(self.hl, device=device)
        return torch.clamp(gq // group, 0, self.n_kv - 1)


    def kv_runs_global(self) -> tuple[int, ...]:
        """``kv_runs`` over all ``h_pad`` q heads of the model group (the
        reference's ``kv_map_global``: padded heads read the last kv
        head)."""
        group = self.n_heads // self.n_kv
        heads = [min(q // group, self.n_kv - 1) for q in range(self.h_pad)]
        return tuple(heads.count(j) for j in range(self.n_kv))

    def kv_runs(self, rank: int = 0) -> tuple[int, ...]:
        """How many consecutive local q heads each local kv head serves on
        model rank ``rank`` (``kv_map`` is non-decreasing): the counts of
        ``kv_map``'s values, in Python ints."""
        group = self.n_heads // self.n_kv
        if self.kv_sharded:
            return (group,) * self.kvl
        heads = [min(q // group, self.n_kv - 1)
                 for q in range(rank * self.hl, (rank + 1) * self.hl)]
        return tuple(heads.count(j) for j in range(self.n_kv))


def expand_kv(k, runs):
    """k: (B, S, KVl, hd) -> (B, S, Hl, hd): local kv head j repeated for
    its ``runs[j]`` consecutive q heads (``HeadLayout.kv_runs``), the
    reference's gather.  Built from expand and cat, not a gather, so that
    the backward is deterministic: a gather's backward on CUDA adds the q
    heads' gradients with atomics, in an order that changes from run to
    run; an expand's sums each kv head's gradient in one reduction."""
    return torch.cat([k[:, :, j:j + 1].expand(-1, -1, n, -1)
                      for j, n in enumerate(runs) if n], dim=2)


# ---------------------------------------------------------------------------
# serving: attention over absolute positions, the ring KV cache and the
# context-parallel (window-sharded) cache
# ---------------------------------------------------------------------------

# the reference's key block, which a prompt's attention takes
PREFILL_BLOCK_K = 512
# query tiles may visit at most this many times the untiled call's blocks
TILE_BLOCKS = 2


def blockwise_attention(q, k, v, q_pos, k_pos, *, block_k: int,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        return_stats: bool = False):
    """The reference's ``blockwise_attention``: an online softmax over
    blocks of ``block_k`` keys (the last one may be ragged).  q: (B, Sq,
    H, hd) at absolute positions ``q_pos`` (Sq,); k, v: (B, Sk, H, hd)
    (expanded to the q heads) at ``k_pos`` (Sk,), -1 for an empty slot.
    A query sees a key when ``k_pos >= 0``, with ``causal`` ``k_pos <=
    q_pos``, and with ``window`` ``k_pos > q_pos - window``.

    Each block: q scaled by ``1/sqrt(hd)`` and rounded to its dtype, f32
    scores, ``softcap`` before the mask, ``exp(s - m)``, ``p`` rounded to
    v's dtype before the value product; the blocks fold into f32 ``(m, l,
    acc)``.  K and V stay in their dtype: one block at a time is cast to
    f32, and its mask is built from the positions, so no (Sq, Sk) tensor
    exists but with one block.  The scores are overwritten in place unless
    autograd records them (training, which takes one block: the fold of
    several is in place).  Returns (B, Sq, H, hd)
    in q's dtype, or with ``return_stats`` ``(m, l, acc)`` of shapes (B,
    H, Sq), (B, H, Sq), (B, H, Sq, hd)."""
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = (q.float() * scale).to(q.dtype).transpose(1, 2).float()
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # (B, H, Sk, hd)
    qp = q_pos[:, None]
    far = qp - window if window is not None else None
    m = l = acc = None
    for lo in range(0, Sk, block_k):
        hi = min(lo + block_k, Sk)
        kp = k_pos[lo:hi]
        drop = kp < 0
        if causal:
            drop = (kp > qp).logical_or_(drop)               # (Sq, bk)
        if far is not None:
            drop = drop | (kp <= far)
        s = torch.matmul(qf, kt[:, :, lo:hi].float().transpose(-1, -2))
        if softcap is not None:
            s = soft_cap(s, softcap)
        inplace = not s.requires_grad      # amax's backward keeps s
        s = s.masked_fill_(drop, NEG_INF) if inplace else s.masked_fill(
            drop, NEG_INF)
        m_new = s.amax(dim=-1, keepdim=True)
        if m is not None:
            m_new = torch.maximum(m, m_new)
        p = s.sub_(m_new).exp_() if inplace else torch.exp(s - m_new)
        l_new = p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), vt[:, :, lo:hi].float())
        del s, p
        if m is None:
            m, l, acc = m_new, l_new, pv
        else:
            corr = torch.exp(m - m_new)
            l, acc = l.mul_(corr).add_(l_new), acc.mul_(corr).add_(pv)
            m = m_new
    if return_stats:
        return m[..., 0], l[..., 0], acc
    return _normalize(q, l, acc)


@functools.lru_cache(maxsize=None)
def query_tiles(S: int, window: int | None
                ) -> tuple[tuple[int, int, int, int], ...]:
    """``(q0, q1, k0, k1)`` for each query tile of a causal prompt of S
    tokens over its own keys: tile rows ``[q0, q1)`` see the key blocks of
    ``[k0, k1)``, every PREFILL_BLOCK_K-key block that holds a key one of
    its rows can see (``k0`` a multiple of the block, so the blocks are
    the untiled call's).  Of the tilings into whole blocks of rows, the
    one that scores the fewest (row, key) pairs while its tiles visit at
    most TILE_BLOCKS times the untiled call's blocks; ties go to fewer
    tiles."""
    bk = PREFILL_BLOCK_K
    nblk = -(-S // bk)
    best = None
    for t in range(nblk, 0, -1):
        rows, tiles = t * bk, []
        for q0 in range(0, S, rows):
            q1 = min(S, q0 + rows)
            k0 = 0 if window is None else max(0, q0 - window + 1) // bk * bk
            tiles.append((q0, q1, k0, min(S, -(-q1 // bk) * bk)))
        blocks = sum(-(-(k1 - k0) // bk) for _, _, k0, k1 in tiles)
        work = sum((q1 - q0) * (k1 - k0) for q0, q1, k0, k1 in tiles)
        if blocks <= TILE_BLOCKS * nblk and (best is None or work < best[0]):
            best = (work, tuple(tiles))
    return best[1]


def prefill_attention(q, k, v, positions, *, window: int | None = None,
                      softcap: float | None = None):
    """A prompt's causal attention over its own keys: q, k, v (B, S, H,
    hd) (k and v expanded to the q heads) at the consecutive ``positions``
    (S,) -> (B, S, H, hd).  :func:`blockwise_attention` in
    PREFILL_BLOCK_K-key blocks over the query tiles of
    :func:`query_tiles`, each over the key blocks it can see: a block
    wholly in a tile's future, or before its window, is left out.  The
    online softmax is per row, and a tile's blocks come in the untiled
    call's order, so every row is the untiled call's bit for bit (a row's
    fully masked leading blocks leave no trace: the first block it sees
    scales them by ``exp(NEG_INF - m) = 0``)."""
    out = torch.empty_like(q)
    for q0, q1, k0, k1 in query_tiles(q.shape[1], window):
        out[:, q0:q1] = blockwise_attention(
            q[:, q0:q1], k[:, k0:k1], v[:, k0:k1], positions[q0:q1],
            positions[k0:k1], window=window, softcap=softcap,
            block_k=PREFILL_BLOCK_K)
    return out


def attention_at(q, k, v, q_pos, k_pos, *, window: int | None = None,
                 softcap: float | None = None, return_stats: bool = False):
    """A decode step's attention over its cache: q (B, Sq, H, hd) at
    absolute positions ``q_pos`` (Sq,); k, v (B, Sk, H, hd) (expanded to
    the q heads) at ``k_pos`` (Sk,), -1 for an empty slot.
    :func:`blockwise_attention` with every key in one block (the cache's
    window: one query's scores are (B, H, 1, Sk)), causal, with
    ``window`` and ``softcap``; with ``return_stats`` the f32 ``(m, l,
    acc)``."""
    return blockwise_attention(q, k, v, q_pos, k_pos, window=window,
                               softcap=softcap, block_k=k.shape[1],
                               return_stats=return_stats)


@dataclasses.dataclass
class KVCache:
    """Ring buffer of one attention layer's keys and values at absolute
    positions (the reference's ``KVCache``): ``k``, ``v`` (B, W, KVl, hd),
    ``pos`` (W,) int64, -1 for an empty slot; position p lives in slot
    ``p % W``, so a full and a sliding-window cache are the same object.
    Written in place."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def create(batch: int, window: int, heads_local: int, head_dim: int,
               device) -> "KVCache":
        shape = (batch, window, heads_local, head_dim)
        return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                       torch.zeros(shape, dtype=torch.bfloat16, device=device),
                       torch.full((window,), -1, dtype=torch.int64,
                                  device=device))

    @property
    def window(self) -> int:
        return self.k.shape[1]

    def append(self, k_new, v_new, start_pos: int) -> "KVCache":
        """Write Sq entries at positions ``start_pos + arange(Sq)``; when
        Sq >= W only the last W survive (the ring would wrap)."""
        W, Sq = self.window, k_new.shape[1]
        if Sq >= W:
            k_new, v_new = k_new[:, -W:], v_new[:, -W:]
            start_pos, Sq = start_pos + Sq - W, W
        p = torch.arange(start_pos, start_pos + Sq, device=self.pos.device)
        slots = p % W
        self.k.index_copy_(1, slots, k_new.to(self.k.dtype))
        self.v.index_copy_(1, slots, v_new.to(self.v.dtype))
        self.pos.index_copy_(0, slots, p)
        return self


def cp_degree(lay: HeadLayout) -> int:
    """Ranks a layer's cache window is cut over: tp when the kv heads are
    replicated over the model group (fewer than tp), else 1."""
    return lay.tp if (not lay.kv_sharded and lay.tp > 1) else 1


def build_cp_cache(cache: KVCache, k, v, cp: int, rank: int) -> KVCache:
    """Prefill: fill model rank ``rank``'s shard of the window from the
    (B, S, KV, hd) fresh keys.  Global slot g (of ``W_g = w_local * cp``)
    holds the latest position p < S with ``p % W_g == g``; rank r owns
    slots ``[r * w_local, (r + 1) * w_local)``.  A gather, in place."""
    S, w_local = k.shape[1], cache.window
    w_g = w_local * cp
    g = rank * w_local + torch.arange(w_local, device=k.device)
    p = g + torch.div(S - 1 - g, w_g, rounding_mode="floor") * w_g
    valid = p >= 0
    pc = p.clamp(0, S - 1)
    zero = torch.zeros((), dtype=cache.k.dtype, device=k.device)
    for dst, src in ((cache.k, k), (cache.v, v)):
        dst.copy_(torch.where(valid[None, :, None, None],
                              src.index_select(1, pc).to(dst.dtype), zero))
    cache.pos.copy_(torch.where(valid, p, -1))
    return cache


def cp_append(cache: KVCache, k_new, v_new, p: int, cp: int,
              rank: int) -> KVCache:
    """Decode: the rank that owns position ``p``'s global slot writes the
    token there (in place); the others keep their shard."""
    w_local = cache.window
    g = p % (w_local * cp)
    if g // w_local == rank:
        ls = g % w_local
        cache.k[:, ls:ls + 1] = k_new.to(cache.k.dtype)
        cache.v[:, ls:ls + 1] = v_new.to(cache.v.dtype)
        cache.pos[ls] = p
    return cache


def pmax_tp(x, group):
    """Elementwise max over the model group."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def cp_decode_attention(q, cache: KVCache, lay: HeadLayout, q_pos, group, *,
                        window: int | None = None,
                        softcap: float | None = None):
    """q: (B, 1, Hl, hd) this rank's query heads -> (B, 1, Hl, hd).  Every
    query head (all-gathered over the model group) attends to this rank's
    window shard; the ranks' ``(m, l, acc)`` merge by a max and two sums
    over the group (flash-decoding), and each rank keeps its heads."""
    Hl = q.shape[2]
    q_all = all_gather_tp(q, group, dim=2)                   # (B, 1, H, hd)
    runs = lay.kv_runs_global()
    m, l, acc = attention_at(q_all, expand_kv(cache.k, runs),
                             expand_kv(cache.v, runs), q_pos, cache.pos,
                             window=window, softcap=softcap,
                             return_stats=True)
    m_g = pmax_tp(m, group)
    w = torch.exp(m - m_g)
    l_g = psum_tp(l * w, group)
    acc_g = psum_tp(acc * w[..., None], group)
    out = acc_g / torch.clamp(l_g[..., None], min=1e-30)     # (B, H, 1, hd)
    r = tp_rank(group)
    return out[:, r * Hl:(r + 1) * Hl].transpose(1, 2).to(q.dtype)
