"""Mamba2 (SSD -- state-space duality) mixer, TP-sharded over ssm heads.

Port of ``repro.models.ssm``: the chunked SSD algorithm [arXiv:2405.21060]
in matmul form.  Within a chunk of ``Q`` steps the scan is an
attention-like product of f32 einsums; the recurrence between chunks is a
Python loop over the ``T / Q`` chunk states (the reference's
``lax.scan``).  Past ``GROUP`` chunks the scan runs over groups of them,
one after another, so that a long prompt's (chunks, Q, Q) products are
one group's at a time (the reference forms them all).  Heads are sharded
over the ``model`` group (``d_inner / tp`` channels local); the B/C
projections (one group) are replicated, and the gated norm is per head,
so it needs no statistic across ranks.

One fault of the reference is not copied: its ``_segsum_lower`` takes
``exp`` of every pairwise sum of step sizes and masks the upper triangle
afterwards.  Above the diagonal those sums are positive and, over a chunk
of 128 steps or more, overflow ``exp`` to ``inf``: the masked forward is
right, but the backward multiplies the masked zero cotangent by ``inf``
and gives NaN.  Here the mask comes first (``exp(-inf) = 0``): the same
forward bits and a finite gradient, equal to the reference's wherever that
one is finite (tests/test_torch_ssm.py).

Every SSD product runs in f32 (the port never turns TF32 on), and the
causal conv is the reference's sum of ``K`` shifted products, not a
library convolution, whose f32 path may round or add otherwise.
``ssd_reference`` is the sequential recurrence the tests hold the chunked
form against.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as C

CHUNK = 256
# chunks of CHUNK steps per group of :func:`ssd_chunked` (4,096 steps)
GROUP = 16


def _segsum_lower(cs):
    """cs: (..., Q) inclusive cumsum of dA.  Returns L (..., Q, Q) with
    L[i, j] = exp(cs_i - cs_j) for j <= i else 0, masked before the exp
    (see the module docstring)."""
    Q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def chunk_len(T: int) -> int:
    """The chunk the scan cuts ``T`` steps into: ``CHUNK``, halved until it
    divides ``T`` (the reference's rule)."""
    Q = min(CHUNK, T)
    while T % Q:
        Q //= 2
    return Q


def ssd_chunked(X, dt, A, Bm, Cm, init_state=None):
    """Chunked SSD scan, run over groups of chunks one at a time.

    X:  (B, T, H, P) f32   inputs per head
    dt: (B, T, H)    f32   positive step sizes (already softplused)
    A:  (H,)         f32   negative per-head decay rates
    Bm: (B, T, N)    f32   input projection (one group, broadcast to H)
    Cm: (B, T, N)    f32   output projection
    Returns (Y (B, T, H, P), final_state (B, H, N, P)).

    The chunk is the reference's (:func:`chunk_len` of the whole ``T``).
    A group spans ``GROUP * CHUNK`` steps (a multiple of every chunk the
    halving rule gives past CHUNK steps), starts from the state that
    leaves the one before it and writes its rows of ``Y``, so only one
    group's (B, chunks, H, Q, Q) products exist at a time; every op is
    the whole form's on fewer chunks, so on the CPU the groups give its
    bits.  A scan of at most one span is the whole form itself.
    """
    Bb, T, H, P = X.shape
    Q = chunk_len(T)
    S = (torch.zeros(Bb, H, Bm.shape[-1], P, dtype=torch.float32,
                     device=X.device)
         if init_state is None else init_state.float())
    span = GROUP * CHUNK
    if T <= span:
        return _ssd_group(X, dt, A, Bm, Cm, S, Q)
    Y = None
    for lo in range(0, T, span):
        hi = min(T, lo + span)
        y, S = _ssd_group(X[:, lo:hi], dt[:, lo:hi], A, Bm[:, lo:hi],
                          Cm[:, lo:hi], S, Q)
        if Y is None:
            Y = y.new_empty(Bb, T, H, P)
        Y[:, lo:hi] = y
        del y
    return Y, S


def _ssd_group(X, dt, A, Bm, Cm, S, Q):
    """The chunked scan of ``T`` steps in chunks of ``Q`` from the entering
    state ``S`` (B, H, N, P) f32 -> (Y (B, T, H, P), the leaving state)."""
    Bb, T, H, P = X.shape
    N = Bm.shape[-1]
    nc = T // Q

    dA = dt * A[None, None, :]                       # (B, T, H) negative
    dtX = X * dt[..., None]                          # (B, T, H, P)

    dAc = dA.reshape(Bb, nc, Q, H)
    cs = torch.cumsum(dAc, dim=2)                    # inclusive
    Bc = Bm.reshape(Bb, nc, Q, N)
    Cc = Cm.reshape(Bb, nc, Q, N)
    Xc = dtX.reshape(Bb, nc, Q, H, P)

    # intra-chunk: quadratic within Q, B.C shared across heads
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)      # (B, nc, Q, Q)
    L = _segsum_lower(cs.permute(0, 1, 3, 2))        # (B, nc, H, Q, Q)
    M = G[:, :, None] * L
    Y_diag = torch.einsum("bchij,bcjhp->bcihp", M, Xc)

    # chunk summary states
    decay_last = torch.exp(cs[:, :, -1:, :] - cs)    # (B, nc, Q, H)
    S_chunk = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                           decay_last[..., None] * Xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(torch.sum(dAc, dim=2))   # (B, nc, H)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    S_prev = torch.stack(S_prevs, dim=1)             # (B, nc, H, N, P)

    # inter-chunk contribution
    instate_decay = torch.exp(cs)                    # (B, nc, Q, H)
    Y_off = (torch.einsum("bcin,bchnp->bcihp", Cc, S_prev)
             * instate_decay[..., None])

    Y = (Y_diag + Y_off).reshape(Bb, T, H, P)
    return Y, S


def ssd_step(S, x, dt, A, Bv, Cv):
    """One decode step.  S: (B, H, N, P); x: (B, H, P); dt: (B, H);
    Bv/Cv: (B, N).  Returns (y (B, H, P), S_new)."""
    dA = torch.exp(dt * A[None, :])                  # (B, H)
    S_new = S * dA[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", Bv, x * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", Cv, S_new)
    return y, S_new


def ssd_reference(X, dt, A, Bm, Cm):
    """The sequential recurrence (tests only)."""
    Bb, T, H, P = X.shape
    N = Bm.shape[-1]
    S = torch.zeros(Bb, H, N, P, dtype=torch.float32, device=X.device)
    ys = []
    for t in range(T):
        y, S = ssd_step(S, X[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), S


# ---------------------------------------------------------------------------
# the full mamba2 mixer (projections, conv, gated norm)
# ---------------------------------------------------------------------------

def _causal_conv(x, w, cache=None):
    """Depthwise causal conv.  x: (B, T, Ch); w: (K, Ch); cache: (B, K-1,
    Ch) trailing context or None (zeros).  Returns (y (B, T, Ch),
    new_cache (B, K-1, Ch), a tensor of its own).  The sum of K shifted
    products, in the reference's order."""
    K = w.shape[0]
    B, T, Ch = x.shape
    ctx = (torch.zeros(B, K - 1, Ch, dtype=x.dtype, device=x.device)
           if cache is None else cache.to(x.dtype))
    xp = torch.cat([ctx, x], dim=1)
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + T] * w[i][None, None, :]
    # a copy: a view would keep all of ``xp`` alive with the cache
    return y, xp[:, T:].clone()


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``, and its derivative as JAX defines it, ``exp(x -
    softplus(x))``.  torch's own softplus returns ``log1p(exp(x))``, and
    ``x`` above 20."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


def softplus(x):
    return _Softplus.apply(x)


def mamba2_mixer(x, p, cfg, *, conv_cache=None, ssm_state=None,
                 single_step=False, group=None, sp=False):
    """x: (B, T, d) replicated -> (y (B, T, d), (conv_cache, ssm_state)).

    p: dict of local params -- w_z (d, dil), w_x (d, dil), w_B (d, N),
    w_C (d, N), w_dt (d, Hl), dt_bias (Hl,), A_log (Hl,), D (Hl,),
    conv_x (K, dil), conv_B (K, N), conv_C (K, N), normg (dil,),
    w_out (dil, d).  ``group``: the model group (None at tp = 1); under
    ``sp`` the output is reduce-scattered over the sequence.
    ``conv_cache`` (the three trailing contexts) and ``ssm_state`` carry
    a sequence on (the reference's prefill starts its conv from zeros
    whatever the cache holds; a fresh cache holds zeros, so the bits are
    the same); ``single_step`` steps one token through ``ssd_step``.
    """
    B, T, d = x.shape
    P = cfg.ssm_headdim
    z = C.col_linear(x, p["w_z"])                     # (B, T, dil)
    xc = C.col_linear(x, p["w_x"])
    Bm = C.col_linear(x, p["w_B"]).float()            # replicated (B, T, N)
    Cm = C.col_linear(x, p["w_C"]).float()
    dt = C.col_linear(x, p["w_dt"]).float()

    ccx, ccB, ccC = conv_cache if conv_cache is not None else (None,) * 3
    xc, ccx = _causal_conv(xc, p["conv_x"], ccx)
    Bm, ccB = _causal_conv(Bm, p["conv_B"], ccB)
    Cm, ccC = _causal_conv(Cm, p["conv_C"], ccC)
    xc = torch.nn.functional.silu(xc)
    Bm = torch.nn.functional.silu(Bm.float())
    Cm = torch.nn.functional.silu(Cm.float())

    Hl = p["A_log"].shape[0]
    dt = softplus(dt + p["dt_bias"].float()[None, None])
    A = -torch.exp(p["A_log"].float())
    X = xc.float().reshape(B, T, Hl, P)

    if single_step:
        y, S = ssd_step(ssm_state, X[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]                                # (B, 1, Hl, P)
    else:
        y, S = ssd_chunked(X, dt, A, Bm, Cm, init_state=ssm_state)

    y = y + X * p["D"].float()[None, None, :, None]
    # gated per-head RMSNorm (GroupNorm-style; TP-local by construction)
    g = y * torch.nn.functional.silu(z.float()).reshape(B, T, Hl, P)
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-5)
    g = (g.reshape(B, T, Hl * P) * p["normg"].float()[None, None]).to(x.dtype)
    out = C.row_linear(g, p["w_out"], group, sp)     # psum / seq-scatter
    return out, ((ccx, ccB, ccC), S)
