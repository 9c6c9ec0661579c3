"""Mixture-of-Experts layer.

Port of ``repro.models.moe``: top-k softmax routing with renormalized
weights and group-limited (DeepSeek-V3) selection, capacity-slot dispatch
by a stable sort (GShard token dropping), the batched expert FFN (the
config's gated or plain MLP), always-on shared experts, the Switch aux
load-balance loss and the router z-loss.

Two schedules, as in the reference:

* ``tp_dense``: every rank holds a d_ff slice of every expert; dispatch
  and combine are local scatters and gathers, and the block ends in a
  psum (a reduce-scatter over the sequence under sequence parallelism);
* ``ep_a2a``: experts are sharded over the ``model`` group; each rank
  routes its batch-major slice of the (padded) tokens, and the
  ``(tp, El, cap, d)`` slot buffer crosses the group by all-to-all, on
  dispatch and on combine, through :mod:`repro_torch.core.act_comm`
  (``fp``: raw bf16; ``block8``: int8 block-absmax, forward and
  backward; ``block8+ef``: block8 with an error-feedback residual on the
  combine); an all-gather re-replicates the tokens.  At ``tp = 1`` the
  group has one rank and the exchange moves nothing, but the block8
  quantize and dequantize run as they do in the reference.

Under sequence parallelism ``ep_a2a`` returns the sequence shard of what
it computes without it: the all-gather, then the rank's S/tp columns of
every row.  (The reference returns its token slice reshaped as the shard,
``repro/models/moe.py`` "sp composes with EP for free", which is the
shard only when a microbatch has one row.)

Scatters are written so that the card gives the reference's bf16 sums in
a fixed order: the dispatch adds exactly one token (or exact zeros) to
each slot, and the combine sums a token's k expert outputs in order
j = 0..k-1 on a ``(T, k, d)`` view instead of with an atomic scatter-add.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import act_comm as ACT
from repro_torch.models import common as C


def route(x2d, w_router, top_k: int, n_experts: int,
          n_groups: int = 1, group_top_k: int = 0):
    """x2d: (T, d) -> (weights (T, k) f32, experts (T, k), aux dict).

    With ``n_groups > 1`` and ``0 < group_top_k < n_groups``, each group is
    scored by the sum of its top-2 expert probs, only the ``group_top_k``
    best groups stay routable, and the token's top-k is drawn from those.
    The aux losses use the full (unmasked) distribution.
    """
    T = x2d.shape[0]
    logits = x2d.float() @ w_router.float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    sel = probs
    if n_groups > 1 and 0 < group_top_k < n_groups:
        Eg = n_experts // n_groups
        pg = probs.reshape(T, n_groups, Eg)
        gscore = torch.topk(pg, min(2, Eg), dim=-1).values.sum(-1)  # (T, G)
        gi = torch.topk(gscore, group_top_k, dim=-1).indices
        gmask = torch.zeros_like(gscore).scatter(1, gi, 1.0)
        sel = (pg * gmask[:, :, None]).reshape(T, n_experts)
    topv, topi = torch.topk(sel, top_k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e f_e * P_e
    counts = torch.zeros(n_experts, dtype=torch.float32, device=x2d.device)
    counts.index_add_(0, topi.reshape(-1),
                      torch.ones(topi.numel(), device=x2d.device))
    dispatch_frac = counts / (T * top_k)
    aux = n_experts * torch.sum(dispatch_frac * probs.mean(0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return topv, topi, {"aux": aux, "z": z}


def _dispatch_indices(topi, n_experts: int, capacity: int):
    """Capacity-slot assignment via a stable sort.

    topi: (T, k) expert choice per (token, slot).  Returns (slot (T*k,),
    valid (T*k,)): slot in [0, E*capacity) for tokens that fit their
    expert's capacity, -1 (and valid False) for dropped ones.
    """
    e_flat = topi.reshape(-1)
    Tk = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    seg_start = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.arange(Tk, device=topi.device) - seg_start
    slot_sorted = torch.where(rank < capacity, e_sorted * capacity + rank, -1)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    return slot, slot >= 0


def _expert_ffn(xe, w1, w3, w2, mlp_kind: str):
    """The MLP per expert. xe: (El, C, d); w1/w3: (El, d, f); w2: (El, f,
    d); ``w3`` None for the ungated ``gelu``."""
    a = torch.bmm(xe, w1)
    b = None if w3 is None else torch.bmm(xe, w3)
    return torch.bmm(C.activation(mlp_kind, a, b), w2)


def _shared_ffn(x2d, p, mlp_kind: str):
    """Always-on shared-expert FFN (the width of n_shared_experts
    experts)."""
    a = x2d @ p["ws1"]
    b = x2d @ p["ws3"] if "ws3" in p else None
    return C.activation(mlp_kind, a, b) @ p["ws2"]


def _capacity(n_tokens: int, cfg) -> int:
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def _dispatch(xs, slot, valid, k: int, n_slots: int):
    """(T, d) tokens -> (n_slots, d) slot buffer; dead slots stay exactly 0
    (dropped tokens add zeros to the last slot)."""
    T, d = xs.shape
    rep = xs[:, None, :].expand(T, k, d).reshape(T * k, d)
    src = torch.where(valid[:, None], rep, torch.zeros((), dtype=xs.dtype,
                                                       device=xs.device))
    idx = torch.where(valid, slot, n_slots - 1)
    return torch.zeros(n_slots, d, dtype=xs.dtype,
                       device=xs.device).index_add(0, idx, src)


def _combine(ye, slot, valid, topv, k: int):
    """(n_slots, d) expert outputs -> (T, d): each token's k weighted
    outputs summed in order j = 0..k-1 in the activation dtype."""
    n_slots, d = ye.shape
    # index_select, not ye[idx]: its backward is one index_add (each slot
    # gets one token's gradient plus exact zeros, so any order gives the
    # same bf16 sum), where advanced indexing's backward sorts the indices
    y_tok = ye.index_select(0, torch.clamp(slot, 0, n_slots - 1))
    y_tok = torch.where(valid[:, None], y_tok,
                        torch.zeros((), dtype=ye.dtype, device=ye.device))
    contrib = (y_tok * topv.reshape(-1)[:, None].to(ye.dtype)).reshape(
        -1, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def moe_block(x, p, cfg, group=None, *,
              deterministic_capacity: int | None = None, sp: bool = False,
              a2a_state=None):
    """x: (B, S, d), replicated over the model group -> (y, aux losses
    {"aux", "z"}); y is (B, S, d), or under ``sp`` this rank's
    (B, S/tp, d) sequence shard of it.

    p: router (d, E); w1/w3 (E, d, f_local) and w2 (E, f_local, d) for
    ``tp_dense``, (E/tp, d, f) and (E/tp, f, d) for ``ep_a2a``; ws1/ws3
    (d, fs/tp) and ws2 (fs/tp, d) when ``cfg.n_shared_experts``.
    ``group`` is the ``model`` process group (``ep_a2a`` always needs one;
    ``tp_dense`` at tp > 1).

    ``a2a_state``: this layer's flat combine-side error-feedback residual
    (``moe_a2a_codec="block8+ef"``).  When given, the new residual rides
    back as ``aux["a2a_state"]`` (the state itself where no EF exchange
    runs); without it ``block8+ef`` is the stateless block8 exchange.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    x2d = x.reshape(B * S, d)
    tp = C.tp_size(group)
    tpg = group if tp > 1 else None

    if cfg.moe_impl == "tp_dense":
        cap = deterministic_capacity or _capacity(B * S, cfg)
        topv, topi, aux = route(x2d, p["router"], k, E, cfg.n_expert_groups,
                                cfg.group_top_k)
        slot, valid = _dispatch_indices(topi, E, cap)
        xe = _dispatch(x2d, slot, valid, k, E * cap).reshape(E, cap, d)
        ye = _expert_ffn(xe, p["w1"], p.get("w3"), p["w2"],
                         cfg.mlp).reshape(E * cap, d)
        y2d = _combine(ye, slot, valid, topv, k)  # partial over d_ff slices
        if cfg.n_shared_experts:
            y2d = y2d + _shared_ffn(x2d, p, cfg.mlp).to(x.dtype)
        y = y2d.reshape(B, S, d)
        if a2a_state is not None:
            aux = {**aux, "a2a_state": a2a_state}  # no exchange here
        if tpg is None:
            return y, aux
        return (C.sp_scatter_sum(y, tpg) if sp else C.psum_tp(y, tpg)), aux

    if cfg.moe_impl != "ep_a2a":
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    if group is None:
        raise ValueError("ep_a2a needs the model process group "
                         "(launch.mesh.mesh_groups)")
    # experts sharded over the model group, tokens too for the interior:
    # pad the tokens to a multiple of tp, each rank routes its batch-major
    # slice of Tl of them
    El, T0 = E // tp, B * S
    Tpad = -(-T0 // tp) * tp
    if Tpad != T0:
        x2d = torch.cat([x2d, x2d.new_zeros(Tpad - T0, d)])
    Tl, r = Tpad // tp, C.tp_rank(group)
    # (at tp = 1 the whole token set, unsliced: a slice would regroup the
    # bf16 sums of the tokens' gradient)
    xs = x2d if tpg is None else x2d[r * Tl:(r + 1) * Tl]
    cap = deterministic_capacity or _capacity(Tl, cfg)
    topv, topi, aux = route(xs, p["router"], k, E, cfg.n_expert_groups,
                            cfg.group_top_k)
    slot, valid = _dispatch_indices(topi, E, cap)
    # valid-masked scatter: dead capacity slots are exactly 0 in the slot
    # buffer, the precondition of the block-absmax encode
    xe = _dispatch(xs, slot, valid, k, E * cap).reshape(tp, El, cap, d)
    exchange = ACT.a2a_raw if cfg.moe_a2a_codec == "fp" else ACT.a2a_exchange
    xe = exchange(xe, group)                       # dispatch: (tp, El, cap, d)
    xe = xe.transpose(0, 1).reshape(El, tp * cap, d)
    ye = _expert_ffn(xe, p["w1"], p.get("w3"), p["w2"], cfg.mlp)
    ye = ye.reshape(El, tp, cap, d).transpose(0, 1)
    if cfg.moe_a2a_codec == "block8+ef" and a2a_state is not None:
        ye, a2a_state = ACT.a2a_exchange_ef(ye, a2a_state, group)
        aux = {**aux, "a2a_state": a2a_state}
    else:
        ye = exchange(ye, group)                   # combine
        if a2a_state is not None:
            aux = {**aux, "a2a_state": a2a_state}
    ye = ye.reshape(E * cap, d)
    ys = _combine(ye, slot, valid, topv, k)
    if cfg.n_shared_experts:
        # the shared-expert psum reduces d_ff-slice partials of the SAME
        # tokens: computed on the whole padded token set, then sliced
        shared = _shared_ffn(x2d, p, cfg.mlp).to(x.dtype)
        if tpg is not None:
            shared = C.psum_tp(shared, tpg)[r * Tl:(r + 1) * Tl]
        ys = ys + shared
    if tpg is None:
        return ys.reshape(B, S, d), aux
    y = C.all_gather_tp(ys, tpg)[:T0].reshape(B, S, d)  # re-replicate
    if sp:
        # this rank's sequence shard of every row: the rank's token slice
        # is batch-major and is the shard only when a row is alone
        s = S // tp
        y = y[:, r * s:(r + 1) * s]
    return y, aux
