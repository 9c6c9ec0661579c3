"""Optimizers over trees of flat f32 master chunks.

Port of ``repro.optim.optimizers`` (``sgd``, ``adam``/``adamw``, ``lamb``,
``adafactor``, ``adafactor_flat`` and the global-norm clip).  A tree is
``{group: {name: tensor}}``; the optimizer state is a tuple of
chunk-mirroring trees, so Adam moments are ZeRO-sharded with the chunks
(``sgd`` without momentum keeps ``()``; the factored ``adafactor`` keeps
one ``(row, col)`` pair per leaf, as the reference does).  ``update``
returns new parameter and state trees (the caller may store them back in
place); scalars (``step``, ``lr``, bias corrections) are 0-dim f32 tensors
so the arithmetic is the reference's f32 arithmetic.

Each leaf is one rank's whole local chunk, the ``(L, chunk)`` stack of
every layer for stacked groups, as in the reference: LAMB's trust ratio
and Adafactor's RMS clip are taken over that leaf, so they depend on dp
and on the layer stacking (a reference quirk the port keeps).

Every update gives the CPU's bits on the card.  Divisions are IEEE on
every device: by a device tensor, never by a 0-dim CPU tensor or a Python
scalar, which torch on CUDA turns into a multiply by the inverse; a mean
is a sum divided so (``comm.divide``).  Roots are correctly rounded
(:func:`_sqrt`), a reciprocal root is one divided by that root, and every
norm and mean sums in f64 and rounds once (``comm.sum_f64``), where the
card's f32 reductions would add in another order.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.comm import divide, sum_f64


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, step, lr, mask) -> (new_params, new_state)
    update: Callable[..., tuple[Any, Any]]


def tree_map(f, *trees):
    """Map over ``{group: {name: tensor}}`` trees of the same structure."""
    return {g: {n: f(*(t[g][n] for t in trees)) for n in trees[0][g]}
            for g in trees[0]}


def tree_leaves(tree) -> list[torch.Tensor]:
    return [t for sub in tree.values() for t in sub.values()]


def _on(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The 0-dim f32 CPU scalar ``x`` filled on ``like``'s device, so a
    division by it is a true division on CUDA too (a 0-dim CPU operand
    becomes a multiply by its inverse there); a fill needs no
    host-to-device copy, so no stream sync."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _mean(x: torch.Tensor, dim: int | None = None,
          keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: the sum, taken in f64 and rounded once to f32,
    divided by the count, one IEEE division."""
    if dim is None:
        return divide(sum_f64(x).float(), x.numel())
    s = torch.sum(x, dim=dim, keepdim=keepdim, dtype=torch.float64)
    return divide(s.float(), x.shape[dim])


def _mean_sq(x: torch.Tensor) -> torch.Tensor:
    """``mean(x * x)`` over every element, summed as :func:`_mean`."""
    return divide(sum_f64(x, x).float(), x.numel())


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm: the squares summed in f64, rounded once, then the
    correctly rounded root."""
    return _sqrt(sum_f64(x, x).float())


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on any device.  torch's f32
    sqrt on CUDA is one ulp off on about 0.7% of the elements of a random
    vector (on an H100), where the CPU's and the reference's round
    correctly; the f64 root rounded to f32 is the correctly rounded one
    (53 >= 2 * 24 + 2 bits, so the double rounding is innocuous)."""
    r = x.double()
    return r.sqrt_().float()


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)``: one IEEE division of a device-filled one by the
    correctly rounded root."""
    one = torch.ones((), dtype=torch.float32, device=x.device)
    return one / _sqrt(x)


def _apply_decay(p, g, wd, m):
    return g + (wd * m) * p if wd else g


def sgd(momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """SGD; the state is ``(buffer,)`` with momentum, else ``()``."""

    def init(params):
        if momentum:
            return (tree_map(torch.zeros_like, params),)
        return ()

    def update(grads, state, params, step, lr, mask):
        del step
        grads = tree_map(lambda p, g, m: _apply_decay(p, g, weight_decay, m),
                         params, grads, mask)
        if momentum:
            buf = tree_map(lambda b, g: momentum * b + g, state[0], grads)
            state, upd = (buf,), buf
        else:
            upd = grads
        return tree_map(lambda p, u: p - lr * u, params, upd), state

    return Optimizer(init, update)


def _bias_corrections(step, b1: float, b2: float):
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    return (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t),
            1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t))


def adam(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
         weight_decay: float = 0.0, decoupled: bool = False) -> Optimizer:
    """Adam (paper Eqn. 10 family); decoupled=True gives AdamW.  With
    ``weight_decay`` and ``decoupled=False`` the decay is an L2 term added
    to the gradient, masked per parameter, as in the reference."""

    def init(params):
        return (tree_map(torch.zeros_like, params),
                tree_map(torch.zeros_like, params))

    def update(grads, state, params, step, lr, mask):
        m, v = state
        if weight_decay and not decoupled:
            grads = tree_map(lambda p, g, mk: g + weight_decay * mk * p,
                             params, grads, mask)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, v, grads)
        bc1, bc2 = _bias_corrections(step, b1, b2)

        # bc1, bc2 and lr are 0-dim CPU tensors; the bias corrections
        # divide on the leaf's device (_on), one IEEE division as in the
        # reference (a CPU-scalar divisor would be x * (1/bc) on CUDA), and
        # the root is correctly rounded (_sqrt): the CPU's bits on the card
        def upd(p, m_, v_, mk):
            mhat = m_ / _on(bc1, m_)
            vhat = v_ / _on(bc2, v_)
            u = mhat / (_sqrt(vhat) + eps)
            if weight_decay and decoupled:
                u = u + weight_decay * mk * p
            return p - lr * u

        return tree_map(upd, params, m, v, mask), (m, v)

    return Optimizer(init, update)


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    return adam(b1, b2, eps, weight_decay, decoupled=True)


def lamb(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01) -> Optimizer:
    """LAMB: Adam update with the trust ratio ``|p| / |u|`` per leaf."""

    def init(params):
        return (tree_map(torch.zeros_like, params),
                tree_map(torch.zeros_like, params))

    def update(grads, state, params, step, lr, mask):
        m, v = state
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, v, grads)
        bc1, bc2 = _bias_corrections(step, b1, b2)

        def upd(p, m_, v_, mk):
            u = ((m_ / _on(bc1, m_)) / (_sqrt(v_ / _on(bc2, v_)) + eps)
                 + weight_decay * mk * p)
            wn = _norm(p)
            un = _norm(u)
            trust = torch.where((wn > 0) & (un > 0),
                                wn / torch.clamp(un, min=1e-12),
                                torch.ones_like(wn))
            return p - lr * trust * u

        return tree_map(upd, params, m, v, mask), (m, v)

    return Optimizer(init, update)


def _rms_clip(u: torch.Tensor, clip_threshold: float) -> torch.Tensor:
    rms = _sqrt(_mean_sq(u) + 1e-30)
    return u / torch.clamp(divide(rms, clip_threshold), min=1.0)


def _sorted_keys(tree) -> list[tuple[str, str]]:
    """``(group, name)`` in ``jax.tree.leaves`` order (sorted dict keys):
    the order the reference aligns the factored state tuple with."""
    return [(g, n) for g in sorted(tree) for n in sorted(tree[g])]


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_rate: float = 0.8,
              weight_decay: float = 0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern); factored second moment for leaves with
    ndim >= 2.  State: one ``(row, col)`` pair per leaf, in sorted-key
    order (non-factored leaves: ``(v, empty)``)."""

    def init(params):
        pairs = []
        for g, n in _sorted_keys(params):
            p = params[g][n]
            if p.dim() >= 2:
                pairs.append((p.new_zeros(p.shape[:-1]),
                              p.new_zeros(p.shape[:-2] + p.shape[-1:])))
            else:
                pairs.append((torch.zeros_like(p), p.new_zeros((0,))))
        return tuple(pairs)

    def update(grads, state, params, step, lr, mask):
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        beta2 = 1.0 - t ** -decay_rate
        new_p = {g: {} for g in params}
        new_s = []
        for (g, n), (vr, vc) in zip(_sorted_keys(params), state):
            p, gr = params[g][n], grads[g][n]
            g2 = gr * gr + eps
            if p.dim() >= 2:
                vr = beta2 * vr + (1 - beta2) * _mean(g2, -1)
                vc = beta2 * vc + (1 - beta2) * _mean(g2, -2)
                r = vr / torch.clamp(_mean(vr, -1, keepdim=True), min=eps)
                u = gr * _rsqrt(r)[..., None] * _rsqrt(vc)[..., None, :]
            else:
                vr = beta2 * vr + (1 - beta2) * g2
                u = gr * _rsqrt(vr)
            u = _rms_clip(u, clip_threshold)
            if weight_decay:
                u = u + weight_decay * mask[g][n] * p
            new_p[g][n] = p - lr * u
            new_s.append((vr, vc))
        out = {g: {n: new_p[g][n] for n in params[g]} for g in params}
        return out, tuple(new_s)

    return Optimizer(init, update)


def adafactor_flat(eps: float = 1e-30, clip_threshold: float = 1.0,
                   decay_rate: float = 0.8,
                   weight_decay: float = 0.0) -> Optimizer:
    """Adafactor with a non-factored second moment (the flat-chunk
    variant: factored statistics need the logical matrix shape, which the
    flat layout erases).  State: one chunk-mirroring tree."""

    def init(params):
        return (tree_map(torch.zeros_like, params),)

    def update(grads, state, params, step, lr, mask):
        (v,) = state
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        beta2 = 1.0 - t ** -decay_rate
        v = tree_map(lambda v_, g: beta2 * v_ + (1 - beta2) * (g * g + eps),
                     v, grads)

        def upd(p, g, v_, mk):
            u = _rms_clip(g * _rsqrt(v_), clip_threshold)
            if weight_decay:
                u = u + weight_decay * mk * p
            return p - lr * u

        return tree_map(upd, params, grads, v, mask), (v,)

    return Optimizer(init, update)


OPTIMIZERS: dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd,
    "adam": adam,
    "adamw": adamw,
    "lamb": lamb,
    "adafactor": adafactor,            # factored (reference / tests)
    "adafactor_flat": adafactor_flat,  # the flat-chunk runtime's
}


def global_grad_norm(grads) -> torch.Tensor:
    """The global L2 norm: every leaf's squares summed in f64, the total
    rounded once, then the correctly rounded root."""
    total = sum(sum_f64(g, g) for g in tree_leaves(grads))
    return _sqrt(total.float())


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-12))``, the quotient one IEEE
    division of a device-filled ``max_norm`` (a float over a tensor is a
    reciprocal times the float in torch)."""
    num = torch.full((), float(max_norm), dtype=torch.float32,
                     device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float,
                        norm: torch.Tensor | None = None):
    n = global_grad_norm(grads) if norm is None else norm
    scale = clip_scale(n, max_norm)
    return tree_map(lambda g: g * scale, grads), n
