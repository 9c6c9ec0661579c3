"""Optimizers over trees of flat f32 master chunks.

Port of ``repro.optim.optimizers`` (``adam``/``adamw`` and the global-norm
clip).  A tree is ``{group: {name: tensor}}``; the optimizer state is a
tuple of chunk-mirroring trees, so Adam moments are ZeRO-sharded with the
chunks.  ``update`` returns new parameter and state trees (the caller may
store them back in place); scalars (``step``, ``lr``, bias corrections) are
0-dim f32 tensors so the arithmetic is the reference's f32 arithmetic.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


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
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)

        # bc1, bc2 and lr are 0-dim CPU tensors: they enter device kernels
        # as scalars, with no copy to the device
        def upd(p, m_, v_, mk):
            mhat = m_ / bc1
            vhat = v_ / bc2
            u = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay and decoupled:
                u = u + weight_decay * mk * p
            return p - lr * u

        return tree_map(upd, params, m, v, mask), (m, v)

    return Optimizer(init, update)


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    return adam(b1, b2, eps, weight_decay, decoupled=True)


OPTIMIZERS: dict[str, Callable[..., Optimizer]] = {
    "adam": adam,
    "adamw": adamw,
}


def global_grad_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float,
                        norm: torch.Tensor | None = None):
    n = global_grad_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), n
