"""What a run makes from its ``--seed``: the weights and the tokens.

Both are drawn on the run's device by a ``torch.Generator`` there, in a
few large calls: one per weight tensor (every layer of a stacked tensor
in the same call), one for a run's whole pool of token batches.  A seed
up to 2**64 - 1 gives the same draws on the same device every time, so
the reference redraws exactly the weights and batches the program got.

The tokens are a copy of the program's synthetic stream
(``repro_torch.data.synthetic.make_batch_fn``): a cluster id walks a
cycle of ``n_clusters`` every 8 tokens and each cluster draws from its
own jittered zipf distribution over the vocabulary; this copy draws every
batch of a pool in one call.
"""
from __future__ import annotations

import torch

from bench.reference.model import Leaf

MASK64 = (1 << 63) - 1


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + salt * 7_919 + 1) & MASK64)


def draw(leaf: Leaf, index: int, seed: int, device) -> torch.Tensor:
    """Leaf number ``index`` of a configuration, float32 ``(rows,
    numel)``: ones, or normal draws times ``leaf.scale``."""
    if leaf.init == "ones":
        return torch.ones(leaf.rows, leaf.numel, device=device)
    gen = generator(seed, 1 + index, device)
    out = torch.randn(leaf.rows, leaf.numel, generator=gen, device=device)
    return out.mul_(leaf.scale)


def logical(leaf: Leaf, flat: torch.Tensor) -> torch.Tensor:
    """``(rows, numel)`` -> the leaf's logical tensor (a stacked leaf with
    its layer axis first)."""
    shape = ((leaf.layers,) if leaf.layers else ()) + leaf.shape
    return flat.view(shape)


def weights(leaves: list[Leaf], seed: int, device) -> dict:
    """Every leaf's logical float32 tensor, ``{(group, name): tensor}``."""
    return {(lf.group, lf.name): logical(lf, draw(lf, i, seed, device))
            for i, lf in enumerate(leaves)}


def tokens(vocab: int, n_clusters: int, shape: tuple, seed: int,
           device) -> torch.Tensor:
    """int64 tokens of ``shape`` (..., S): rows of the zipf-cluster
    stream, each row starting in a cluster of its own draw."""
    gen = generator(seed, 0, device)
    f64 = torch.float64
    ranks = torch.arange(1, vocab + 1, dtype=f64, device=device)
    logits = -1.1 * torch.log(ranks) + 0.3 * torch.randn(
        n_clusters, vocab, generator=gen, dtype=f64, device=device)
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    flat_cdf = (cdf + torch.arange(n_clusters, dtype=f64, device=device)
                [:, None]).reshape(-1)
    *lead, S = shape
    start = torch.randint(0, n_clusters, (*lead, 1), generator=gen,
                          device=device)
    clusters = (start + torch.arange(S, device=device) // 8) % n_clusters
    u = torch.rand(shape, generator=gen, dtype=f64, device=device)
    idx = torch.searchsorted(flat_cdf, (clusters + u).reshape(-1))
    toks = idx.view(shape) - clusters * vocab
    return toks.clamp_(0, vocab - 1)
