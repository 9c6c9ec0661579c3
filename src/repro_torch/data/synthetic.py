"""Deterministic synthetic data pipeline.

The reference's recipe (``repro.data.synthetic``) drawn from a
``torch.Generator``: a token stream with a zipf-ish marginal and a
short-range Markov flavor (a cluster id walks a cycle every 8 tokens; each
cluster has its own jittered zipf distribution), so a language model has
learnable structure and the loss falls.  Batches are a pure function of
(seed, step).  The bits differ from the JAX stream (different generators);
the distribution is the same.  :func:`make_whisper_batch_fn` adds the
audio family's stub frame embeddings, standard normal in bf16.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_clusters: int = 32   # markov states; larger -> harder task


def make_batch_fn(cfg: DataConfig):
    """Returns batch_fn(step) -> {"tokens": (global_batch, seq_len+1) int64}
    on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    ranks = torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
    logits = -1.1 * torch.log(ranks) + 0.3 * torch.randn(
        cfg.n_clusters, cfg.vocab, generator=gen, dtype=torch.float64)
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    # one sorted sequence over all clusters: cluster c's CDF shifted by c,
    # so a draw u in [0, 1) of cluster c is searchsorted(c + u)
    flat_cdf = (cdf + torch.arange(cfg.n_clusters, dtype=torch.float64)
                [:, None]).reshape(-1)

    def batch_fn(step: int) -> dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(cfg.seed * 1_000_003 + step + 1)
        B, S = cfg.global_batch, cfg.seq_len + 1
        start = torch.randint(0, cfg.n_clusters, (B, 1), generator=g)
        clusters = (start + torch.arange(S)[None, :] // 8) % cfg.n_clusters
        u = torch.rand(B, S, generator=g, dtype=torch.float64)
        idx = torch.searchsorted(flat_cdf, clusters + u)
        toks = torch.clamp(idx - clusters * cfg.vocab, 0, cfg.vocab - 1)
        return {"tokens": toks}

    return batch_fn


def make_whisper_batch_fn(cfg: DataConfig, d_model: int, dec_len: int):
    """Returns batch_fn(step) -> {"frames": (global_batch, seq_len,
    d_model) bf16, "tokens": (global_batch, dec_len + 1) int64} on the
    CPU: ``seq_len`` is the encoder's frame count, the tokens are the
    token stream at the decoder's length."""
    tok_fn = make_batch_fn(dataclasses.replace(cfg, seq_len=dec_len))

    def batch_fn(step: int) -> dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(
            (cfg.seed * 1_000_003 + step + 1) * 7 + 3)
        frames = torch.randn(cfg.global_batch, cfg.seq_len, d_model,
                             generator=g).to(torch.bfloat16)
        return {"frames": frames, "tokens": tok_fn(step)["tokens"]}

    return batch_fn
