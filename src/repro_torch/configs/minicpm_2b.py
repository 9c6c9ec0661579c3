"""minicpm-2b [dense] -- WSD schedule, depth-scaled residuals [arXiv:2404.06395].

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753 (padded to 122768 for
TP16).  MiniCPM constants: scale_emb=12, residual scale 1.4/sqrt(40), logits
divided by d_model/256; tied embeddings; trains with the WSD schedule
(optim/schedules.py).  36 heads pad to 48 for TP=16.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    attn_kind="full",
    tied_embeddings=True,
    emb_scale=12.0,
    residual_scale=1.4 / 40 ** 0.5,
    logit_scale=256.0 / 2304.0,
    source="arXiv:2404.06395",
))
