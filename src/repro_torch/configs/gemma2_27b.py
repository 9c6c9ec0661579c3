"""gemma2-27b [dense] -- local+global alternating attention, logit softcaps [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) head_dim=128 d_ff=36864 vocab=256000.
Even layers use a 4096 sliding window, odd layers full attention; attention
logits softcapped at 50, final logits at 30; GeGLU MLP; embeddings scaled by
sqrt(d_model); tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    attn_kind="local_global",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp="geglu",
    tied_embeddings=True,
    emb_scale=4608.0 ** 0.5,
    source="arXiv:2408.00118",
))
