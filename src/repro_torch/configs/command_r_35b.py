"""command-r-35b [dense] -- GQA, no bias, parallel block [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000; LayerNorm (no RMS),
parallel attention+FFN residual block, tied embeddings, logit_scale=0.0625.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm="layernorm",
    parallel_block=True,
    tied_embeddings=True,
    logit_scale=0.0625,
    attn_kind="full",
    rope_theta=8e6,
    source="hf:CohereForAI/c4ai-command-r-v01",
))
