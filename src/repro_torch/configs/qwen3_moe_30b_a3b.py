"""qwen3-moe-30b-a3b [moe] -- 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) head_dim=128 d_ff=768(per-expert) vocab=151936,
MoE 128e top-8 with normalized top-k probs and qk-norm.  Experts are
expert-parallel over the "model" axis with all-to-all token dispatch
(models/moe.py "ep_a2a") -- the collective-heavy arch of the pool.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    qk_norm=True,
    attn_kind="full",
    n_experts=128,
    top_k=8,
    moe_impl="ep_a2a",
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
))
