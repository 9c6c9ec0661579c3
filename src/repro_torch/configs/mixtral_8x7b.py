"""mixtral-8x7b [moe] -- 8 experts top-2, sliding-window attention [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA 4096.
Experts are tensor-parallel sharded (8 experts < TP=16 -> shard each expert's
ffn over TP; see DESIGN.md / models/moe.py "tp_dense").
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    attn_kind="swa",
    window=4096,
    n_experts=8,
    top_k=2,
    moe_impl="tp_dense",
    rope_theta=1e6,
    source="arXiv:2401.04088",
))
