"""zamba2-2.7b [hybrid] -- Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers d_model=2560 ssm_state=64, with one *shared* full-attention
(+MLP) block applied after every 6th mamba block (9 applications, shared
weights -- gradients sum across reuse sites then LoCo-sync once).  32 MHA
heads kv=32, d_ff=10240 for the shared block, vocab=32000.
Simplifications vs the released model are listed in DESIGN.md §9.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    attn_kind="full",
    ssm_state=64,
    ssm_headdim=64,
    expand=2,
    d_conv=4,
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
))
