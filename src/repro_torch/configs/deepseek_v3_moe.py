"""deepseek-v3-moe -- fine-grained experts + shared experts + grouped
routing (DeepSeek-V3-style geometry, reduced to 12 layers of d_model 1024).

The port's first MoE model, carried over field for field from the
reference's config: 64 routed experts of d_ff 512 with top-8 routing
limited to the 4 best of 8 expert groups, 2 always-on shared experts, GQA
attention (16 query heads over 4 kv heads of 64), and expert parallelism
with all-to-all dispatch (``ep_a2a``) through the compressed activation
wire (``moe_a2a_codec="block8"``, :mod:`repro_torch.core.act_comm`).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-moe",
    family="moe",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab=32000,
    mlp="swiglu",
    attn_kind="full",
    n_experts=64,
    top_k=8,
    moe_impl="ep_a2a",
    moe_a2a_codec="block8",
    n_shared_experts=2,
    n_expert_groups=8,
    group_top_k=4,
    aux_loss_coef=0.001,
    rope_theta=1e6,
    source="hf:deepseek-ai/DeepSeek-V3 (geometry-reduced)",
))
