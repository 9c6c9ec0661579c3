"""Import every architecture config the port runs (populates the registry).

``ASSIGNED`` is the reference's list (``repro.configs.all_archs``) in its
order, without the three families the port does not run yet
(:data:`repro_torch.configs.base.NOT_PORTED`).
"""
from repro_torch.configs import (  # noqa: F401
    chameleon_34b,
    command_r_35b,
    deepseek_v3_moe,
    gemma2_27b,
    h2o_danube_1p8b,
    llama2_400m,
    minicpm_2b,
    mixtral_8x7b,
    qwen3_moe_30b_a3b,
)

ASSIGNED = [
    "chameleon-34b",
    "mixtral-8x7b",
    "qwen3-moe-30b-a3b",
    "deepseek-v3-moe",
    "minicpm-2b",
    "gemma2-27b",
    "command-r-35b",
    "h2o-danube-1.8b",
]
