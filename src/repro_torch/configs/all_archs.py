"""Import every architecture config (populates the registry).

``ASSIGNED`` is the reference's list (``repro.configs.all_archs``) in its
order.
"""
from repro_torch.configs import (  # noqa: F401
    chameleon_34b,
    command_r_35b,
    deepseek_v3_moe,
    gemma2_27b,
    h2o_danube_1p8b,
    llama2_400m,
    mamba2_2p7b,
    minicpm_2b,
    mixtral_8x7b,
    qwen3_moe_30b_a3b,
    whisper_small,
    zamba2_2p7b,
)

ASSIGNED = [
    "chameleon-34b",
    "mixtral-8x7b",
    "qwen3-moe-30b-a3b",
    "deepseek-v3-moe",
    "minicpm-2b",
    "gemma2-27b",
    "zamba2-2.7b",
    "whisper-small",
    "command-r-35b",
    "mamba2-2.7b",
    "h2o-danube-1.8b",
]
