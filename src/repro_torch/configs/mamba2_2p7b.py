"""mamba2-2.7b [ssm] -- SSD state-space duality, attention-free [arXiv:2405.21060].

64L d_model=2560 d_state=128 headdim=64 expand=2 (d_inner=5120, 80 ssm heads)
conv4, vocab=50280 (padded to 50288).  The SSD chunked scan runs in
matmul form (models/ssm.py).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    expand=2,
    d_conv=4,
    source="arXiv:2405.21060",
))
