"""h2o-danube-1.8b [dense] -- llama+mistral mix with SWA [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    attn_kind="swa",
    window=4096,
    source="arXiv:2401.16818",
))
