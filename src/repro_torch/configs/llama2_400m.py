"""llama2-400m -- the paper-side config (GPT2-345M-scale llama used for the
from-scratch quality experiments, cf. paper Fig. 2(a)); the port's first
model and the width ``chip_smoke.py`` trains at.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama2-400m",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=32000,
    attn_kind="full",
    source="paper (LoCo) experimental setup",
))
