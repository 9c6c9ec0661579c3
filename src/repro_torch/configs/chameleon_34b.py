"""chameleon-34b [vlm] -- early-fusion VLM over VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ image codes).
The VQ tokenizer is the stubbed modality frontend: inputs are token ids that
already interleave text and image codes (early fusion), so the decoder is a
llama-like transformer with qk-norm (Chameleon's training stabilizer).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    attn_kind="full",
    rope_theta=10000.0,
    source="arXiv:2405.09818",
))
