"""whisper-small [audio] -- encoder-decoder ASR [arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768 12H (MHA) d_ff=3072 vocab=51865
(padded to 51872).  The mel-spectrogram + conv frontend is the stubbed
modality frontend: input_specs() provides (B, frames, 768) embeddings.
Shape mapping: seq_len = encoder frames; decoder length 512 (train/prefill),
decode = one decoder token against the cached encoder memory.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    norm="layernorm",
    mlp="gelu",
    enc_dec=True,
    enc_layers=12,
    dec_len=512,
    attn_kind="full",
    source="arXiv:2212.04356",
))
