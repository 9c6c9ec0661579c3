"""Architecture + run configuration dataclasses and the registry.

Port of ``repro.configs.base``; the field set of :class:`ArchConfig` is the
reference's, so a config can be carried across field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # --- attention flavor ---------------------------------------------------
    attn_kind: str = "full"                 # full | swa | local_global
    window: int = 4096
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    parallel_block: bool = False            # command-r style
    mlp: str = "swiglu"                     # swiglu | geglu | gelu
    tied_embeddings: bool = False
    logit_scale: Optional[float] = None
    emb_scale: Optional[float] = None
    residual_scale: Optional[float] = None  # minicpm depth scaling
    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "tp_dense"              # tp_dense | ep_a2a
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3
    moe_a2a_codec: str = "fp"               # fp | block8 | block8+ef (ep_a2a only)
    n_shared_experts: int = 0
    n_expert_groups: int = 1
    group_top_k: int = 0
    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    # --- hybrid --------------------------------------------------------------
    hybrid_attn_every: int = 0
    # --- enc-dec (whisper) ---------------------------------------------------
    enc_dec: bool = False
    enc_layers: int = 0
    dec_len: int = 512
    # --- provenance ----------------------------------------------------------
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim


def reduced(cfg: ArchConfig, max_d: int = 256, n_layers: int = 2,
            max_experts: int = 4) -> ArchConfig:
    """Smoke-test variant: same family/flavor, tiny dims (the reference's
    rule, kept identical so both packages build the same reduced model)."""
    d = min(cfg.d_model, max_d)
    heads = max(1, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=d // heads,
        d_ff=min(cfg.d_ff, 2 * d) if cfg.n_experts == 0 else min(cfg.d_ff, d),
        vocab=min(cfg.vocab, 512),
        window=min(cfg.window, 64),
        dec_len=min(cfg.dec_len, 32),
    )
    if cfg.n_experts:
        changes["n_experts"] = min(cfg.n_experts, max_experts)
        changes["top_k"] = min(cfg.top_k, 2)
        if cfg.n_expert_groups > 1:
            g = min(cfg.n_expert_groups, changes["n_experts"] // 2)
            changes["n_expert_groups"] = max(g, 1)
            if cfg.group_top_k:
                changes["group_top_k"] = max(1, min(cfg.group_top_k, g - 1))
        if cfg.n_shared_experts:
            changes["n_shared_experts"] = 1
    if cfg.enc_dec:
        changes["enc_layers"] = n_layers
    if cfg.ssm_state:
        changes["ssm_state"] = min(cfg.ssm_state, 16)
        changes["ssm_headdim"] = 16
    if cfg.hybrid_attn_every:
        changes["hybrid_attn_every"] = 1
        changes["n_layers"] = 2
    return dataclasses.replace(cfg, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# the reference's input shapes (``repro.configs.base.SHAPES``): the dry
# run's train, prefill and decode cells
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs.all_archs  # noqa: F401  (the registry)

    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r} "
                         f"(ported: {sorted(_REGISTRY)})") from None


def list_archs() -> list[str]:
    import repro_torch.configs.all_archs  # noqa: F401

    return sorted(_REGISTRY)
