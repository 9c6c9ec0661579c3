"""Decoder-only LM: the dense, vlm, MoE, ssm and hybrid families.

Port of the training paths of ``repro.models.transformer``: parameter
declarations (:func:`build_groups`), the attention / MLP / MoE / mamba
blocks and :class:`DecoderLM`'s forward and loss.  Layers run in a Python
loop; each layer materializes its weights from the FSDP chunks inside the
layer, and with ``remat`` the layer runs under ``torch.utils.checkpoint``
(non-reentrant), the counterpart of the reference's ``jax.checkpoint`` over
its layer scan: the recomputation regathers the layer's weights, and each
gather's backward (its sync) runs once, from the first forward's graph.

At ``tp > 1`` the model runs Megatron-style tensor parallelism over the
``model`` process group (:mod:`repro_torch.models.common`): vocab-parallel
embedding, logits and loss, column/row-parallel attention and MLP, and in
training sequence parallelism between the blocks; the MoE family shards
its experts over the same group (:mod:`repro_torch.models.moe`).

Every feature of the pool's attention decoders is ported: full, sliding
window (``swa``) and alternating local/global attention, qk-norm, the
attention and final soft caps, RMSNorm or LayerNorm, sequential or
parallel (command-r) blocks, SwiGLU / GeGLU / GELU MLPs, tied embeddings,
the embedding, residual and logit scales, and the MoE family (``tp_dense``
and ``ep_a2a`` with the ``fp``, ``block8`` and ``block8+ef`` activation
codecs).  The vlm family (chameleon) runs as dense.  The ssm family
(mamba2) stacks mamba2 mixers (:mod:`repro_torch.models.ssm`); the hybrid
(zamba2) runs super-blocks of ``hybrid_attn_every`` mamba layers followed
by one application of a *shared* attention + MLP block (the ``shared``
group, names prefixed ``s_``), checkpointed per super-block as the
reference does.  The shared block is gathered once per microbatch, before
the super-blocks, so its gradient sums over every application (and the
recomputation adds nothing) before its one sync.  The audio family
(whisper) is :mod:`repro_torch.models.whisper`.

Serving (the reference's ``forward(caches=...)``, ``_prefill_unrolled``
and ``decode_step``): :meth:`DecoderLM.prefill` runs a prompt through
the layers into a :class:`DecodeState` (a ring :class:`KVCache` per
attention layer, or per application of the hybrid's shared block, and a
:class:`MambaCache` of conv contexts and SSD state per mamba layer), and
:meth:`DecoderLM.decode_step` steps one token, the caches written in
place.  Both run the layers in a Python loop under
``torch.inference_mode`` with no recomputation.  A cache's window is the
caller's: ``init_decode_state`` takes it (an ``swa`` layer keeps at most
``cfg.window``), and serving sizes it to the whole generation
(``launch/steps.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import act_comm as ACT
from repro_torch.core.flatparam import ParamGroup, ParamInfo
from repro_torch.models import common as C
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.common import HeadLayout, KVCache

LOCO_MIN_NUMEL = 2**16  # smaller tensors sync in bf16
SHARED = "s_"  # name prefix of the hybrid's shared attention block


def _loco(shape) -> bool:
    return math.prod(shape) >= LOCO_MIN_NUMEL


def _pi(name, shape, tp_dim=None, init="normal", init_scale=None, decay=True):
    return ParamInfo(name=name, shape=tuple(shape), tp_dim=tp_dim, init=init,
                     init_scale=init_scale, loco=_loco(shape), decay=decay)


def vocab_padded(cfg: ArchConfig, tp: int) -> int:
    return C.pad_to_multiple(cfg.vocab, tp)


def head_layout(cfg: ArchConfig, tp: int) -> HeadLayout:
    return HeadLayout.make(cfg.n_heads, cfg.n_kv_heads, cfg.hd, tp)


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what the port has not ported yet instead of ignoring it."""
    unported = {
        "family": cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid",
                                     "audio"),
        "attn_kind": cfg.attn_kind not in ("full", "swa", "local_global"),
        "mlp": cfg.mlp not in ("swiglu", "geglu", "gelu"),
        "norm": cfg.norm not in ("rmsnorm", "layernorm"),
    }
    if cfg.family == "moe":
        unported["moe_a2a_codec"] = \
            cfg.moe_a2a_codec not in ACT.MOE_A2A_CODECS
        unported["moe_impl"] = cfg.moe_impl not in ("ep_a2a", "tp_dense")
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet (ROADMAP.md)")


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------

def _attn_infos(cfg: ArchConfig, lay: HeadLayout, prefix: str = ""):
    d, hd = cfg.d_model, lay.head_dim
    kv_tp = 1 if lay.kv_sharded else None
    infos = [
        _pi(prefix + "norm1", (d,), init="ones", decay=False),
        _pi(prefix + "wq", (d, lay.h_pad * hd), tp_dim=1),
        _pi(prefix + "wk", (d, lay.kv_pad * hd), tp_dim=kv_tp),
        _pi(prefix + "wv", (d, lay.kv_pad * hd), tp_dim=kv_tp),
        _pi(prefix + "wo", (lay.h_pad * hd, d), tp_dim=0),
    ]
    if cfg.qk_norm:
        infos += [_pi(prefix + "qnorm", (hd,), init="ones", decay=False),
                  _pi(prefix + "knorm", (hd,), init="ones", decay=False)]
    return infos


def _gated(cfg: ArchConfig) -> bool:
    """The MLP has a gate (``w3``, ``ws3``): swiglu and geglu."""
    return cfg.mlp in ("swiglu", "geglu")


def _mlp_infos(cfg: ArchConfig, prefix: str = ""):
    d, f = cfg.d_model, cfg.d_ff
    infos = [
        _pi(prefix + "norm2", (d,), init="ones", decay=False),
        _pi(prefix + "w1", (d, f), tp_dim=1),
        _pi(prefix + "w2", (f, d), tp_dim=0),
    ]
    if _gated(cfg):
        infos.append(_pi(prefix + "w3", (d, f), tp_dim=1))
    return infos


def _moe_infos(cfg: ArchConfig):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    # (w1/w3 tp_dim, w2 tp_dim): d_ff sliced (tp_dense) or experts sharded
    w_tp = (2, 1) if cfg.moe_impl == "tp_dense" else (0, 0)
    infos = [
        _pi("norm2", (d,), init="ones", decay=False),
        _pi("router", (d, E)),
        _pi("w1", (E, d, f), tp_dim=w_tp[0], init_scale=1.0 / math.sqrt(d)),
        _pi("w2", (E, f, d), tp_dim=w_tp[1], init_scale=1.0 / math.sqrt(f)),
    ]
    if _gated(cfg):
        infos.append(_pi("w3", (E, d, f), tp_dim=w_tp[0],
                         init_scale=1.0 / math.sqrt(d)))
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        infos += [
            _pi("ws1", (d, fs), tp_dim=1, init_scale=1.0 / math.sqrt(d)),
            _pi("ws2", (fs, d), tp_dim=0, init_scale=1.0 / math.sqrt(fs)),
        ]
        if _gated(cfg):
            infos.append(_pi("ws3", (d, fs), tp_dim=1,
                             init_scale=1.0 / math.sqrt(d)))
    return infos


def _mamba_infos(cfg: ArchConfig):
    d, dil, N, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.d_conv)
    return [
        _pi("normm", (d,), init="ones", decay=False),
        _pi("w_z", (d, dil), tp_dim=1),
        _pi("w_x", (d, dil), tp_dim=1),
        _pi("w_B", (d, N)),
        _pi("w_C", (d, N)),
        _pi("w_dt", (d, H), tp_dim=1),
        _pi("dt_bias", (H,), tp_dim=0, init="zeros", decay=False),
        _pi("A_log", (H,), tp_dim=0, init="zeros", decay=False),
        _pi("D", (H,), tp_dim=0, init="ones", decay=False),
        _pi("conv_x", (K, dil), tp_dim=1, init_scale=1.0 / math.sqrt(K)),
        _pi("conv_B", (K, N), init_scale=1.0 / math.sqrt(K)),
        _pi("conv_C", (K, N), init_scale=1.0 / math.sqrt(K)),
        _pi("normg", (dil,), tp_dim=0, init="ones", decay=False),
        _pi("w_out", (dil, d), tp_dim=0),
    ]


def build_groups(cfg: ArchConfig, tp: int) -> list[ParamGroup]:
    check_supported(cfg)
    vp = vocab_padded(cfg, tp)
    d = cfg.d_model
    head = [] if cfg.tied_embeddings else [_pi("head", (d, vp), tp_dim=1)]
    groups = [
        ParamGroup("embed", (
            _pi("tok", (vp, d), tp_dim=0, init="embed", init_scale=0.02),)),
        ParamGroup("final", tuple(
            [_pi("norm_f", (d,), init="ones", decay=False)] + head)),
    ]
    if cfg.family in ("dense", "vlm", "moe"):
        ffn = _moe_infos(cfg) if cfg.family == "moe" else _mlp_infos(cfg)
        infos = _attn_infos(cfg, head_layout(cfg, tp)) + ffn
    elif cfg.family in ("ssm", "hybrid"):
        infos = _mamba_infos(cfg)
    else:
        raise ValueError(cfg.family)
    groups.append(ParamGroup("block", tuple(infos), n_layers=cfg.n_layers))
    if cfg.family == "hybrid":
        if not cfg.hybrid_attn_every or cfg.n_layers % cfg.hybrid_attn_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             "make super-blocks of hybrid_attn_every="
                             f"{cfg.hybrid_attn_every}")
        shared = (_attn_infos(cfg, head_layout(cfg, tp), prefix=SHARED)
                  + _mlp_infos(cfg, prefix=SHARED))
        groups.append(ParamGroup("shared", tuple(shared)))
    return groups


# ---------------------------------------------------------------------------
# block forwards
# ---------------------------------------------------------------------------

def _qkv(p, x, lay: HeadLayout, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    hd = lay.head_dim
    q = C.col_linear(x, p["wq"]).reshape(B, S, lay.hl, hd)
    k = C.col_linear(x, p["wk"]).reshape(B, S, lay.kvl, hd)
    v = C.col_linear(x, p["wv"]).reshape(B, S, lay.kvl, hd)
    if cfg.qk_norm:
        q = C.rmsnorm(q, p["qnorm"])
        k = C.rmsnorm(k, p["knorm"])
    q = C.rope(q, positions, cfg.rope_theta)
    k = C.rope(k, positions, cfg.rope_theta)
    return q, k, v


def layer_window(cfg: ArchConfig, layer_idx: int) -> int | None:
    """Layer ``layer_idx``'s attention window (None: full causal): ``swa``
    windows every layer, ``local_global`` the even ones."""
    if cfg.attn_kind == "swa":
        return cfg.window
    if cfg.attn_kind == "local_global" and layer_idx % 2 == 0:
        return cfg.window
    return None


def attention_block(p, x, cfg: ArchConfig, lay: HeadLayout, positions,
                    group=None, sp: bool = False, layer_idx: int = 0,
                    cache: KVCache | None = None, start: int = 0):
    """Returns the attention output (pre-residual).  ``group``: the model
    group (None at ``tp = 1``).  Under ``sp`` x is the (B, S/tp, d)
    sequence shard: the norm runs on the shard, the block gathers the full
    sequence for attention and returns a reduce-scattered shard.
    ``layer_idx``: the global layer index (its window).

    With a ``cache`` (serving; ``positions`` = ``start + arange(S)``): a
    prompt (S > 1) attends over its own keys and is then written to the
    cache (this rank's window shard under context parallelism); one token
    (S == 1) is written first and attends over the cache."""
    h = C.norm(cfg.norm, x, p["norm1"])
    if sp:
        h = C.sp_gather(h, group)
    B, S, _ = h.shape
    q, k, v = _qkv(p, h, lay, cfg, positions)
    window = layer_window(cfg, layer_idx)
    runs = None if lay.kv_identity else lay.kv_runs(C.tp_rank(group))
    if cache is None:
        if runs is not None:
            k, v = C.expand_kv(k, runs), C.expand_kv(v, runs)
        out = C.attention(q, k, v, window=window, softcap=cfg.attn_softcap)
    else:
        out = _cached_attention(q, k, v, lay, positions, cache, start, runs,
                                group, window, cfg.attn_softcap)
    out = out.reshape(B, S, lay.hl * lay.head_dim)
    return C.row_linear(out, p["wo"], group, sp)


def _cached_attention(q, k, v, lay: HeadLayout, positions, cache: KVCache,
                      start: int, runs, group, window, softcap):
    """The serving branches of :func:`attention_block` (the reference's
    attention_block with a cache)."""
    cp = C.cp_degree(lay)
    rank = C.tp_rank(group)
    if q.shape[1] > 1:
        # prefill into an empty cache: attend over the in-flight k/v
        kq, vq = ((k, v) if runs is None
                  else (C.expand_kv(k, runs), C.expand_kv(v, runs)))
        out = C.prefill_attention(q, kq, vq, positions, window=window,
                                  softcap=softcap)
        if cp > 1:
            C.build_cp_cache(cache, k, v, cp, rank)
        else:
            cache.append(k, v, start)
        return out
    if cp > 1:
        C.cp_append(cache, k, v, start, cp, rank)
        return C.cp_decode_attention(q, cache, lay, positions, group,
                                     window=window, softcap=softcap)
    cache.append(k, v, start)
    kq, vq = ((cache.k, cache.v) if runs is None
              else (C.expand_kv(cache.k, runs), C.expand_kv(cache.v, runs)))
    return C.attention_at(q, kq, vq, positions, cache.pos, window=window,
                          softcap=softcap)


def mlp_block(p, x, cfg: ArchConfig, group=None, sp: bool = False):
    h = C.norm(cfg.norm, x, p["norm2"])
    if sp:
        h = C.sp_gather(h, group)
    a = C.col_linear(h, p["w1"])
    b = C.col_linear(h, p["w3"]) if _gated(cfg) else None
    return C.row_linear(C.activation(cfg.mlp, a, b), p["w2"], group, sp)


def _res(cfg: ArchConfig, x, delta):
    """The residual add, ``delta`` scaled by ``residual_scale`` (rounded
    to the activation's dtype, as the reference's weak-typed scalar)."""
    if cfg.residual_scale is None:
        return x + delta
    return x + C.scale_by(delta, cfg.residual_scale)


def dense_block(p, x, cfg: ArchConfig, lay: HeadLayout, positions,
                group=None, sp: bool = False, layer_idx: int = 0,
                cache: KVCache | None = None, start: int = 0):
    if cfg.parallel_block:
        # attention and MLP both read x; one residual add takes their sum
        a = attention_block(p, x, cfg, lay, positions, group, sp, layer_idx,
                            cache, start)
        return _res(cfg, x, a + mlp_block(p, x, cfg, group, sp))
    x = _res(cfg, x, attention_block(p, x, cfg, lay, positions, group, sp,
                                     layer_idx, cache, start))
    return _res(cfg, x, mlp_block(p, x, cfg, group, sp))


def moe_layer(p, x, cfg: ArchConfig, lay: HeadLayout, positions, group,
              sp: bool = False, a2a_state=None, layer_idx: int = 0,
              cache: KVCache | None = None, start: int = 0):
    """Attention then the MoE FFN; returns (x, router aux, router z), and
    the layer's new combine EF residual after them when ``a2a_state`` is
    given.  ``group``: the model group (the expert exchange runs on it
    also at ``tp = 1``).  Serving passes no ``a2a_state``: ``block8+ef``
    then exchanges as the stateless ``block8``, as in the reference."""
    tpg = group if C.tp_size(group) > 1 else None
    x = _res(cfg, x, attention_block(p, x, cfg, lay, positions, tpg, sp,
                                     layer_idx, cache, start))
    h = C.norm(cfg.norm, x, p["norm2"])
    if sp:
        h = C.sp_gather(h, tpg)
    y, aux = MOE.moe_block(h, p, cfg, group, sp=sp, a2a_state=a2a_state)
    x = _res(cfg, x, y)
    if a2a_state is not None:
        return x, aux["aux"], aux["z"], aux["a2a_state"]
    return x, aux["aux"], aux["z"]


@dataclasses.dataclass
class MambaCache:
    """One mamba layer's decode state: ``conv``, the (x, B, C) trailing
    conv contexts, (B, K-1, ch) bf16 each; ``ssm``, the (B, Hl, N, P) f32
    SSD state.  Rewritten by each call."""

    conv: tuple
    ssm: torch.Tensor


def mamba_layer(p, x, cfg: ArchConfig, group=None, sp: bool = False,
                cache: MambaCache | None = None, single_step: bool = False):
    """Pre-norm mamba2 mixer with its residual.  With a ``cache``
    (serving) the conv starts from ``cache.conv`` and the SSD scan from
    ``cache.ssm`` (a fresh cache's zeros for a prompt, as in the
    reference; a later prefill continues the sequence, where the
    reference restarts the conv from zeros), ``single_step`` steps one
    token, and the new contexts (rounded to bf16, as the reference stores
    them; each a (B, K-1, ch) tensor of its own) and state replace the
    cache's."""
    h = C.norm("rmsnorm", x, p["normm"])
    if sp:
        h = C.sp_gather(h, group)
    if cache is None:
        y, _ = SSM.mamba2_mixer(h, p, cfg, group=group, sp=sp)
        return _res(cfg, x, y)
    y, (conv, S) = SSM.mamba2_mixer(h, p, cfg, conv_cache=cache.conv,
                                    ssm_state=cache.ssm,
                                    single_step=single_step, group=group)
    cache.conv = tuple(c.to(torch.bfloat16) for c in conv)
    cache.ssm = S
    return _res(cfg, x, y)


def _unprefixed(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# decode state (serving)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    """A rank's serving caches: ``kv``, one :class:`KVCache` per attention
    layer (per application of the hybrid's shared block); ``mamba``, one
    :class:`MambaCache` per mamba layer; ``pos``, the next absolute
    position."""

    kv: list
    mamba: list
    pos: int = 0


def _conv_zeros(cfg: ArchConfig, tp: int, batch_local: int, device):
    K, N = cfg.d_conv, cfg.ssm_state
    return tuple(torch.zeros(batch_local, K - 1, ch, dtype=torch.bfloat16,
                             device=device)
                 for ch in (cfg.d_inner // tp, N, N))


def init_decode_state(cfg: ArchConfig, tp: int, batch_local: int,
                      window: int, device) -> DecodeState:
    """Empty caches for ``batch_local`` rows and a ``window``-token KV
    window: at most ``cfg.window`` slots under ``swa``, and ceil(W / tp)
    on a rank under context parallelism (the hybrid keeps ``window``
    whole, as the reference does)."""
    kv, mamba = [], []
    if cfg.family in ("dense", "vlm", "moe", "hybrid"):
        lay = head_layout(cfg, tp)
        n, w = cfg.n_layers, window
        if cfg.family == "hybrid":
            n = cfg.n_layers // cfg.hybrid_attn_every
        else:
            if cfg.attn_kind == "swa":
                w = min(window, cfg.window)
            w = -(-w // C.cp_degree(lay))
        kv = [KVCache.create(batch_local, w, lay.kvl, lay.head_dim, device)
              for _ in range(n)]
    elif cfg.family != "ssm":
        raise ValueError(cfg.family)
    if cfg.family in ("ssm", "hybrid"):
        mamba = [MambaCache(_conv_zeros(cfg, tp, batch_local, device),
                            torch.zeros(batch_local, cfg.ssm_heads // tp,
                                        cfg.ssm_state, cfg.ssm_headdim,
                                        dtype=torch.float32, device=device))
                 for _ in range(cfg.n_layers)]
    return DecodeState(kv=kv, mamba=mamba)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecoderLM:
    cfg: ArchConfig
    tp: int = 1
    # the ``model`` process group: tensor-parallel collectives at tp > 1,
    # the MoE ep_a2a exchange at any tp
    model_group: object = dataclasses.field(default=None, compare=False)
    sp: bool = False  # Megatron sequence parallelism (training only)

    def __post_init__(self):
        check_supported(self.cfg)
        if self.tp > 1 and C.tp_size(self.model_group) != self.tp:
            raise ValueError(f"tp={self.tp} needs a model group of that "
                             "size (launch.mesh.mesh_groups)")

    def groups(self) -> list[ParamGroup]:
        return build_groups(self.cfg, self.tp)

    @property
    def tp_group(self):
        """The model group of the TP collectives (None at tp = 1, where
        the model issues none)."""
        return self.model_group if self.tp > 1 else None

    def forward(self, store, tokens, *, remat: bool = True,
                moe_a2a_state=None):
        """tokens: (B, S) -> (local logits (B, S, V_local), aux {"aux",
        "z"}): the router losses summed over layers (zeros for the dense
        family).  Sequence parallelism runs when ``sp``, ``tp > 1`` and
        ``tp`` divides S, as in the reference.

        ``moe_a2a_state``: the ``(n_layers, state_len)`` MoE combine EF
        stack (``block8+ef``), read and not written; the new stack rides
        back as ``aux["moe_a2a_state"]``.  Under ``remat`` the recomputed
        forward reads the same stack and its new one is dropped, so the
        caller stores the new stack once per microbatch."""
        cfg = self.cfg
        S = tokens.shape[1]
        tpg = self.tp_group
        sp = self.sp and self.tp > 1 and S % self.tp == 0
        positions = torch.arange(S, device=tokens.device)
        x, emb = self._embed(store, tokens, sp)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        z = torch.zeros((), dtype=torch.float32, device=tokens.device)

        ef = moe_a2a_state if cfg.family == "moe" else None
        new_ef = []
        # the hybrid runs its layers in super-blocks (_hybrid_forward)
        layers = 0 if cfg.family == "hybrid" else cfg.n_layers
        for l in range(layers):
            def body(xc, ef_l=None, l=l):
                p = store.layer("block", l)
                if cfg.family == "moe":
                    return moe_layer(p, xc, cfg, self._lay, positions,
                                     self.model_group, sp, ef_l, l)
                if cfg.family == "ssm":
                    return mamba_layer(p, xc, cfg, tpg, sp)
                return dense_block(p, xc, cfg, self._lay, positions, tpg, sp,
                                   l)

            args = (x,) if ef is None else (x, ef[l])
            out = (checkpoint(body, *args, use_reentrant=False) if remat
                   else body(*args))
            if cfg.family == "moe":
                x, a_l, z_l = out[:3]
                aux, z = aux + a_l, z + z_l
                if ef is not None:
                    new_ef.append(out[3])
            else:
                x = out
        if cfg.family == "hybrid":
            x = self._hybrid_forward(store, x, positions, remat, sp)

        if sp:
            x = C.sp_gather(x, tpg)  # exit sequence parallelism
        out_aux = {"aux": aux, "z": z}
        if ef is not None:
            out_aux["moe_a2a_state"] = torch.stack(new_ef)
        return self._logits(store, x, emb), out_aux

    @property
    def _lay(self) -> HeadLayout | None:
        """The attention's head layout (None for the ssm family)."""
        if self.cfg.family == "ssm":
            return None
        return head_layout(self.cfg, self.tp)

    def _hybrid_forward(self, store, x, positions, remat: bool, sp: bool):
        """Super-blocks of ``hybrid_attn_every`` mamba layers, each followed
        by one application of the shared attention + MLP block (its
        attention window by super-block index, as the reference passes
        it); each super-block is checkpointed whole.  The shared block is
        gathered here, once: every application, and the recomputation,
        reads the same tensors."""
        cfg, tpg = self.cfg, self.tp_group
        k = cfg.hybrid_attn_every
        shared = _unprefixed(store.group("shared"), SHARED)
        for sidx in range(cfg.n_layers // k):
            def super_body(xc, sidx=sidx):
                for j in range(k):
                    xc = mamba_layer(store.layer("block", sidx * k + j), xc,
                                     cfg, tpg, sp)
                xc = _res(cfg, xc, attention_block(
                    shared, xc, cfg, self._lay, positions, tpg, sp, sidx))
                return _res(cfg, xc, mlp_block(shared, xc, cfg, tpg, sp))

            x = (checkpoint(super_body, x, use_reentrant=False) if remat
                 else super_body(x))
        return x

    def _logits(self, store, x, emb):
        fin = store.group("final")
        x = C.norm(self.cfg.norm, x, fin["norm_f"])
        w = emb.T if self.cfg.tied_embeddings else fin["head"]
        logits = C.vocab_parallel_logits(x, w)
        if self.cfg.logit_scale:
            logits = C.scale_by(logits, self.cfg.logit_scale)
        return logits

    def _embed(self, store, tokens, sp: bool = False):
        """-> (x, the embedding table): gathered (and synced in the
        backward) once, the tied logits reuse it."""
        emb = store.group("embed")["tok"]
        x = C.vocab_parallel_embed(emb, tokens, self.tp_group, sp)
        if self.cfg.emb_scale:
            x = C.scale_by(x, self.cfg.emb_scale)
        return x, emb

    def _cached_layers(self, store, x, state: DecodeState,
                       single_step: bool):
        """Every layer over ``x`` (B, S, d) at positions ``state.pos +
        arange(S)``, reading and writing ``state``'s caches."""
        cfg, tpg = self.cfg, self.tp_group
        start = state.pos
        positions = torch.arange(start, start + x.shape[1], device=x.device)
        if cfg.family == "ssm":
            for l in range(cfg.n_layers):
                x = mamba_layer(store.layer("block", l), x, cfg, tpg,
                                cache=state.mamba[l],
                                single_step=single_step)
            return x
        if cfg.family == "hybrid":
            k = cfg.hybrid_attn_every
            shared = _unprefixed(store.group("shared"), SHARED)
            for sidx in range(cfg.n_layers // k):
                for j in range(k):
                    l = sidx * k + j
                    x = mamba_layer(store.layer("block", l), x, cfg, tpg,
                                    cache=state.mamba[l],
                                    single_step=single_step)
                x = _res(cfg, x, attention_block(
                    shared, x, cfg, self._lay, positions, tpg,
                    layer_idx=sidx, cache=state.kv[sidx], start=start))
                x = _res(cfg, x, mlp_block(shared, x, cfg, tpg))
            return x
        for l in range(cfg.n_layers):
            p = store.layer("block", l)
            if cfg.family == "moe":
                x = moe_layer(p, x, cfg, self._lay, positions,
                              self.model_group, layer_idx=l,
                              cache=state.kv[l], start=start)[0]
            else:
                x = dense_block(p, x, cfg, self._lay, positions, tpg,
                                layer_idx=l, cache=state.kv[l], start=start)
        return x

    @torch.inference_mode()
    def prefill(self, store, tokens, state: DecodeState,
                last: int | None = None):
        """tokens: (B, S) prompt -> (local logits (B, S, V_local), state):
        the reference's ``forward(caches=...)`` (``_prefill_unrolled``)
        from an empty ``state``, whose caches it fills; ``state.pos``
        advances by S.  With ``last`` only the last ``last`` positions'
        logits are computed, (B, last, V_local).  The logits are not
        soft-capped, as the reference's prefill returns them."""
        x, emb = self._embed(store, tokens)
        x = self._cached_layers(store, x, state, single_step=False)
        state.pos += tokens.shape[1]
        if last is not None:
            x = x[:, -last:]
        return self._logits(store, x, emb), state

    @torch.inference_mode()
    def decode_step(self, store, state: DecodeState, token):
        """token: (B, 1) -> (local logits (B, 1, V_local), state): one token
        at ``state.pos`` through the caches, which it updates; the bf16
        logits soft-capped by ``final_softcap`` (:func:`common.soft_cap`),
        which the reference applies here and not to the prefill's."""
        x, emb = self._embed(store, token)
        x = self._cached_layers(store, x, state, single_step=True)
        state.pos += 1
        logits = self._logits(store, x, emb)
        if self.cfg.final_softcap:
            logits = C.soft_cap(logits, self.cfg.final_softcap)
        return logits, state

    def loss_fn(self, store, batch, remat: bool = True, moe_a2a_state=None):
        """-> (total loss, {"ce", "aux", "z"}); the total adds the router
        losses, weighted, for the MoE family.  With ``moe_a2a_state`` the
        dict also holds the new EF stack under ``"moe_a2a_state"``."""
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits, aux = self.forward(store, inputs, remat=remat,
                                   moe_a2a_state=moe_a2a_state)
        loss = C.vocab_parallel_xent(logits, targets, self.cfg.vocab,
                                     self.tp_group,
                                     softcap=self.cfg.final_softcap)
        total = loss
        if self.cfg.n_experts:
            total = (total + self.cfg.aux_loss_coef * aux["aux"]
                     + self.cfg.router_z_coef * aux["z"])
        return total, {"ce": loss, **aux}
