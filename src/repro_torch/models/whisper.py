"""Whisper-style encoder-decoder (audio family).

Port of the training path of ``repro.models.whisper``.  The
mel-spectrogram and conv1d frontend is the reference's stubbed modality
frontend: the batch carries pre-computed frame embeddings of shape
``(B, frames, d_model)``.  The encoder is bidirectional self-attention
over the frames with sinusoidal positions; the decoder is a causal LM
with cross-attention to the encoder memory and a head tied to the token
embedding (gathered once per microbatch: the embedding and the head share
one sync).

Shapes (the reference's): ``seq_len`` is the encoder's frame count; the
decoder trains on ``cfg.dec_len`` tokens.  At ``tp > 1`` the heads, the
MLP and the vocabulary shard over the ``model`` group as in the decoder
(no sequence parallelism, as in the reference).

Serving (the reference's ``init_decode_state`` and ``decode_step``): the
encoder runs once over the frames, in the reference's 512-key blocks,
and each decoder token attends over a ring
:class:`~repro_torch.models.common.KVCache` of its self-attention keys
per layer and across to the encoder memory, whose keys and values
are projected again at every step, as the reference does.  The token's
learned position is ``pos_dec[min(pos, dec_len - 1)]``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flatparam import ParamGroup
from repro_torch.models import common as C
from repro_torch.models.common import HeadLayout, KVCache
from repro_torch.models.transformer import (_pi, check_supported,
                                            head_layout, vocab_padded)


def sinusoidal(positions, d: int):
    """(S,) positions -> (S, d) f32 [sin | cos] table.  The reference
    writes ``-log(10000) * arange(half) / max(half - 1, 1)``; XLA folds
    the two constants into one f32 factor and multiplies once, so the
    port does (``scale_by``): the reference's exponents bit for bit."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(C.scale_by(ar, -math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_infos(cfg: ArchConfig, lay: HeadLayout):
    d, f, hd = cfg.d_model, cfg.d_ff, lay.head_dim
    kv_tp = 1 if lay.kv_sharded else None
    return [
        _pi("norm1", (d,), init="ones", decay=False),
        _pi("wq", (d, lay.h_pad * hd), tp_dim=1),
        _pi("wk", (d, lay.kv_pad * hd), tp_dim=kv_tp),
        _pi("wv", (d, lay.kv_pad * hd), tp_dim=kv_tp),
        _pi("wo", (lay.h_pad * hd, d), tp_dim=0),
        _pi("norm2", (d,), init="ones", decay=False),
        _pi("w1", (d, f), tp_dim=1),
        _pi("w2", (f, d), tp_dim=0),
    ]


def _dec_block_infos(cfg: ArchConfig, lay: HeadLayout):
    d, hd = cfg.d_model, lay.head_dim
    kv_tp = 1 if lay.kv_sharded else None
    cross = [
        _pi("normx", (d,), init="ones", decay=False),
        _pi("xq", (d, lay.h_pad * hd), tp_dim=1),
        _pi("xk", (d, lay.kv_pad * hd), tp_dim=kv_tp),
        _pi("xv", (d, lay.kv_pad * hd), tp_dim=kv_tp),
        _pi("xo", (lay.h_pad * hd, d), tp_dim=0),
    ]
    return _enc_block_infos(cfg, lay) + cross


def build_groups(cfg: ArchConfig, tp: int) -> list[ParamGroup]:
    check_supported(cfg)
    lay = head_layout(cfg, tp)
    vp = vocab_padded(cfg, tp)
    d = cfg.d_model
    return [
        ParamGroup("embed", (
            _pi("tok", (vp, d), tp_dim=0, init="embed", init_scale=0.02),
            _pi("pos_dec", (cfg.dec_len, d), init="embed", init_scale=0.01),
        )),
        ParamGroup("enc_block", tuple(_enc_block_infos(cfg, lay)),
                   n_layers=cfg.enc_layers),
        ParamGroup("dec_block", tuple(_dec_block_infos(cfg, lay)),
                   n_layers=cfg.n_layers),
        ParamGroup("final", (
            _pi("norm_enc", (d,), init="ones", decay=False),
            _pi("norm_f", (d,), init="ones", decay=False),
        )),
    ]


def _mha(p, x, kv_src, lay: HeadLayout, causal: bool, group,
         names=("wq", "wk", "wv", "wo"), cache: KVCache | None = None,
         pos: int = 0):
    """Attention of ``x``'s queries over ``kv_src``'s keys (self-attention
    when they are the same tensor), finished by the row-parallel output
    projection over ``group``.  With a ``cache`` (decoder self-attention
    while serving) the new keys at position ``pos`` are appended first and
    the query at ``pos`` attends over the cache.  Serving (autograd off)
    takes the reference's PREFILL_BLOCK_K-key blocks, the last one ragged,
    for several queries (the encoder); one query (a decode step's
    cross-attention) and training take every key in one block."""
    B, Sq, _ = x.shape
    Sk, hd = kv_src.shape[1], lay.head_dim
    nq, nk, nv, no = names
    q = C.col_linear(x, p[nq]).reshape(B, Sq, lay.hl, hd)
    k = C.col_linear(kv_src, p[nk]).reshape(B, Sk, lay.kvl, hd)
    v = C.col_linear(kv_src, p[nv]).reshape(B, Sk, lay.kvl, hd)
    if cache is not None:
        cache.append(k, v, pos)
        k, v = cache.k, cache.v
    if not lay.kv_identity:
        runs = lay.kv_runs(C.tp_rank(group))
        k, v = C.expand_kv(k, runs), C.expand_kv(v, runs)
    if cache is None and Sq > 1 and not torch.is_grad_enabled():
        q_pos, k_pos = (torch.arange(n, device=x.device) for n in (Sq, Sk))
        out = C.blockwise_attention(q, k, v, q_pos, k_pos, causal=causal,
                                    block_k=C.PREFILL_BLOCK_K)
    elif cache is None:
        out = C.attention(q, k, v, causal=causal)
    else:
        q_pos = torch.arange(pos, pos + Sq, device=x.device)
        out = C.attention_at(q, k, v, q_pos, cache.pos)
    return C.row_linear(out.reshape(B, Sq, lay.hl * hd), p[no], group)


def _mlp(p, h, group):
    a = C.activation("gelu", C.col_linear(h, p["w1"]))
    return C.row_linear(a, p["w2"], group)


@dataclasses.dataclass
class WhisperDecodeState:
    """A rank's serving state: ``self_kv``, one self-attention
    :class:`KVCache` per decoder layer; ``memory``, the (B, frames, d)
    encoder output; ``pos``, the next decoder position."""

    self_kv: list
    memory: torch.Tensor
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class EncDecLM:
    cfg: ArchConfig
    tp: int = 1
    # the ``model`` process group of the TP collectives (None at tp = 1)
    model_group: object = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        check_supported(self.cfg)
        if self.tp > 1 and C.tp_size(self.model_group) != self.tp:
            raise ValueError(f"tp={self.tp} needs a model group of that "
                             "size (launch.mesh.mesh_groups)")

    def groups(self) -> list[ParamGroup]:
        return build_groups(self.cfg, self.tp)

    @property
    def tp_group(self):
        return self.model_group if self.tp > 1 else None

    def _layers(self, store, gname: str, n: int, x, body, remat: bool):
        for l in range(n):
            def run(xc, l=l):
                return body(store.layer(gname, l), xc)

            x = (checkpoint(run, x, use_reentrant=False) if remat
                 else run(x))
        return x

    def encode(self, store, frames, remat: bool = True):
        """frames: (B, T_f, d) stub embeddings -> memory (B, T_f, d)."""
        cfg, tpg = self.cfg, self.tp_group
        lay = head_layout(cfg, self.tp)
        pos = torch.arange(frames.shape[1], device=frames.device)
        x = (frames.to(torch.bfloat16)
             + sinusoidal(pos, cfg.d_model)[None].to(torch.bfloat16))

        def body(p, xc):
            h = C.norm(cfg.norm, xc, p["norm1"])
            xc = xc + _mha(p, h, h, lay, False, tpg)
            return xc + _mlp(p, C.norm(cfg.norm, xc, p["norm2"]), tpg)

        x = self._layers(store, "enc_block", cfg.enc_layers, x, body, remat)
        return C.norm(cfg.norm, x, store.group("final")["norm_enc"])

    def decode_seq(self, store, memory, tokens, remat: bool = True):
        """tokens: (B, S) -> local logits (B, S, V_local)."""
        cfg, tpg = self.cfg, self.tp_group
        lay = head_layout(cfg, self.tp)
        S = tokens.shape[1]
        emb = store.group("embed")
        x = C.vocab_parallel_embed(emb["tok"], tokens, tpg)
        x = x + emb["pos_dec"][None, :S].to(x.dtype)

        def body(p, xc):
            h = C.norm(cfg.norm, xc, p["norm1"])
            xc = xc + _mha(p, h, h, lay, True, tpg)
            h = C.norm(cfg.norm, xc, p["normx"])
            xc = xc + _mha(p, h, memory, lay, False, tpg,
                           names=("xq", "xk", "xv", "xo"))
            return xc + _mlp(p, C.norm(cfg.norm, xc, p["norm2"]), tpg)

        x = self._layers(store, "dec_block", cfg.n_layers, x, body, remat)
        # the final group is gathered again, as the reference does: each
        # gather syncs the gradient of its own use
        x = C.norm(cfg.norm, x, store.group("final")["norm_f"])
        return C.vocab_parallel_logits(x, emb["tok"].T)  # tied head

    def init_decode_state(self, memory, batch_local: int,
                          window: int) -> WhisperDecodeState:
        """Empty ``window``-slot self-attention caches beside ``memory``."""
        lay = head_layout(self.cfg, self.tp)
        kv = [KVCache.create(batch_local, window, lay.kvl, lay.head_dim,
                             memory.device) for _ in range(self.cfg.n_layers)]
        return WhisperDecodeState(self_kv=kv, memory=memory)

    @torch.inference_mode()
    def decode_step(self, store, state: WhisperDecodeState, token):
        """token: (B, 1) -> (local logits (B, 1, V_local), state): one
        decoder token at ``state.pos``, its self-attention caches updated
        in place."""
        cfg, tpg = self.cfg, self.tp_group
        lay = head_layout(cfg, self.tp)
        pos = state.pos
        emb = store.group("embed")
        x = C.vocab_parallel_embed(emb["tok"], token, tpg)
        pidx = min(pos, cfg.dec_len - 1)
        x = x + emb["pos_dec"][None, pidx:pidx + 1].to(x.dtype)
        memory = state.memory.to(torch.bfloat16)
        for l in range(cfg.n_layers):
            p = store.layer("dec_block", l)
            h = C.norm(cfg.norm, x, p["norm1"])
            x = x + _mha(p, h, h, lay, True, tpg, cache=state.self_kv[l],
                         pos=pos)
            h = C.norm(cfg.norm, x, p["normx"])
            x = x + _mha(p, h, memory, lay, False, tpg,
                         names=("xq", "xk", "xv", "xo"))
            x = x + _mlp(p, C.norm(cfg.norm, x, p["norm2"]), tpg)
        x = C.norm(cfg.norm, x, store.group("final")["norm_f"])
        state.pos += 1
        return C.vocab_parallel_logits(x, emb["tok"].T), state

    def loss_fn(self, store, batch, remat: bool = True):
        """batch: ``frames`` (B, T_f, d) and ``tokens`` (B, dec_len + 1)
        -> (loss, {"ce": loss})."""
        memory = self.encode(store, batch["frames"], remat)
        tokens = batch["tokens"]
        logits = self.decode_seq(store, memory, tokens[:, :-1], remat)
        loss = C.vocab_parallel_xent(logits, tokens[:, 1:], self.cfg.vocab,
                                     self.tp_group)
        return loss, {"ce": loss}
