"""Logical-space views of the sharded train state (host-side).

Port of ``repro.state.logical``, on CPU torch tensors where the reference
uses numpy arrays (numpy holds bf16 and f8 only through ``ml_dtypes``,
which the port does without).  Everything the runtime lays out *forward*
at init -- flat padded vector -> ``D`` rank chunks -> chunk-space buckets
-> quantized per-unit error states -- this module runs backward and
forward again, so a checkpoint written under one ``(topology, plan)`` can
be re-expressed under another:

* **Chunk space.** A parameter's global chunk array ``(..., TP, padlen)``
  *is* its logical flat padded vector (rank ``d`` owns ``[d*C, (d+1)*C)``),
  so chunk repartitioning is: truncate the pad to the ``numel`` real
  elements, re-pad to the target ``padlen'``.
* **Error space.** Unit ``b``'s stored state ``(..., D, seg_b)`` holds,
  per source rank, the compensation error of chunk-space columns
  ``[off_b, off_b + c_b)`` of the ``(D, C)`` view of that rank's local
  gradient.  Decoding each unit through its codec's ``state_decode`` and
  writing the columns back gives the logical per-rank f32 error
  ``(..., D, padlen)``.
* **Rank migration.** The compensation that reaches the averaged gradient
  is ``mean_d e_d``, so migrating ``D -> D'`` ranks replicates the source
  mean to every target rank; ``D' == D`` passes the per-rank states
  through untouched (the identity reshard is bit-exact).

All functions take and return tensors with leading batch dims ``(L?, TP)``
and operate on the trailing axes only.
"""
from __future__ import annotations

import torch

from repro_torch.core import codec as codec_lib
from repro_torch.state import manifest as MAN


# ---------------------------------------------------------------------------
# chunk space (master chunks, chunk-mirroring optimizer state)
# ---------------------------------------------------------------------------

def repartition_flat(a: torch.Tensor, numel: int,
                     pad_tgt: int) -> torch.Tensor:
    """``(..., pad_src)`` -> ``(..., pad_tgt)`` preserving the real elements.

    Positions ``>= numel`` are padding under every topology; they are
    re-zeroed when the pad length changes and passed through untouched
    when it does not.
    """
    if a.shape[-1] == pad_tgt:
        return a
    out = torch.zeros(a.shape[:-1] + (pad_tgt,), dtype=a.dtype)
    n = min(numel, a.shape[-1], pad_tgt)
    out[..., :n] = a[..., :n]
    return out


# ---------------------------------------------------------------------------
# error space (per-unit compressor states)
# ---------------------------------------------------------------------------

def _state_codec(bd: dict) -> codec_lib.Codec:
    return codec_lib.get_codec(MAN.bucket_sync_config(bd))


def decode_state(arr: torch.Tensor, bd: dict) -> torch.Tensor:
    """One unit's stored state -> f32 logical error values."""
    return _state_codec(bd).state_decode(arr).float()


def encode_state(e: torch.Tensor, bd: dict) -> torch.Tensor:
    """f32 logical error values -> the unit's storage dtype."""
    return _state_codec(bd).state_encode(e.float())


def stitch_error(unit_arrays: "list[torch.Tensor]", units: "list[dict]",
                 dp: int, chunklen: int) -> torch.Tensor:
    """Per-unit stored states -> logical per-rank error ``(..., D, pad)``.

    ``unit_arrays[i]`` is unit i's global state ``(..., D, seg_i)`` (or a
    ``(..., D, 1)`` dummy for stateless units, which contribute zero
    error).  Element ``(dev, r*C + off + j)`` of the result came from unit
    state ``(dev, r*c_b + j)``.
    """
    lead = unit_arrays[0].shape[:-2]
    view = torch.zeros(lead + (dp, dp, chunklen), dtype=torch.float32)
    for arr, bd in zip(unit_arrays, units):
        if not bd["needs_state"]:
            continue
        c, off = bd["chunk_elems"], bd["offset"]
        if tuple(arr.shape[-2:]) != (dp, bd["seg_elems"]):
            raise MAN.CheckpointMismatch(
                f"state unit of shape {tuple(arr.shape)}, the fingerprint "
                f"says (..., {dp}, {bd['seg_elems']})")
        view[..., off:off + c] = decode_state(arr, bd).reshape(
            lead + (dp, dp, c))
    return view.reshape(lead + (dp, dp * chunklen))


def migrate_error_devices(e: torch.Tensor, dp_tgt: int) -> torch.Tensor:
    """``(..., D, pad)`` -> ``(..., D', pad)``: the identity at ``D' == D``
    (bit-exact); otherwise every target rank gets the source-rank mean,
    preserving ``mean_d e_d``."""
    dp_src = e.shape[-2]
    if dp_src == dp_tgt:
        return e
    m = e.mean(dim=-2, keepdim=True, dtype=torch.float32)
    return m.expand(e.shape[:-2] + (dp_tgt, e.shape[-1])).clone()


def split_error(e: torch.Tensor, units: "list[dict]",
                chunklen: int) -> "list[torch.Tensor]":
    """Logical per-rank error ``(..., D, pad)`` -> target unit states.

    Inverse of :func:`stitch_error` under the target plan: slice each
    unit's chunk-space columns and re-encode into its storage dtype;
    stateless units get their ``(..., D, 1)`` f32 dummy.
    """
    lead, dp = e.shape[:-2], e.shape[-2]
    view = e.reshape(lead + (dp, dp, chunklen))
    out = []
    for bd in units:
        if not bd["needs_state"]:
            out.append(torch.zeros(lead + (dp, 1), dtype=torch.float32))
            continue
        c, off = bd["chunk_elems"], bd["offset"]
        seg = view[..., off:off + c].reshape(lead + (dp, bd["seg_elems"]))
        out.append(encode_state(seg, bd))
    return out
