"""Sharded npz checkpointing (facade over :mod:`repro_torch.state`).

Port of ``repro.checkpoint.checkpoint``, in its format: one ``.npz`` per
checkpoint holding the train state (flat-param chunks, per-unit sync
states, optimizer moments) in the reference's **global** layout, and a v2
JSON manifest with history, per-array checksums and the run's layout
fingerprint.  So a checkpoint written by either framework restores into
the other.  Writes are atomic (tmp + rename), ``latest_step`` verifies
integrity and falls back to the previous manifest entry on corruption,
and ``restore`` can *reshard* a checkpoint written under a different dp
size / bucket layout / policy through logical space, or fails loudly
naming every mismatched field.

``save``/``restore``/``latest_step`` work on global trees.  The training
loop calls :func:`save_train_state` and :func:`resume`, which move one
rank's :class:`~repro_torch.launch.steps.TrainState` to and from that
layout.  On a ``dp x tp`` mesh the global layout is, per parameter
(``padlen`` that of its TP-local slice, ``C = padlen / dp``):

* master chunk and each Adam moment: ``(L?, TP, padlen)``, the rank at
  data index ``r`` and model index ``m`` owning ``[..., m, r*C:(r+1)*C]``;
* compressor state (each state unit under a sync plan): ``(L?, TP, D, n)``,
  that rank owning ``[..., m, r, :]``;
* the MoE combine residuals of ``block8+ef`` (``states/_moe_a2a/ef``, a
  rank's ``(L, 1, 1, n)``): ``(L, D, TP, n)``, that rank owning ``[:, r,
  m, :]``, the reference's layout.

With more than one rank, world rank 0 gathers every ``(data, model)``
piece and writes; on restore it reads (and reshards across dp at a fixed
tp) and scatters each rank its piece.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.state import manifest as MAN
from repro_torch.state import serial
from repro_torch.state.reshard import reshard as _reshard


def save(ckpt_dir: str, step: int, state: dict, *,
         fingerprint: "dict | None" = None, keep: int = 0) -> str:
    """state: dict of trees (``{"chunks":..., "states":..., "opt":...}``)
    of global tensors on any device.

    ``fingerprint`` (from :func:`repro_torch.state.build_fingerprint`)
    records the layout the arrays were written under, enabling mismatch
    detection and resharding at restore time.  ``keep > 0`` prunes the
    manifest history (and data files) to the newest ``keep`` checkpoints.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    stored = serial.encode_arrays(serial.flatten(state))
    path = os.path.join(ckpt_dir, MAN.ckpt_file(step))
    serial.save_npz_atomic(path, stored)
    # manifest goes last: a crash between the two leaves the previous
    # manifest intact, never a manifest pointing at a half-written file.
    MAN.add_entry(ckpt_dir, step, serial.checksums(stored), fingerprint,
                  keep=keep)
    return path


def latest_step(ckpt_dir: str) -> "int | None":
    """Newest checkpoint step that passes integrity verification.

    Corrupted/missing entries are skipped with a warning (falling back to
    the previous manifest entry) instead of being returned blindly.
    """
    if not os.path.exists(os.path.join(ckpt_dir, MAN.MANIFEST)):
        return None
    entry = MAN.latest_valid_entry(ckpt_dir)
    return None if entry is None else entry["step"]


def restore(ckpt_dir: str, step: int, template: dict, *,
            fingerprint: "dict | None" = None,
            reshard: bool = False) -> dict:
    """Restore into the structure of ``template`` (a tree of global
    tensors; ``meta`` tensors will do).  Returns CPU tensors.

    With a target ``fingerprint`` and a fingerprinted checkpoint, layout
    mismatches either reshard through logical space (``reshard=True``) or
    raise :class:`repro_torch.state.CheckpointMismatch` naming every
    differing field.  Without fingerprints the arrays must match the
    template in shape and dtype, checked up front with the key named.
    """
    entry = MAN.find_entry(ckpt_dir, step)
    fname = entry["file"] if entry is not None else MAN.ckpt_file(step)
    try:
        stored = serial.load_npz(os.path.join(ckpt_dir, fname))
    except Exception as e:
        raise ValueError(
            f"checkpoint step {step} failed integrity verification: "
            f"{fname}: unreadable ({e}) (latest_step() skips such "
            "entries)") from e
    if entry is not None:
        reason = MAN.verify_checksums(entry, stored)
        if reason is not None:
            raise ValueError(
                f"checkpoint step {step} failed integrity verification: "
                f"{reason} (latest_step() skips such entries)")
    data = serial.decode_arrays(stored)

    src_fp = entry.get("fingerprint") if entry is not None else None
    if fingerprint is not None and src_fp is None and reshard:
        raise ValueError(
            f"checkpoint step {step} carries no layout fingerprint (saved "
            "by a pre-manifest-v2 writer or without fingerprint=); it can "
            "only be restored into a bit-identical template — resharding "
            "has nothing to compare the target layout against")
    if fingerprint is not None and src_fp is not None:
        diff = MAN.fingerprint_diff(src_fp, fingerprint)
        if diff:
            if not reshard:
                raise MAN.CheckpointMismatch(
                    f"checkpoint step {step} was written under a different "
                    "layout; pass --resume-reshard to migrate it through "
                    "logical space. Differing fields:\n  "
                    + "\n  ".join(diff[:20])
                    + ("" if len(diff) <= 20
                       else f"\n  ... and {len(diff) - 20} more"))
            return _reshard(data, src_fp, fingerprint, template)

    out = {}
    for k, t in serial.flatten(template).items():
        if k not in data:
            raise ValueError(
                f"checkpoint step {step} is missing key {k!r} required by "
                "the restore template (topology/plan changed? resume with "
                "a fingerprint and --resume-reshard)")
        a = data[k]
        if tuple(a.shape) != tuple(t.shape) or a.dtype != t.dtype:
            raise ValueError(
                f"checkpoint key {k!r} has shape {tuple(a.shape)} dtype "
                f"{a.dtype}, but the restore template expects "
                f"{tuple(t.shape)} {t.dtype} (topology/plan changed? resume "
                "with a fingerprint and --resume-reshard)")
        out[k] = a
    return serial.unflatten(out, template)


# ---------------------------------------------------------------------------
# one data-parallel rank's train state <-> the global layout
# ---------------------------------------------------------------------------

def _tree(ts) -> dict:
    return {"chunks": ts.chunks, "states": ts.states, "opt": ts.opt}


def global_template(ts, dp: int, tp: int = 1) -> dict:
    """The global tree of a dp x tp mesh whose ranks hold train states
    shaped like ``ts``, as ``meta`` tensors (shapes and dtypes, no
    memory)."""
    flat = serial.flatten(_tree(ts))
    return serial.unflatten(
        {k: torch.empty(_global_shape(k, v, dp, tp), dtype=v.dtype,
                        device="meta") for k, v in flat.items()}, _tree(ts))


def _is_state(key: str) -> bool:
    return key.startswith("states/")


def _is_ef(key: str) -> bool:
    return key.startswith("states/_moe_a2a/")


def _global_shape(key: str, local: torch.Tensor, dp: int, tp: int) -> tuple:
    *lead, n = local.shape
    if _is_ef(key):
        return (local.shape[0], dp, tp, n)
    if _is_state(key):
        return (*lead, tp, dp, n)
    return (*lead, tp, dp * n)


def _rank_piece(key: str, g: torch.Tensor, rank: int, n: int,
                tp_rank: int = 0):
    """The piece (``n`` trailing elements) of a global leaf that the rank
    at data index ``rank`` and model index ``tp_rank`` owns."""
    if _is_ef(key):
        return g[:, rank:rank + 1, tp_rank:tp_rank + 1, :]
    if _is_state(key):
        return g[..., tp_rank, rank, :]
    return g[..., tp_rank, rank * n:(rank + 1) * n]


def _assemble(key: str, pieces: list, dp: int, tp: int) -> torch.Tensor:
    """Every rank's piece, in world order (``data * tp + model``) -> the
    global leaf."""
    if _is_ef(key):
        L, n = pieces[0].shape[0], pieces[0].shape[-1]
        return torch.stack([p.reshape(L, n) for p in pieces],
                           dim=1).reshape(L, dp, tp, n)
    *lead, n = pieces[0].shape
    rows = torch.stack(pieces, dim=-2).reshape(*lead, dp, tp, n)
    rows = rows.transpose(-3, -2)
    if _is_state(key):
        return rows.contiguous()
    return rows.reshape(*lead, tp, dp * n)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def save_train_state(ckpt_dir: str, step: int, ts, topo, *,
                     fingerprint: "dict | None" = None,
                     keep: int = 0) -> None:
    """Save one rank's share of the train state ``ts``: world rank 0
    gathers every leaf from every ``(data, model)`` rank into the global
    layout and writes; every rank returns once the checkpoint is on
    disk."""
    flat = serial.flatten(_tree(ts))
    n_ranks = topo.dp * topo.tp
    if n_ranks == 1:
        glob = {k: v.reshape(_global_shape(k, v, 1, 1))
                for k, v in flat.items()}
        writer = True
    else:
        world = topo.world
        writer = dist.get_rank(world) == 0
        dst = dist.get_global_rank(world, 0)
        glob = {}
        for k, v in flat.items():
            parts = ([torch.empty_like(_bytes(v)) for _ in range(n_ranks)]
                     if writer else None)
            dist.gather(_bytes(v), parts, dst=dst, group=world)
            if writer:
                glob[k] = _assemble(k, [p.view(v.dtype).view(v.shape)
                                        for p in parts], topo.dp, topo.tp)
    if writer:
        save(ckpt_dir, step, serial.unflatten(glob, _tree(ts)),
             fingerprint=fingerprint, keep=keep)
    if n_ranks > 1:
        dist.barrier(group=topo.world)


def resume(ckpt_dir: str, ts, topo, *, fingerprint: "dict | None" = None,
           reshard: bool = False) -> "int | None":
    """Restore the newest valid checkpoint of ``ckpt_dir`` into ``ts`` in
    place (each leaf keeps its tensor, device and layout) and return its
    step; None when the directory holds none.  World rank 0 picks the
    step, reads (and reshards) the global tree, and scatters each rank its
    piece."""
    flat = serial.flatten(_tree(ts))
    n_ranks = topo.dp * topo.tp
    world = topo.world
    reader = n_ranks == 1 or dist.get_rank(world) == 0
    step = latest_step(ckpt_dir) if reader else None
    if n_ranks > 1:
        box = [step]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(world, 0), group=world)
        step = box[0]
    if step is None:
        return None
    glob = None
    if reader:
        glob = serial.flatten(restore(
            ckpt_dir, step, global_template(ts, topo.dp, topo.tp),
            fingerprint=fingerprint, reshard=reshard))
    for k, v in flat.items():
        if n_ranks == 1:
            v.copy_(_rank_piece(k, glob[k], 0, v.shape[-1]))
            continue
        pieces = None
        if reader:
            pieces = [_bytes(_rank_piece(k, glob[k], w // topo.tp,
                                         v.shape[-1], w % topo.tp)
                             .to(v.device)) for w in range(n_ranks)]
        got = torch.empty_like(_bytes(v))
        dist.scatter(got, pieces, src=dist.get_global_rank(world, 0),
                     group=world)
        v.copy_(got.view(v.dtype).view(v.shape))
    return step
