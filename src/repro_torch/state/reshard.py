"""Cross-topology / cross-plan migration of a checkpointed train state.

Port of ``repro.state.reshard``.  ``reshard`` takes the decoded arrays of
one checkpoint (written under the *source* fingerprint), routes every leaf
through the logical-space views of :mod:`repro_torch.state.logical`, and
re-materializes the tree the *target* run expects (its ``template``
provides structure, shapes and dtypes; ``meta`` tensors will do):

* master chunks and chunk-mirroring optimizer state: truncate the source
  pad to the real elements, re-pad to the target ``padlen``;
* per-unit compressor states: decode each source unit to f32 through its
  codec, stitch the chunk-space columns into the logical per-rank error,
  migrate the rank axis (identity at equal ``D``, mean-replication
  otherwise), and re-bucket + re-quantize under the target plan;
* stateless dummies: fresh zeros in the template's shape.

Supported migrations: dp size, bucket layout (``--bucket-mb``), per-bucket
policy (strategies, bits, error codecs), and monolithic <-> planned state
layouts.  TP resharding and optimizer or architecture changes are
rejected loudly, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.state import logical, serial
from repro_torch.state.manifest import CheckpointMismatch


def _params_by_qualname(fp: dict) -> dict:
    return {f"{p['group']}/{p['name']}": p for p in fp["params"]}


def _check_compatible(src: dict, tgt: dict) -> None:
    if src["topo"]["tp"] != tgt["topo"]["tp"]:
        raise CheckpointMismatch(
            f"cannot reshard across TP sizes (checkpoint tp="
            f"{src['topo']['tp']}, target tp={tgt['topo']['tp']}): per-TP "
            "flat slices interleave differently in every logical tensor; "
            "re-slicing needs the logical tensor shapes, which this "
            "checkpoint format does not store")
    sp, tp = _params_by_qualname(src), _params_by_qualname(tgt)
    if set(sp) != set(tp):
        only_s = sorted(set(sp) - set(tp))[:5]
        only_t = sorted(set(tp) - set(sp))[:5]
        raise CheckpointMismatch(
            "cannot reshard across model architectures: parameter sets "
            f"differ (only in checkpoint: {only_s}, only in target: {only_t})")
    for q in sp:
        for field in ("numel", "layers", "stacked", "loco"):
            if sp[q][field] != tp[q][field]:
                raise CheckpointMismatch(
                    f"cannot reshard params[{q}]: {field} differs "
                    f"(checkpoint={sp[q][field]!r}, target={tp[q][field]!r})")


def _migrate_chunk_like(key: str, a: torch.Tensor, pmeta_src: dict,
                        pmeta_tgt: dict, tpl_leaf) -> torch.Tensor:
    if a.shape[-1] != pmeta_src["padlen"]:
        raise CheckpointMismatch(
            f"{key}: stored last dim {a.shape[-1]} is not the checkpoint "
            f"padlen {pmeta_src['padlen']}; this leaf is not chunk-shaped")
    out = logical.repartition_flat(a, pmeta_src["numel"],
                                   pmeta_tgt["padlen"])
    if out.shape != tpl_leaf.shape:
        raise CheckpointMismatch(
            f"{key}: resharded shape {tuple(out.shape)} does not match the "
            f"target template {tuple(tpl_leaf.shape)}")
    return out


def _source_state_arrays(data: dict, src: dict, g: str, n: str,
                         pmeta: dict) -> "list[torch.Tensor]":
    """The stored state leaf(s) of one param, always as a per-unit list."""
    base = f"states/{g}/{n}"
    if src["planned"] and pmeta["loco"]:
        return [data[f"{base}/{i}"] for i in range(len(pmeta["buckets"]))]
    return [data[base]]


def _migrate_states(data: dict, src: dict, tgt: dict, g: str, n: str,
                    tpl_leaf):
    q = f"{g}/{n}"
    ps, pt = _params_by_qualname(src)[q], _params_by_qualname(tgt)[q]
    tpl_leaves = (list(tpl_leaf) if isinstance(tpl_leaf, tuple)
                  else [tpl_leaf])
    if not pt["loco"]:
        out = [torch.zeros(t.shape, dtype=t.dtype) for t in tpl_leaves]
    else:
        arrs = _source_state_arrays(data, src, g, n, ps)
        e = logical.stitch_error(arrs, ps["buckets"], src["topo"]["dp"],
                                 ps["chunklen"])
        e = logical.migrate_error_devices(e, tgt["topo"]["dp"])
        e = logical.repartition_flat(e, pt["numel"], pt["padlen"])
        out = logical.split_error(e, pt["buckets"], pt["chunklen"])
    if len(out) != len(tpl_leaves):
        raise CheckpointMismatch(
            f"states/{q}: target plan yields {len(out)} state leaves but "
            f"the template holds {len(tpl_leaves)}")
    for i, (o, t) in enumerate(zip(out, tpl_leaves)):
        if o.shape != t.shape or o.dtype != t.dtype:
            raise CheckpointMismatch(
                f"states/{q}[{i}]: resharded {tuple(o.shape)}/{o.dtype} "
                f"does not match the target template "
                f"{tuple(t.shape)}/{t.dtype}")
    return tuple(out) if isinstance(tpl_leaf, tuple) else out[0]


def reshard(data: "dict[str, torch.Tensor]", src: dict, tgt: dict, template):
    """Re-express a checkpoint's arrays under the target fingerprint.

    ``data``: decoded arrays keyed by flattened path
    (:func:`repro_torch.state.serial.decode_arrays`).  ``template``: the
    target run's global state tree (structure, shapes, dtypes).  Returns a
    tree of CPU tensors matching ``template``.
    """
    _check_compatible(src, tgt)
    sp, tp = _params_by_qualname(src), _params_by_qualname(tgt)
    out = {}

    # states leaves are handled per param (tuple-vs-array layout may change
    # between source and target), so walk the template one level up there.
    for section, sub in template.items():
        if section == "states":
            continue
        for key, tpl_leaf in serial.flatten(sub, f"{section}/").items():
            parts = key.split("/")
            q = "/".join(parts[-2:])
            if q not in sp:
                raise CheckpointMismatch(
                    f"{key}: {q!r} is not a known parameter of the "
                    "checkpoint fingerprint")
            if key not in data:
                raise CheckpointMismatch(
                    f"{key}: missing from the checkpoint (optimizer "
                    "changed? state tuples cannot be invented by reshard)")
            out[key] = _migrate_chunk_like(key, data[key], sp[q], tp[q],
                                           tpl_leaf)
    for g, sub in template.get("states", {}).items():
        for n, tpl_leaf in sub.items():
            leaf = _migrate_states(data, src, tgt, g, n, tpl_leaf)
            out.update(serial.flatten({f"states/{g}/{n}": leaf}))
    return serial.unflatten(out, template)
