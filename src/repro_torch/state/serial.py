"""Array (de)serialization for checkpoints: flatten, dtype views, atomic npz.

Port of ``repro.state.serial``.  numpy's npz container cannot store
bfloat16 / float8 arrays natively (the reference registers them through
``ml_dtypes``, which the port does without), so sub-f32 dtypes are stored
as unsigned integer views with the true dtype recorded in the key, as the
reference stores them: ``name::bfloat16`` holds ``uint16`` words,
``name::float8_e4m3fn`` ``uint8`` codes.  The views are taken on the torch
tensor (``Tensor.view``), so the bytes are the tensor's own, and
:func:`decode_arrays` views them back as CPU torch tensors of the true
dtype.

Writes are **atomic**: the npz is written to a ``.tmp`` sibling and
``os.replace``d into place, so a crash mid-write never leaves a
half-written file under the final name (the manifest is updated only after
the data file exists; see :mod:`repro_torch.state.manifest`).
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch

DTYPE_SEP = "::"

# dtype stored as a same-width integer view: (name in the key, view dtype
# on the torch side, numpy dtype of the stored words).  int16 is the torch
# side of bf16 because older torch builds cannot hand uint16 to numpy.
_VIEWS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
          torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8)}
_BY_NAME = {name: (dt, view) for dt, (name, view, _) in _VIEWS.items()}


# ---------------------------------------------------------------------------
# pytree <-> flat dict of arrays
# ---------------------------------------------------------------------------

def flatten(tree, prefix=""):
    """Tree -> {"a/b/0": leaf} with dict keys and tuple/list indices."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def unflatten(flat: dict, template, prefix=""):
    if isinstance(template, dict):
        return {k: unflatten(flat, v, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        vals = [unflatten(flat, v, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals)
    return flat[prefix.rstrip("/")]


# ---------------------------------------------------------------------------
# dtype views (npz cannot hold bf16/f8 natively)
# ---------------------------------------------------------------------------

def encode_arrays(flat: dict) -> dict[str, np.ndarray]:
    """{key: tensor} -> {storage key: npz-safe host array}."""
    out = {}
    for k, v in flat.items():
        t = v.detach().to("cpu").contiguous()
        if t.dtype in _VIEWS:
            name, view, words = _VIEWS[t.dtype]
            out[k + DTYPE_SEP + name] = t.view(view).numpy().view(words)
        else:
            out[k] = t.numpy()
    return out


def decode_arrays(stored: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Inverse of :func:`encode_arrays` (keys lose the dtype suffix):
    CPU tensors of the true storage dtype."""
    out = {}
    for k, a in stored.items():
        a = np.ascontiguousarray(a)
        if DTYPE_SEP in k:
            k, name = k.split(DTYPE_SEP)
            if name not in _BY_NAME:
                raise ValueError(f"checkpoint key {k!r}: stored dtype "
                                 f"{name!r} is not one the port reads "
                                 f"({sorted(_BY_NAME)})")
            dtype, view = _BY_NAME[name]
            words = np.int16 if view == torch.int16 else np.uint8
            out[k] = torch.from_numpy(a.view(words)).view(dtype)
        else:
            out[k] = torch.from_numpy(a)
    return out


# ---------------------------------------------------------------------------
# atomic npz + checksums
# ---------------------------------------------------------------------------

def checksums(stored: dict[str, np.ndarray]) -> dict[str, int]:
    """crc32 of each *stored* array's bytes (post dtype-view)."""
    return {k: zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
            for k, a in stored.items()}


def save_npz_atomic(path: str, stored: dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **stored)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Load the stored (still dtype-viewed) arrays of one checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
