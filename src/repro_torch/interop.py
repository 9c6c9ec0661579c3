"""Carry a train state from the JAX reference into the port.

``from_reference`` takes what ``repro.launch.steps.make_init`` returns, as
numpy arrays (``np.asarray`` of each leaf), and builds one rank's
:class:`~repro_torch.launch.steps.TrainState`.  The reference stores
global arrays over its ``(data, model)`` mesh; the rank at data index
``r`` of ``dp`` and model index ``m`` of ``tp`` owns

* master chunk ``[..., m, r*C:(r+1)*C]`` of the ``(L?, TP, padlen)`` chunk
  (``C = padlen / dp``, ``padlen`` that of the TP-local slice), and
  likewise each Adam moment;
* compressor state ``[..., m, r, :]`` of the ``(L?, TP, D, padlen)`` state
  (under a sync plan, of each state unit's ``(L?, TP, D, n)`` array);
* the MoE combine residuals of ``block8+ef`` (``states["_moe_a2a"]["ef"]``)
  ``[:, r:r+1, m:m+1, :]`` of the ``(L, D, TP, n)`` array.

float8_e4m3fn and bfloat16 arrays (numpy's ``ml_dtypes`` types) cross as
raw bytes and are viewed as the torch dtype, so the values are exact.  Both
packages then start from the same numbers, which is how the tests compare
them (jax and torch random streams differ).  No JAX import is needed here.

``serve_from_reference`` does the same for the serving weights of
``repro.core.flatparam.init_serve_params_local``: ``(L, TP, *local)`` and
``(TP, *local)`` bf16 arrays, of which model rank ``tp_rank`` keeps its
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.steps import TrainState

# numpy dtype name -> (same-width integer view, torch dtype)
_BYTE_VIEWS = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
               "bfloat16": (np.int16, torch.bfloat16)}


def to_torch(a, device: torch.device | str = "cpu") -> torch.Tensor:
    """numpy array (incl. ml_dtypes float8/bfloat16) -> torch tensor copy."""
    a = np.ascontiguousarray(a)
    view = _BYTE_VIEWS.get(a.dtype.name)
    if view is None:
        return torch.tensor(a, device=device)
    return torch.tensor(a.view(view[0]), device=device).view(view[1])


def _rank_chunk(a, rank: int, dp: int, tp_rank: int):
    a = np.asarray(a)
    c = a.shape[-1] // dp
    return a[..., tp_rank, rank * c:(rank + 1) * c]


def from_reference(chunks, states, opt, *, groups, rank: int, dp: int,
                   tp_rank: int = 0,
                   device: torch.device | str = "cpu") -> TrainState:
    """The train state of the rank at data index ``rank`` and model index
    ``tp_rank`` from the reference's global arrays ``chunks``/``states``
    (``{group: {name: array}}``) and ``opt`` (a tuple of chunk-shaped
    trees); ``groups`` are the TP-local declarations (``build_groups(cfg,
    tp)``)."""
    def chunk_tree(tree):
        return {g.name: {i.name: to_torch(_rank_chunk(tree[g.name][i.name],
                                                      rank, dp, tp_rank),
                                          device)
                         for i in g.infos} for g in groups}

    def state(a):
        if isinstance(a, (tuple, list)):     # per state unit (sync plans)
            return tuple(state(u) for u in a)
        return to_torch(np.asarray(a)[..., tp_rank, rank, :], device)

    st = {g.name: {i.name: state(states[g.name][i.name]) for i in g.infos}
          for g in groups}
    if "_moe_a2a" in states:
        ef = np.asarray(states["_moe_a2a"]["ef"])
        st["_moe_a2a"] = {"ef": to_torch(
            ef[:, rank:rank + 1, tp_rank:tp_rank + 1, :], device)}
    return TrainState(chunk_tree(chunks), st,
                      tuple(chunk_tree(t) for t in opt))


def serve_from_reference(params, *, groups, tp_rank: int = 0,
                         device: torch.device | str = "cpu") -> dict:
    """Model rank ``tp_rank``'s serving tensors (``flatparam.ServeStore``'s
    ``{group: {name: tensor}}``) from the reference's global serving
    arrays ``params``; ``groups`` are the TP-local declarations."""
    out = {}
    for g in groups:
        og = {}
        for i in g.infos:
            a = np.asarray(params[g.name][i.name])
            tp = a.shape[1] if g.stacked else a.shape[0]
            a = a[:, tp_rank] if g.stacked else a[tp_rank]
            lead = (g.n_layers,) if g.stacked else ()
            og[i.name] = to_torch(a, device).reshape(lead
                                                     + i.local_shape(tp))
        out[g.name] = og
    return out
