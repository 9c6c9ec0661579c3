"""Phase-level trace annotation for the sync path.

Port of ``repro.telemetry.profiler.phase``: the sync phases (``encode`` ->
``exchange`` -> ``decode`` in core/comm, ``apply`` in launch/steps) run
inside ``torch.profiler.record_function`` ranges named ``loco/<phase>``, the
names the reference gives its XLA scopes, so a ``torch.profiler`` trace
shows the comm structure by name.  The overlapped schedule tags each range
with its stage (``loco/encode/g1`` inside the window of
``loco/exchange/g0``'s collectives is the overlap itself).  Outside a
profiler the ranges cost one cheap Python context manager each.
"""
from __future__ import annotations

import torch


def phase(name: str, group: int | None = None):
    """Profiler range for one sync phase (nestable); ``group`` is the
    overlap-schedule stage index, named ``loco/<phase>/g<group>``."""
    if group is None:
        return torch.profiler.record_function(f"loco/{name}")
    return torch.profiler.record_function(f"loco/{name}/g{group}")
