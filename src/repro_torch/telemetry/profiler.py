"""Phase-level trace annotation for the sync path.

Port of ``repro.telemetry.profiler.phase``: the sync phases (``encode`` ->
``exchange`` -> ``decode`` in core/comm, ``apply`` in launch/steps) run
inside ``torch.profiler.record_function`` ranges named ``loco/<phase>``, the
names the reference gives its XLA scopes, so a ``torch.profiler`` trace
shows the comm structure by name.  Outside a profiler the ranges cost one
cheap Python context manager each.
"""
from __future__ import annotations

import torch


def phase(name: str):
    """Profiler range for one sync phase (nestable)."""
    return torch.profiler.record_function(f"loco/{name}")
