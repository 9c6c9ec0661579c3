"""The data-parallel process group.

Port of ``repro.launch.mesh`` for ``tp = 1``: the reference's mesh axes
``(pod, data)`` become one ``torch.distributed`` group over every rank, rank
``r = pod * DATA + data`` (the order ``repro.core.comm`` chunks by), so a
multi-pod layout is a flat group of the same size.  Tensor parallelism is
not ported yet; :func:`model_group` builds the ``model`` axis's group (one
singleton per rank at ``tp = 1``), on which the MoE exchange runs.

On a CUDA device the group runs NCCL, on the CPU gloo.  Without an
existing group and without ``torchrun``'s environment, :func:`dp_group`
starts a world-size-1 group through a ``file://`` rendezvous in a fresh
temporary directory, so concurrent processes never compete for a port.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist


def backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


@contextlib.contextmanager
def dp_group(device: torch.device):
    """Yield the data-parallel group for ``device``.

    Uses the default group when one exists; joins the ``torchrun`` world
    when its environment is set; otherwise starts a world-size-1 group.  A
    group started here is destroyed on exit.
    """
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    backend = backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"file://{os.path.join(tmp, 'rdv')}",
                rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def model_group(cfg):
    """This rank's ``model`` process group, on which the MoE ``ep_a2a``
    exchange runs its all-to-all; None when ``cfg`` has no such exchange
    (dense models, ``tp_dense``).

    At ``tp = 1`` (all the port has, ROADMAP 6b) that is a singleton group
    per rank.  ``torch.distributed.new_group`` is collective over the
    default group, so every rank creates every group, in the same order.
    """
    if cfg.family != "moe" or cfg.moe_impl != "ep_a2a":
        return None
    mine = None
    for r in range(dist.get_world_size()):
        g = dist.new_group([r])
        if r == dist.get_rank():
            mine = g
    return mine


def init_file_group(device: torch.device, rank: int, world_size: int,
                    rendezvous: str) -> None:
    """Join a ``world_size`` group through the file ``rendezvous`` (a path
    every rank shares); how the CPU tests start multi-rank groups."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device),
                            init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world_size)
