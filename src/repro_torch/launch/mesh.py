"""The data-parallel and tensor-parallel process groups.

Port of ``repro.launch.mesh``: the reference's ``(data, model)`` mesh
becomes two ``torch.distributed`` groups per rank over a world of
``dp * tp`` ranks, global rank ``data * TP + model`` (the reference's mesh
order).  The ``data`` group of a rank holds the ranks with its model index
(the FSDP chunks, the LoCo and fp gradient sync); the ``model`` group holds
the ranks with its data index (the tensor-, sequence- and expert-parallel
collectives of ``models/``).

The multi-pod mesh ``(wan, pod, data, model)`` keeps that flat data group
(its rank order ``(wan * PODS + pod) * DATA + data`` is the flat dp chunk
order, so the FSDP layout does not change): global rank
``((wan * PODS + pod) * DATA + data) * TP + model``.  :func:`mesh_axes`
cuts it into one group per dp mesh axis for the hierarchical sync.

On a CUDA device the groups run NCCL, on the CPU gloo.  Without an
existing group and without ``torchrun``'s environment, :func:`dp_group`
starts a world-size-1 group through a ``file://`` rendezvous in a fresh
temporary directory, so concurrent processes never compete for a port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """The paper's production mesh: ``shape`` over the axes ``axes``,
    outermost first, ``model`` last."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    @property
    def tp(self) -> int:
        return self.shape[-1]

    @property
    def dp(self) -> int:
        """The flat data group's size (every dp axis)."""
        return self.world // self.tp

    @property
    def pods(self) -> int:
        """The pod axis's size, 0 without one (``mesh_axes``'s ``pods``)."""
        return dict(zip(self.axes, self.shape)).get("pod", 0)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh: 16 x 16 ``(data, model)``, or
    2 x 16 x 16 ``(pod, data, model)``.  Its groups are
    :func:`mesh_groups` with ``tp`` and :func:`mesh_axes` with ``pods``
    over a world of ``world`` ranks, in their rank order."""
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


def backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


@contextlib.contextmanager
def dp_group(device: torch.device):
    """Yield the default (world) group for ``device``.

    Uses the default group when one exists; joins the ``torchrun`` world
    when its environment is set; otherwise starts a world-size-1 group.  A
    group started here is destroyed on exit.  At ``tp = 1`` the world is
    the data-parallel group.
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


def mesh_groups(tp: int = 1):
    """``(data group, model group)`` of this rank in a world of
    ``dp * tp`` ranks, global rank ``data * tp + model``.

    ``torch.distributed.new_group`` is collective over the world, so every
    rank creates every group, in the same order.  At ``tp = 1`` the data
    group is the world itself and the model groups are singletons (the
    MoE exchange runs on one); at ``dp = 1`` the model group is the world.
    """
    world, me = dist.get_world_size(), dist.get_rank()
    if tp < 1 or world % tp:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"tensor-parallel groups of {tp}")
    dp = world // tp
    data = model = dist.group.WORLD
    if tp > 1:
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if me % tp == m:
                data = g
    if dp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if me // tp == d:
                model = g
    return data, model


def mesh_axes(data, tp: int = 1, pods: int = 0, wans: int = 0) -> tuple:
    """This rank's dp mesh axes, outermost first, as ``comm.MeshAxis``es:
    ``(data,)`` over the flat data group ``data`` (:func:`mesh_groups`) on a
    flat mesh, ``(pod, data)`` with ``pods``, ``(wan, pod,
    data)`` with ``wans`` (which implies a pod axis, of size ``pods or
    1``), as the reference's ``make_local_mesh`` lays them out.  The flat
    dp group of ``dp = world / tp`` ranks splits into ``wans x pods x
    DATA``; each axis's group holds the ranks that differ from this one on
    that axis only, in axis order.  Every rank creates every group, in the
    same order (torch requires it)."""
    from repro_torch.core.comm import MeshAxis

    world, me = dist.get_world_size(), dist.get_rank()
    if tp < 1 or world % tp:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"tensor-parallel groups of {tp}")
    dp = world // tp
    if not pods and not wans:
        return (MeshAxis("data", data),)
    shape = {"wan": wans, "pod": pods or 1} if wans else {"pod": pods}
    outer = 1
    for v in shape.values():
        outer *= v
    if dp % outer:
        raise ValueError(f"dp = {dp} ranks do not split into "
                         + " x ".join(f"{v} {k}s" for k, v in shape.items()))
    shape["data"] = dp // outer
    names = list(shape)
    sizes = [shape[k] for k in names]
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    f, m = divmod(me, tp)                     # flat dp rank, model index
    coord = [f // strides[i] % sizes[i] for i in range(len(sizes))]
    axes = []
    for i, name in enumerate(names):
        mine = None
        # every line of the flat dp order along axis i, over every model
        # index, in one fixed order
        base_coords = [c for c in range(dp) if c // strides[i] % sizes[i] == 0]
        for m2 in range(tp):
            for b in base_coords:
                ranks = [(b + j * strides[i]) * tp + m2
                         for j in range(sizes[i])]
                grp = dist.new_group(ranks)
                if m2 == m and b == f - coord[i] * strides[i]:
                    mine = grp
        axes.append(MeshAxis(name, mine))
    return tuple(axes)


def model_group(tp: int = 1):
    """This rank's ``model`` process group (:func:`mesh_groups`)."""
    return mesh_groups(tp)[1]


def init_file_group(device: torch.device, rank: int, world_size: int,
                    rendezvous: str) -> None:
    """Join a ``world_size`` group through the file ``rendezvous`` (a path
    every rank shares); how the CPU tests start multi-rank groups."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device),
                            init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world_size)


def _rank_main(rank: int, fn, world: int, rendezvous: str, args) -> None:
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_file_group(torch.device("cpu"), rank, world, rendezvous)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args) -> None:
    """Run ``fn(rank, *args)`` on ``world`` spawned CPU processes joined
    into one gloo group (a ``file://`` rendezvous in a fresh temporary
    directory); the CPU form of a ``torchrun`` launch.  ``fn`` must be
    importable from the spawned process (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, world, os.path.join(tmp, "rdv"), args),
                           nprocs=world, start_method="spawn")
