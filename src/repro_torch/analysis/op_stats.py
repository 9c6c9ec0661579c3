"""What one step dispatches, counted per device: the port's counterpart of
``repro.analysis.hlo_stats``.

The reference reads the compiled XLA module's HLO text, walking ``while``
bodies times their trip counts.  The port runs eagerly: there is no module
to read, but every op the step runs passes the dispatcher, in program
order, with its shapes, dtypes and process group.  So :class:`OpStats`, a
``TorchDispatchMode``, counts what the dispatcher sees.  Under
``FakeTensorMode`` (``launch/dryrun``) that is the real step's op stream at
any shape and world size, with nothing allocated and nothing computed.
Eager mode runs every layer and microbatch, so there are no trip counts to
recover.  Per step it records:

* ``flops``: dots only, as the reference counts: the FLOP formulas of
  ``torch.utils.flop_counter`` (mm, addmm, bmm, baddbmm, scaled-dot-product
  attention, convolutions and their backwards).
* ``bytes``: the HBM estimate.  Every op that launches work is charged its
  tensor inputs plus its tensor outputs, because eager mode fuses nothing:
  each op reads its operands from HBM and writes its results there.  This
  differs from the reference's rule for standalone elementwise ops, which
  charges their result only (``hlo_stats.py:27-34``): a TPU lowering fuses
  those into their neighbours, eager PyTorch does not.  View and alias ops,
  allocations and metadata queries launch nothing and are charged nothing.
* collectives: each ``c10d`` op by kind (the reference's HLO names) with
  its group's size, launches per kind (``collective_launches``'s
  counterpart) and wire bytes per device by the reference's formula per
  kind (:func:`collective_wire`).
* kernels: each call of one of the repo's CUDA kernel wrappers as one op,
  by name, charged the bytes its kernel must move (``compress_bytes`` and
  its siblings in ``repro_torch.kernels``).  The wrapper reports itself
  through ``kernels.wrap.OBSERVER``; the ops of its plain version, which a
  CPU tensor runs, are not counted a second time.
* ``overlap``: :class:`OverlapStats`, with the reference's keys.  Every
  op's roofline time, ``max(flops / PEAK, bytes / HBM_BW)``, dispatched
  between an asynchronous collective's issue and its ``wait()`` (reported
  by ``core.comm.OBSERVER``) counts as hidden, capped at that collective's
  wire time (wire bytes / ``LINK_BW``).  A collective issued without
  ``async_op`` exposes all of its time.
* ``memory``: the live bytes of the storages on the step's device and their
  peak, each storage rounded up to the CUDA caching allocator's 512 bytes
  on a CUDA device.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline as RL
from repro_torch.core import comm as COMM
from repro_torch.kernels import wrap as WRAP

aten = torch.ops.aten
_PRIM_DEVICE = torch.ops.prim.device.default

# c10d op -> the reference's HLO kind (any other op counts under its own
# name, its output as its wire)
KINDS = {
    "alltoall_base_": "all-to-all", "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
}
_NO_WORK_C10D = {"barrier", "monitored_barrier"}
# ops that launch nothing besides the views: aliases, allocations without
# a fill, metadata
_FREE = {aten.detach, aten.alias, aten._unsafe_view, aten.lift_fresh,
         aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._reshape_alias, aten.set_,
         aten.resize_, aten.record_stream, aten.is_same_size}
ALLOC_ROUND = 512  # the CUDA caching allocator's granule
# torch.distributed's collectives the port calls (comm binds two of them)
_DIST_CALLS = ("all_reduce", "all_to_all_single", "all_gather_single",
               "all_gather_into_tensor", "reduce_scatter_single",
               "reduce_scatter_tensor", "all_gather", "broadcast")
_COMM_CALLS = ("_ALL_GATHER", "_REDUCE_SCATTER")


def collective_wire(kind: str, out_bytes: float, n: int) -> float:
    """Bytes one device sends over its links for one collective of
    ``kind`` over ``n`` ranks whose output (per rank) is ``out_bytes``:
    the reference's ``hlo_stats._collective_wire``."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "all-to-all":
        return out_bytes * frac
    return out_bytes  # collective-permute


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _free(func) -> bool:
    return (func.namespace == "prim" or func.is_view
            or func.overloadpacket in _FREE)


def group_size(func, args) -> int:
    """The size of a ``c10d`` op's process group."""
    names = [a.name for a in func._schema.arguments]
    pg = args[names.index("process_group")]
    return torch._C._distributed_c10d.ProcessGroup.unbox(pg).size()


@dataclasses.dataclass
class OverlapStats:
    """Compute/collective overlap of one step (the reference's keys)."""

    collective_s: float = 0.0   # total wire time of all collectives
    hidden_s: float = 0.0       # part hidden under compute in its window
    compute_s: float = 0.0      # total roofline time of the other ops
    n_async: float = 0.0        # collectives issued with async_op
    n_sync: float = 0.0         # collectives issued synchronously

    @property
    def exposed_s(self) -> float:
        return max(0.0, self.collective_s - self.hidden_s)

    @property
    def overlap_fraction(self) -> float:
        return self.hidden_s / self.collective_s if self.collective_s else 0.0

    def to_json(self) -> dict:
        return {"collective_s": self.collective_s, "hidden_s": self.hidden_s,
                "exposed_s": self.exposed_s, "compute_s": self.compute_s,
                "overlap_fraction": self.overlap_fraction,
                "n_async": self.n_async, "n_sync": self.n_sync}


class Memory:
    """Live bytes of the storages on one device type that the recorded ops
    create, and their peak.  A storage counts from its first op output to
    its release (a finalizer on its Python object, which torch keeps while
    the storage lives)."""

    def __init__(self, device: torch.device):
        self.type = device.type
        self.round = ALLOC_ROUND if device.type == "cuda" else 1
        self.live = 0
        self.peak = 0
        self.epoch = 0
        self._seen: dict[int, tuple[int, int]] = {}  # id -> (bytes, epoch)

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != self.type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        r = self.round
        n = -(-st.nbytes() // r) * r
        self._seen[key] = (n, self.epoch)
        weakref.finalize(st, self._release, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _release(self, key: int) -> None:
        n, _ = self._seen.pop(key)
        self.live -= n

    def mark(self) -> int:
        """Reset the peak to the live bytes and start a new epoch; returns
        the live bytes."""
        self.epoch += 1
        self.peak = self.live
        return self.live

    def since_mark(self) -> int:
        """Live bytes of the storages created since the last mark."""
        return sum(n for n, e in self._seen.values() if e == self.epoch)


class OpStats(TorchDispatchMode):
    """Counts what a step dispatches (see the module docstring).

    ``with OpStats(device) as st: ...``; :meth:`reset` zeroes the counts
    (not the memory), :meth:`record` reads them.  ``trace=True`` keeps
    ``(op, flops, bytes)`` per counted op in ``st.trace``."""

    def __init__(self, device="cpu", *, trace: bool = False,
                 peak_flops: float = RL.PEAK_FLOPS,
                 hbm_bw: float = RL.HBM_BW, link_bw: float = RL.LINK_BW):
        super().__init__()
        self.device = torch.device(device)
        self.peak_flops, self.hbm_bw, self.link_bw = peak_flops, hbm_bw, \
            link_bw
        self.keep_trace = trace
        self.memory = Memory(self.device)
        self._inside = 0
        self._in_collective = 0
        self._saved = None
        self._patched: list = []
        self.reset()

    def reset(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.coll_counts: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        self.wire_bytes = 0.0
        self.kernels: collections.Counter = collections.Counter()
        self.ovl = OverlapStats()
        self._windows: dict[int, list[float]] = {}
        self._last_wire_s = 0.0
        self.trace: list[tuple[str, float, float]] = []

    # -- the observers' side ------------------------------------------------

    def __enter__(self):
        self._saved = (WRAP.OBSERVER, COMM.OBSERVER)
        WRAP.OBSERVER = COMM.OBSERVER = self
        # what a backend dispatches inside a collective (gloo copies its
        # result into the output as it waits) belongs to the collective:
        # while recording, the collective calls are marked
        self._patched = [(dist, n, getattr(dist, n)) for n in _DIST_CALLS
                         if hasattr(dist, n)]
        self._patched += [(COMM, n, getattr(COMM, n)) for n in _COMM_CALLS]
        for mod, name, fn in self._patched:
            setattr(mod, name, self._marked(fn))
        return super().__enter__()

    def __exit__(self, *exc):
        WRAP.OBSERVER, COMM.OBSERVER = self._saved
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)
        return super().__exit__(*exc)

    def _marked(self, fn):
        def call(*args, **kwargs):
            self._in_collective += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._in_collective -= 1
        return call

    @contextlib.contextmanager
    def kernel(self, name: str, nbytes: float, flops: float = 0.0):
        """One call of the kernel ``name``, moving ``nbytes`` and doing
        ``flops``: counted as one op; the ops dispatched inside (a plain
        version's) are not."""
        self.kernels[name] += 1
        self._account(f"kernel:{name}", float(flops), float(nbytes))
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def issued(self, work) -> None:
        """The collective just dispatched was issued with ``async_op``
        and returned ``work``: its window opens."""
        self.ovl.n_sync -= 1
        self.ovl.n_async += 1
        self._windows[id(work)] = [self._last_wire_s, 0.0]

    def wait(self, work) -> None:
        """``work.wait()`` for ``core.comm``: what the backend dispatches
        while it waits belongs to the collective; its window closes."""
        self._marked(work.wait)()
        w = self._windows.pop(id(work), None)
        if w is not None:
            self.ovl.hidden_s += min(w[0], w[1])

    # -- the dispatcher's side ----------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _PRIM_DEVICE and type(args[0]) is FakeTensor:
            # a fake tensor's device, without FakeTensorMode's dispatch
            return args[0].fake_device
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self.memory.track(t)
        if func.namespace == "c10d":
            if not self._inside:
                self._collective(func, args, kwargs, out)
            return out
        if self._inside or self._in_collective or _free(func):
            return out
        fl = 0.0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            fl = float(formula(*args, **kwargs, out_val=out))
        self._account(str(func.overloadpacket).removeprefix("aten."), fl,
                      float(_nbytes(args) + _nbytes(kwargs) + _nbytes(out)))
        return out

    def _account(self, name: str, fl: float, nbytes: float) -> None:
        self.flops += fl
        self.bytes += nbytes
        self.n_ops += 1
        t = max(fl / self.peak_flops, nbytes / self.hbm_bw)
        self.ovl.compute_s += t
        for w in self._windows.values():
            w[1] += t
        if self.keep_trace:
            self.trace.append((name, fl, nbytes))

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._opname
        if name in _NO_WORK_C10D:
            return
        kind = KINDS.get(name, name)
        n = group_size(func, args)
        wire = collective_wire(kind, float(_nbytes(args[0])), n)
        nbytes = float(_nbytes(args) + _nbytes(kwargs) + _nbytes(out))
        self.coll_counts[kind] += 1
        self.coll_bytes[kind] += wire
        self.wire_bytes += wire
        self.bytes += nbytes
        self.n_ops += 1
        self._last_wire_s = wire / self.link_bw
        self.ovl.collective_s += self._last_wire_s
        self.ovl.n_sync += 1
        if self.keep_trace:
            self.trace.append((f"{kind}/{n}", wire, nbytes))

    # -- reading --------------------------------------------------------------

    def overlap(self) -> OverlapStats:
        """The overlap so far, windows still open credited with what they
        have accrued (the reference's rule for a done it cannot see)."""
        res = dataclasses.replace(self.ovl)
        for wire, acc in self._windows.values():
            res.hidden_s += min(wire, acc)
        return res

    def collectives(self) -> dict:
        """The dry run's ``collectives`` record (the reference's keys)."""
        return dict(counts=dict(self.coll_counts),
                    bytes_by_kind={k: round(v)
                                   for k, v in self.coll_bytes.items()},
                    wire_bytes=round(self.wire_bytes))

    def record(self) -> dict:
        return dict(flops=self.flops, bytes=self.bytes, n_ops=self.n_ops,
                    collectives=self.collectives(),
                    kernels=dict(self.kernels),
                    overlap=self.overlap().to_json())
