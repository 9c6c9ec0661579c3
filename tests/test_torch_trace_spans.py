"""The port's phase spans and allocator counter (``telemetry/profiler``).

On the CPU, under ``torch.profiler``: one train step of a reduced
llama2-400m at two microbatches opens ``loco/forward`` and
``loco/backward`` once per microbatch, ``loco/clip`` and ``loco/apply``
once, and ``loco/gather`` once per gathered leaf per forward and again per
leaf that remat recomputes; the traced step gives the untraced one's bits.
A prefill and three decode steps open ``loco/serve/prefill`` once and
``loco/serve/decode`` three times.  Without a profiler ``phase`` is the
one shared no-op; inside one, ranges opened in an autograd backward
appear.  The counter adds each key's change.

On a card (skipped without one; this file imports no JAX, so
``python -m pytest -q --noconftest tests/test_torch_trace_spans.py`` runs
it on a GPU machine): the backward's range spans device work and opens and
closes on one thread, and a planted ``empty_cache`` before a traced step
raises the allocator counter.
"""
import collections

import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import flatparam as FP
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.telemetry import profiler as PROF

CPU = torch.device("cpu")
CFG = reduced(get_arch("llama2-400m"))
SEQ, BATCH, MICRO = 32, 4, 2
TRAIN = ("loco/forward", "loco/backward", "loco/clip", "loco/apply",
         "loco/gather")


def _run():
    return tsteps.RunConfig(sync=SyncConfig(strategy="loco"), lr=1e-3,
                            warmup_steps=1, microbatch=MICRO)


def _batch(device):
    gen = torch.Generator().manual_seed(3)
    return {"tokens": torch.randint(0, CFG.vocab, (BATCH, SEQ + 1),
                                    generator=gen).to(device)}


def _profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _host_ranges(prof):
    """``{name: [(start thread, end thread)]}`` of the host ``loco/*``
    ranges."""
    from torch.autograd import DeviceType

    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA and e.name().startswith(
                "loco/"):
            out[e.name()].append((e.start_thread_id(), e.end_thread_id()))
    return out


def _train(device, traced: bool):
    """One fresh step (the step before it warm-up, untraced): its loss,
    the new chunks and, when ``traced``, the profiler."""
    with tmesh.dp_group(device):
        topo = MeshTopo.from_group(*tmesh.mesh_groups(1))
        ts = tsteps.make_init(CFG, _run(), topo, device)
        step_fn = tsteps.make_train_step(CFG, _run(), topo, device,
                                         ShapeConfig("t", SEQ, BATCH,
                                                     "train"))
        step_fn(ts, 0, _batch(device))
        prof = _profile(device) if traced else None
        if traced:
            with prof:
                m = step_fn(ts, 1, _batch(device))
        else:
            m = step_fn(ts, 1, _batch(device))
        return float(m["loss"]), ts.chunks, prof


def _gathers_per_microbatch():
    """Leaves gathered by one forward, and again by remat's recomputation
    of the stacked layers."""
    fwd = remat = 0
    for g in tsteps.model_groups(CFG, 1):
        n = len(g.infos) * (g.n_layers if g.stacked else 1)
        fwd += n
        remat += n if g.stacked else 0
    return fwd, remat


def test_train_step_spans_and_bits():
    loss, chunks, prof = _train(CPU, traced=True)
    count = {k: len(v) for k, v in _host_ranges(prof).items()}
    fwd, remat = _gathers_per_microbatch()
    accum = BATCH // MICRO
    assert (count["loco/forward"], count["loco/backward"]) == (accum, accum)
    assert (count["loco/clip"], count["loco/apply"]) == (1, 1)
    assert count["loco/gather"] == accum * (fwd + remat) and remat > 0
    assert count["loco/encode"] == count["loco/exchange"] > 0
    # each layer's attention: its forward, remat's and its backward
    assert count["loco/attention"] == accum * CFG.n_layers * 3
    # no new span is named under the sync's phases or as the update
    assert set(count) <= {*TRAIN, "loco/encode", "loco/exchange",
                          "loco/decode", "loco/attention"}
    # the spans change nothing
    loss0, chunks0, _ = _train(CPU, traced=False)
    assert loss == loss0
    for gn, og in chunks.items():
        for n, c in og.items():
            assert torch.equal(c, chunks0[gn][n]), (gn, n)


def test_serve_spans():
    cfg = reduced(get_arch("h2o-danube-1.8b"))
    with tmesh.dp_group(CPU):
        topo = MeshTopo.from_group(*tmesh.mesh_groups(1))
        params = FP.init_serve_params(tsteps.model_groups(cfg, 1), 1, 0, CPU,
                                      seed=1)
        prefill = tsteps.make_prefill_step(
            cfg, topo, CPU, batch=2, window=tsteps.serve_window(cfg, 16, 3))
        decode = tsteps.make_decode_step(cfg, topo, CPU)
        with _profile(CPU) as prof:
            logits, state = prefill(
                params, {"tokens": torch.ones(2, 16, dtype=torch.int64)})
            tok = tsteps.greedy(logits, topo)
            for _ in range(3):
                tok, logits, state = decode(params, state, tok)
    count = {k: len(v) for k, v in _host_ranges(prof).items()}
    assert count == {"loco/serve/prefill": 1, "loco/serve/decode": 3}


class _Square(torch.autograd.Function):
    """x^2 whose backward opens a phase."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with PROF.phase("exchange"):
            return 2 * x * g


def test_phase_is_shared_noop_without_profiler():
    assert not torch.autograd._profiler_enabled()
    assert PROF.phase("forward") is PROF.NOOP
    assert PROF.phase("encode", group=1) is PROF.NOOP
    with PROF.phase("clip") as inner:
        assert inner is None
    with _profile(CPU):
        assert PROF.phase("forward") is not PROF.NOOP


def test_ranges_inside_backward_appear():
    x = torch.ones(4, requires_grad=True)
    seen = []
    with _profile(CPU) as prof:
        PROF.backward(_Square.apply(x).sum(), lambda: seen.append(1))
    ranges = _host_ranges(prof)
    assert len(ranges["loco/exchange"]) == 1
    assert len(ranges["loco/backward"]) == 1 and seen == [1]
    assert torch.equal(x.grad, torch.full((4,), 2.0))
    # untraced: the same gradient, ``then`` once, nothing hooked
    x.grad = None
    PROF.backward(_Square.apply(x).sum(), lambda: seen.append(2))
    assert seen == [1, 2] and torch.equal(x.grad, torch.full((4,), 2.0))


def test_count_alloc_adds_each_key(monkeypatch):
    monkeypatch.setattr(PROF, "COUNTERS", {})
    stats = {"num_alloc_retries": 1, "num_device_alloc": 7,
             "num_device_free": 5, "allocation.all.current": 9}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device: stats)
    PROF.count_alloc(None, CPU)
    assert PROF.COUNTERS == {}
    PROF.count_alloc({"num_alloc_retries": 1, "num_device_alloc": 4,
                      "num_device_free": 5}, CPU)
    PROF.count_alloc({"num_alloc_retries": 0, "num_device_alloc": 6,
                      "num_device_free": 5}, CPU)
    assert PROF.COUNTERS == {"num_alloc_retries": 1, "num_device_alloc": 4,
                             "num_device_free": 0}
    # nothing is read on the CPU or without a profiler
    assert PROF.alloc_counts(CPU) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device-side spans and the caching "
                    "allocator exist only there")
    return torch.device("cuda", 0)


def test_card_backward_span_on_engine_thread(cuda_device):
    _, _, prof = _train(cuda_device, traced=True)
    host = _host_ranges(prof)
    assert all(a == b for a, b in host["loco/backward"])
    spans = PROF.window_summary(prof)["ranges"]
    assert all(spans.get(k, 0.0) > 0 for k in TRAIN), spans
    assert "loco/encode" in spans


def test_card_empty_cache_raises_alloc_counter(cuda_device, monkeypatch):
    monkeypatch.setattr(PROF, "COUNTERS", {})
    with tmesh.dp_group(cuda_device):
        topo = MeshTopo.from_group(*tmesh.mesh_groups(1))
        ts = tsteps.make_init(CFG, _run(), topo, cuda_device)
        step_fn = tsteps.make_train_step(CFG, _run(), topo, cuda_device,
                                         ShapeConfig("t", SEQ, BATCH,
                                                     "train"))
        for s in range(2):
            step_fn(ts, s, _batch(cuda_device))
        assert PROF.COUNTERS == {}
        with _profile(cuda_device):
            step_fn(ts, 2, _batch(cuda_device))
        warm = sum(PROF.COUNTERS.values())
        assert set(PROF.COUNTERS) == set(PROF.ALLOC_KEYS) and warm >= 0
        torch.cuda.synchronize(cuda_device)
        torch.cuda.empty_cache()
        with _profile(cuda_device):
            step_fn(ts, 3, _batch(cuda_device))
        assert sum(PROF.COUNTERS.values()) > warm, PROF.COUNTERS
