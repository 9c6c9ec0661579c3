"""The training loop: whole optimizer steps of the program's train step.

Set-up builds one train state in the program's own layout (the f32 master
chunks, compressor states and Adam moments of ``core/flatparam`` at data
parallelism of one) from weights drawn on the card, draws a pool of token
batches there, and drives the step (``launch/steps.make_train_step``)
through its first ``setup_steps`` steps: they compile and warm every
shape, and they are the steps the reference follows.  After the first,
each leaf's clipped gradient is read back from Adam's first moment
(``m / (1 - b1)`` less the L2 term); after the last, each leaf's distance
from its start.  The same state then runs the window: whole steps until
``seconds`` have passed, each step's loss read back, as a training loop
that logs its loss does, but some ``AHEAD_S`` seconds of steps after it
was dispatched, so that the card stays fed while the host stands still.
Set-up's objects are frozen out of the interpreter's collector for the
window (``gc.freeze``), and the time from one loss read to the next and
the collections in the window are kept and printed as one line
(``bench/pacing.py``).

``train_tokens_per_s`` is the tokens of every step dispatched in the
window over the time from its start to the end of its last step, read
after the wait for all of them.  With
``trace`` a further ``trace_steps`` steps run under ``torch.profiler``.
Then the program's state is freed and the reference
(``bench/reference/train.py``) runs the first steps from the same
weights and batches; the compared numbers are the worst relative gap of
the losses, and the worst leaf's gap of the first gradient's norm and of
the change's norm, each against the reference's norm of that leaf or the
median leaf's, whichever is larger.
"""
from __future__ import annotations

import collections
import gc
import math
import statistics
import sys
import time

import torch

from bench import flops as FL
from bench import harness, inputs
from bench import pacing as PC
from bench import trace as TR
from bench.reference import model as RM
from bench.reference import train as RT

B1 = 0.9  # Adam's first-moment decay (the program's default)
# seconds of steps dispatched ahead of the one whose loss is read: a host
# that stands still for less than that leaves the card busy
AHEAD_S = 4.0


def run_config(t: dict):
    from repro_torch.core.loco import SyncConfig
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.steps import RunConfig

    sync = SyncConfig(strategy=t["sync"],
                      quant=QuantConfig(bits=t["bits"], mode="block",
                                        error_codec="f8",
                                        error_scale=t["error_scale"]),
                      beta=t["beta"], reset_every=t["reset_every"])
    return RunConfig(sync=sync, optimizer="adam", lr=t["lr"],
                     schedule="cosine", warmup_steps=t["warmup_steps"],
                     total_steps=t["total_steps"],
                     weight_decay=t["weight_decay"],
                     clip_norm=t["clip_norm"], microbatch=t["microbatch"])


def build_state(c, t, run, topo, device, seed):
    """The program's train state from the benchmark's weights."""
    from repro_torch.core import flatparam as FP
    from repro_torch.launch import steps

    cfg = harness.port_arch(c)
    infos = {(g.name, i.name): (g, i)
             for g in steps.model_groups(cfg, 1) for i in g.infos}
    lvs = RM.leaves(c)
    if set(infos) != {(lf.group, lf.name) for lf in lvs}:
        raise SystemExit(f"the program's weights {sorted(infos)} are not "
                         "the reference's")
    chunks, states = {}, {}
    for idx, lf in enumerate(lvs):
        g, info = infos[(lf.group, lf.name)]
        if (info.shape != lf.shape or g.n_layers != lf.layers
                or info.decay != lf.decay
                or info.loco != (lf.numel >= t["loco_min_numel"])):
            raise SystemExit(f"{lf.group}/{lf.name}: the program declares "
                             f"{info} (x{g.n_layers}), the reference {lf}")
        chunk = torch.zeros(lf.rows, info.padlen(1, 1), device=device)
        chunk[:, :lf.numel] = inputs.draw(lf, idx, seed, device)
        s = FP.init_sync_state(info, run.sync, topo, device)
        chunks.setdefault(g.name, {})[info.name] = (
            chunk if g.stacked else chunk[0])
        states.setdefault(g.name, {})[info.name] = (
            torch.stack([s] * g.n_layers) if g.stacked else s)
    opt = steps._make_opt(run).init(chunks)
    return cfg, lvs, steps.TrainState(chunks, states, opt)


def _rows(tree, lf):
    x = tree[lf.group][lf.name]
    return x.reshape(lf.rows, -1)[:, :lf.numel]


def read_grad1(ts, lvs, t, seed, device) -> dict:
    """Each leaf's clipped gradient norm of the first step, from Adam's
    first moment: ``m / (1 - b1) - wd * p0`` (no L2 term on the norms)."""
    out = {}
    for idx, lf in enumerate(lvs):
        g = _rows(ts.opt[0], lf) / (1 - B1)
        if lf.decay:
            g = g - t["weight_decay"] * inputs.draw(lf, idx, seed, device)
        for r in range(lf.rows):
            out[(lf.group, lf.name, r)] = float(g[r].double().norm())
    return out


def read_change(ts, lvs, seed, device) -> dict:
    out = {}
    for idx, lf in enumerate(lvs):
        d = _rows(ts.chunks, lf) - inputs.draw(lf, idx, seed, device)
        for r in range(lf.rows):
            out[(lf.group, lf.name, r)] = float(d[r].double().norm())
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's ``|prog - ref| / max(ref, median ref)``."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers of one run: ``prog`` and ``ref`` hold
    ``losses``, ``grad1`` and ``change``.  A leaf whose reference gradient
    is under a thousandth of the median leaf's moves by round-off alone
    under Adam, and is left out of the change."""
    med = statistics.median(ref["grad1"].values())
    keep = {k for k, v in ref["grad1"].items() if v >= 1e-3 * med}
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["losses"], ref["losses"])),
            "grad1_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep)}


def reference(c, t, seed, device, batches, fp8=False) -> dict:
    RM.no_tf32()
    lvs = RM.leaves(c)
    W = inputs.weights(lvs, seed, device)
    out = RT.train_steps(c, t, lvs, W, list(batches), fp8=fp8)
    del W
    gc.collect()
    return out


def setup(c, t, seed, device, topo, t0, fault=None):
    """The program's state driven through its first steps, with the
    readings of them: ``(step_fn, state, batches, feed, readings,
    step_s)``; ``feed`` is ``batches`` but where a planted fault changed
    the rows, and ``step_s`` the last step's seconds, its loss read."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps

    run = run_config(t)
    cfg, lvs, ts = build_state(c, t, run, topo, device, seed)
    harness.stage(t0, "train state built")
    B, S = t["global_batch"], t["seq_len"]
    n_pool = t["setup_steps"] + t["trace_steps"] + math.ceil(
        t["pool_per_second"] * t["max_seconds"])
    batches = inputs.tokens(c["vocab"], t["n_clusters"], (n_pool, B, S + 1),
                            seed, device)
    feed = batches
    if fault == "half_batch":
        # half of the rows left out, the mean taken over the rest
        feed = batches.clone()
        feed[:, B // 2:] = feed[:, :B // 2]
    step_fn = steps.make_train_step(cfg, run, topo, device,
                                    ShapeConfig("bench", S, B, "train"))
    if fault == "frozen":
        real = step_fn

        def step_fn(ts, step, batch):  # noqa: F811  (the state unchanged)
            chunks, opt = ts.chunks, ts.opt
            m = real(ts, step, batch)
            ts.chunks, ts.opt = chunks, opt
            return m

    prog = {"losses": []}
    for s in range(t["setup_steps"]):
        t_s = time.perf_counter()
        prog["losses"].append(float(step_fn(ts, s, {"tokens": feed[s]})
                                    ["loss"]))
        step_s = time.perf_counter() - t_s
        harness.stage(t0, f"setup step {s}")
        if s == 0:
            prog["grad1"] = read_grad1(ts, lvs, t, seed, device)
    prog["change"] = read_change(ts, lvs, seed, device)
    return step_fn, ts, batches, feed, prog, step_s


def ahead_steps(step_s: float) -> int:
    """Steps dispatched ahead of the one whose loss is read: ``AHEAD_S``
    seconds of steps of ``step_s`` seconds, rounded up, and at least one."""
    return max(1, math.ceil(AHEAD_S / step_s)) if step_s > 0 else 1


def window(step_fn, ts, feed, step, seconds, ahead=1):
    """Whole steps from ``step`` until ``seconds`` have passed, each
    step's loss read back once ``ahead`` more steps have been dispatched.
    When the time is up nothing more is sent, the losses in flight are
    read, and the window ends after the last: every step sent counts,
    over all that time.  Returns ``(times, start, collections, failed)``;
    ``times`` runs from one loss read to the next, back to back from the
    start, one a step, so it sums to the window."""
    times, failed, pending = [], 0, collections.deque()
    with PC.Collections() as gcs:
        t_start = t_end = time.perf_counter()
        while True:
            if time.perf_counter() - t_start < seconds:
                pending.append(step_fn(ts, step, {"tokens": feed[
                    step % len(feed)]})["loss"])
                step += 1
                if len(pending) <= ahead:
                    continue
            elif not pending:
                break
            loss = float(pending.popleft())
            failed += not math.isfinite(loss)
            now = time.perf_counter()
            times.append(now - t_end)
            t_end = now
    return times, t_start, gcs.events, failed


def traced(step_fn, ts, feed, step, n, device):
    """``n`` steps under ``torch.profiler``: ``(summary, seconds)``."""
    prof = TR.profiler(device)
    TR.sync(device)
    with prof:
        t_tr = time.perf_counter()
        for s in range(step, step + n):
            step_fn(ts, s, {"tokens": feed[s % len(feed)]})
        TR.sync(device)
        trace_s = time.perf_counter() - t_tr
    return TR.summary(prof), trace_s


def run(c, seed, seconds, trace, device, t0, fault=None) -> dict:
    from repro_torch.launch import mesh

    cfg_c, t = c["config"], c["traffic"]
    t = dict(t, max_seconds=max(seconds, 1))
    cuda = device.type == "cuda"
    with mesh.dp_group(device):
        from repro_torch.core.flatparam import MeshTopo

        data, model = mesh.mesh_groups(1)
        topo = MeshTopo.from_group(data, model=model,
                                   axes=mesh.mesh_axes(data, 1, 0, 0))
        harness.stage(t0, "process group up")
        step_fn, ts, batches, feed, prog, step_s = setup(
            cfg_c, t, seed, device, topo, t0, fault)
        ahead = ahead_steps(step_s)
        # set-up's objects out of the collector's reach, as a training
        # loop with manual collection does: a full collection in the
        # window then scans the objects made since, not the whole heap
        # (0.15-0.23 s a collection on danube without)
        gc.collect()
        gc.freeze()
        try:
            TR.sync(device)
            setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            times, t_start, events, failed = window(
                step_fn, ts, feed, t["setup_steps"], seconds, ahead)
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            summ, trace_s = (traced(step_fn, ts, feed,
                                    t["setup_steps"] + len(times),
                                    t["trace_steps"], device)
                             if trace else (None, 0.0))
        finally:
            gc.unfreeze()
        mem_peak = max(setup_peak, peak,
                       torch.cuda.max_memory_allocated(device) if cuda else 0)
        del step_fn, ts
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    setup_s = t_start - t0
    n, window_s = len(times), sum(times)
    harness.stage(t0, f"window {n} steps in {window_s:.3f} s")
    steps_s = dict(PC.summary(times, t_start, events), ahead=ahead)
    print(PC.line(steps_s, times), file=sys.stderr, flush=True)
    ref = reference(cfg_c, t, seed, device, batches[:t["setup_steps"]])
    harness.stage(t0, "reference done")
    tokens = t["global_batch"] * t["seq_len"]
    ctx = {"kind": "train", "config": cfg_c, "traffic": t,
           "flops_per_step": FL.train_step_flops(cfg_c, t["seq_len"],
                                                 t["global_batch"]),
           "window_steps": n, "window_s": window_s,
           "accum": t["global_batch"] // t["microbatch"],
           "trace": summ, "trace_units": t["trace_steps"],
           "trace_window_s": trace_s, "steps": steps_s,
           "peaks": harness.load_json(harness.BENCH, "peaks.json")}
    return {"e2e": {"train_tokens_per_s": n * tokens / window_s if n else 0.0,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
            "ctx": ctx, "checks": compare(prog, ref),
            "attempted": t["setup_steps"] + n + (t["trace_steps"] if trace
                                                 else 0),
            "failed": failed + sum(not math.isfinite(x)
                                   for x in prog["losses"]),
            "memory_peak_bytes": mem_peak,
            "device_kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu")}
