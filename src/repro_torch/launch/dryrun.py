"""Dry run at the production meshes (port of ``repro.launch.dryrun``).

Runs the port's real steps once, as rank 0 of a fake world of 256 (16 x
16) or 512 (2 x 16 x 16) ranks, on fake tensors: every (architecture x
input shape) of ``configs.base.SHAPES``, nothing allocated, nothing
computed.  What the step dispatches is counted by
``analysis.op_stats.OpStats`` and written as the reference's record:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-400m \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch qwen3-moe-30b-a3b --shape train_4k --multi-pod \\
      --fidelity-every 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.analysis.report \\
      --dir experiments/dryrun_torch

The fake process group (``torch.testing._internal.distributed.fake_pg``)
answers every collective at once and the groups are the port's own
(``launch.mesh.mesh_groups`` and ``mesh_axes``); ``FakeTensorMode`` gives
every tensor its shape, dtype and device without storage, on the card
(``--device cuda``, the default) or the CPU (``--device cpu``; the plan is
the same).  A train shape runs ``steps.make_init`` and one call of the
real ``make_train_step`` step; a prefill shape ``make_prefill_step`` and a
decode shape one ``make_decode_step`` step, with caches of
``steps.serve_window`` (the prompt and the one decoded token).  The
reference's ``lower_s`` and ``compile_s`` become ``trace_s``, the host time
of the fake step; there is no ``xla_cost_analysis``.  ``--world`` runs a
smaller fake world, ``DPxTP`` or ``PODSxDATAxTP`` (the tests' size).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis import op_stats as OS
from repro_torch.analysis import roofline as RL
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, get_arch
from repro_torch.core import flatparam as FP
from repro_torch.core.flatparam import MeshTopo, count_params
from repro_torch.core.loco import SyncConfig
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as ST
from repro_torch.models.transformer import init_decode_state
from repro_torch.telemetry import wire as WIRE

SKIPS: dict[tuple[str, str], str] = {
    # long_500k needs sub-quadratic attention (DESIGN.md §6)
    ("chameleon-34b", "long_500k"): "full attention; 500k KV cache infeasible",
    ("qwen3-moe-30b-a3b", "long_500k"): "full attention; 500k KV cache infeasible",
    ("minicpm-2b", "long_500k"): "full attention; 500k KV cache infeasible",
    ("gemma2-27b", "long_500k"): "global layers are full attention at 500k",
    ("command-r-35b", "long_500k"): "full attention; 500k KV cache infeasible",
    ("whisper-small", "long_500k"): "enc-dec ASR; 500k-token decode not meaningful",
}


def default_run(cfg: ArchConfig, sync_strategy: str = "loco") -> ST.RunConfig:
    return ST.RunConfig(
        sync=SyncConfig(strategy=sync_strategy, quant=QuantConfig(mode="block")),
        optimizer="adam",
        microbatch=1,
        remat=True,
    )


def parse_world(spec: str) -> MESH.ProductionMesh:
    """``"DPxTP"`` or ``"PODSxDATAxTP"`` -> a mesh of that shape."""
    dims = tuple(int(x) for x in spec.lower().split("x"))
    if len(dims) == 2:
        return MESH.ProductionMesh(dims, ("data", "model"))
    if len(dims) == 3:
        return MESH.ProductionMesh(dims, ("pod", "data", "model"))
    raise ValueError(f"--world wants DPxTP or PODSxDATAxTP, got {spec!r}")


@contextlib.contextmanager
def fake_world(mesh: MESH.ProductionMesh):
    """This process as rank 0 of a fake process group of ``mesh.world``
    ranks; yields its ``MeshTopo`` (the train CLI's groups)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.world)
    try:
        data, model = MESH.mesh_groups(mesh.tp)
        yield MeshTopo.from_group(
            data, model=model, axes=MESH.mesh_axes(data, mesh.tp, mesh.pods))
    finally:
        dist.destroy_process_group()


def n_params_active(cfg: ArchConfig, n_params: int) -> float:
    """The reference's active-parameter estimate: the expert weights
    times ``top_k / n_experts``, the rest whole."""
    if cfg.n_experts and cfg.top_k:
        expert_params = cfg.n_layers * cfg.n_experts * cfg.d_ff * cfg.d_model * (
            3 if cfg.mlp in ("swiglu", "geglu") else 2)
        return n_params - expert_params + expert_params * (
            cfg.top_k / cfg.n_experts)
    return n_params


def model_flops_global(shape: ShapeConfig, n_active: float) -> float:
    """6ND for a train step, 2ND for a prefill, 2N per sequence for a
    decode step (the reference's rules)."""
    if shape.kind == "train":
        return RL.model_flops_per_step(n_active,
                                       shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def _train_batch(cfg: ArchConfig, shape: ShapeConfig,
                 dev: torch.device) -> dict:
    """The global batch the train CLI's batch functions give, on the
    step's device (the step's copy to the device is then none on either
    device, so the plan does not depend on it)."""
    if cfg.enc_dec:
        return {"frames": torch.zeros(shape.global_batch, shape.seq_len,
                                      cfg.d_model, device=dev),
                "tokens": torch.zeros(shape.global_batch, cfg.dec_len + 1,
                                      dtype=torch.int64, device=dev)}
    return {"tokens": torch.zeros(shape.global_batch, shape.seq_len + 1,
                                  dtype=torch.int64, device=dev)}


def _bytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def _measure(st: OS.OpStats, fn, arg_extra: int = 0) -> tuple[dict, dict]:
    """Run ``fn()`` once under ``st`` with its counts zeroed and the memory
    marked: (``st.record()`` with the host time as ``trace_s`` and, when
    ``st`` keeps one, the op trace, the memory record).  The argument
    bytes are the live device bytes (state and inputs) plus ``arg_extra``."""
    live = st.memory.mark()
    st.reset()
    t0 = time.perf_counter()
    fn()
    trace_s = time.perf_counter() - t0
    peak = st.memory.peak
    mem = dict(argument_bytes=live + arg_extra, peak_bytes=peak + arg_extra,
               temp_bytes=peak - live, output_bytes=st.memory.since_mark())
    rec = dict(st.record(), trace_s=trace_s)
    if st.keep_trace:
        rec["trace"] = list(st.trace)
    return rec, mem


def _local_rows(batch: dict, rows: int, total: int) -> int:
    """The argument bytes' correction for a global ``batch`` of ``total``
    rows held on the device, of which this rank carries ``rows``."""
    return _bytes(batch) * rows // total - _bytes(batch)


def _train(cfg, shape, topo, dev, st, run) -> dict:
    batch = _train_batch(cfg, shape, dev)
    rows = _local_rows(batch, shape.global_batch // topo.dp,
                       shape.global_batch)
    state = ST.make_init(cfg, run, topo, dev, 0, shape)
    step = ST.make_train_step(cfg, run, topo, dev, shape, finalize=False)
    main, mem = _measure(st, lambda: step(state, 0, batch), rows)
    out = dict(main=main, memory=mem)
    groups = ST.model_groups(cfg, topo.tp)
    plan = ST.build_sync_plan(run, groups, topo)
    if run.fidelity_every > 0:
        n = run.fidelity_every
        probe, _ = _measure(st, lambda: step(state, n - 1, batch), rows)
        kinds = set(probe["collectives"]["counts"]) \
            | set(main["collectives"]["counts"])
        delta = {k: probe["collectives"]["counts"].get(k, 0)
                 - main["collectives"]["counts"].get(k, 0)
                 for k in sorted(kinds)}
        out["fidelity"] = dict(
            every=n,
            probe_wire_bytes=probe["collectives"]["wire_bytes"],
            extra_wire_bytes=probe["collectives"]["wire_bytes"]
            - main["collectives"]["wire_bytes"],
            probe_launches=probe["collectives"]["counts"],
            extra_launches={k: v for k, v in delta.items() if v})
    del state
    # both sync schedules (flat and backward-overlapped), as the reference
    # records them: the second runs only when the overlap schedule has
    # more than one stage to pipeline
    this = "overlapped" if (run.coalesce and run.overlap) else "legacy"
    other = "legacy" if this == "overlapped" else "overlapped"
    depth = ST.groups_inflight(
        dataclasses.replace(run, coalesce=True, overlap=True), plan, topo)
    if depth > 1:
        alt = dataclasses.replace(run, coalesce=True,
                                  overlap=(this == "legacy"))
        alt_state = ST.make_init(cfg, alt, topo, dev, 0, shape)
        alt_step = ST.make_train_step(cfg, alt, topo, dev, shape,
                                      finalize=False)
        alt_rec, _ = _measure(st, lambda: alt_step(alt_state, 0, batch))
        out["overlap"] = {this: main["overlap"], other: alt_rec["overlap"]}
    else:
        out["overlap"] = {this: main["overlap"], other: main["overlap"]}
    out["moe_a2a"] = WIRE.moe_a2a_report(cfg, shape, topo, run.microbatch)
    out["wire_tiers"] = ([t.record() for t in WIRE.plan_report(
        plan, pods=topo.pods, wans=topo.wans).tiers]
        if plan is not None else None)
    return out


def _serve(cfg, shape, topo, dev, st) -> dict:
    B, S = shape.global_batch, shape.seq_len
    groups = ST.model_groups(cfg, topo.tp)
    params = FP.init_serve_params(groups, topo.tp, topo.tp_rank, dev, 0)
    b_local = len(range(B)[ST.serve_rows(B, topo)])
    if shape.kind == "prefill":
        prefill = ST.make_prefill_step(cfg, topo, dev, batch=B,
                                       window=ST.serve_window(cfg, S, 0))
        batch = ({"frames": torch.zeros(B, S, cfg.d_model, device=dev)}
                 if cfg.enc_dec else
                 {"tokens": torch.zeros(B, S, dtype=torch.int64,
                                        device=dev)})
        main, mem = _measure(st, lambda: prefill(params, batch),
                             _local_rows(batch, b_local, B))
        return dict(main=main, memory=mem, overlap=main["overlap"])
    # a decode step after an S-token context: the caches hold the context
    # and the step's token (serve_window of one decode step)
    window = ST.serve_window(cfg, S, 1)
    if cfg.enc_dec:
        memory = torch.zeros(b_local, S, cfg.d_model, dtype=torch.bfloat16,
                             device=dev)
        state = ST.build_model(cfg, topo.tp, model_group=topo.model) \
            .init_decode_state(memory, b_local, window)
        state.pos = window - 1
    else:
        state = init_decode_state(cfg, topo.tp, b_local, window, dev)
        state.pos = S
    decode = ST.make_decode_step(cfg, topo, dev)
    token = torch.zeros(b_local, 1, dtype=torch.int64, device=dev)
    main, mem = _measure(st, lambda: decode(params, state, token))
    return dict(main=main, memory=mem, overlap=main["overlap"])


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               sync_strategy: str = "loco", out_dir: str | None = None,
               run_overrides: dict | None = None, device: str = "cuda",
               world: MESH.ProductionMesh | None = None,
               cfg: ArchConfig | None = None,
               shape: ShapeConfig | None = None,
               keep_trace: bool = False) -> dict:
    """One (arch, shape) on the production mesh (or ``world``): the
    reference's record, written to ``out_dir`` and printed as one line.
    ``cfg`` and ``shape`` replace ``get_arch(arch)`` and
    ``SHAPES[shape_name]`` (a reduced config or a small shape);
    ``keep_trace`` adds the main step's ``(op, flops, bytes)`` list as
    ``trace`` (not written to ``out_dir``)."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    mesh = world or MESH.make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
                 "sync": sync_strategy}
    if (arch, shape_name) in SKIPS:
        rec.update(status="skipped", reason=SKIPS[(arch, shape_name)])
        return _emit(rec, out_dir)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    run = None
    if shape.kind == "train":
        run = default_run(cfg, sync_strategy)
        if run_overrides:
            run = dataclasses.replace(run, **run_overrides)
    t0 = time.perf_counter()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        with fake_world(mesh) as topo, FakeTensorMode(), \
                OS.OpStats(dev, trace=keep_trace) as st:
            res = (_train(cfg, shape, topo, dev, st, run)
                   if shape.kind == "train"
                   else _serve(cfg, shape, topo, dev, st))
        main = res["main"]
        n_params = count_params(ST.model_groups(cfg, mesh.tp))
        n_active = n_params_active(cfg, n_params)
        model_flops_dev = model_flops_global(shape, n_active) / mesh.world
        flops = main["flops"]
        rec.update(
            status="ok",
            device=dev.type,
            trace_s=round(main["trace_s"], 1),
            total_s=round(time.perf_counter() - t0, 1),
            n_params=n_params,
            n_params_active=n_active,
            memory=res["memory"],
            flops_per_device=flops,
            hbm_bytes_per_device=main["bytes"],
            ops=main["n_ops"],
            kernels=main["kernels"],
            collectives=main["collectives"],
            overlap=res["overlap"],
            wire_tiers=res.get("wire_tiers"),
            moe_a2a=res.get("moe_a2a"),
            fidelity=res.get("fidelity"),
            roofline=RL.roofline_terms(flops, main["bytes"],
                                       main["collectives"]["wire_bytes"]),
            model_flops_per_device=model_flops_dev,
            useful_flops_ratio=(model_flops_dev / flops) if flops else None,
        )
        if keep_trace:
            trace = main["trace"]
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-3000:])
    rec = _emit(rec, out_dir)
    return dict(rec, trace=trace) if keep_trace and rec["status"] == "ok" \
        else rec


def _emit(rec: dict, out_dir: str | None) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['sync']}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        ov = rec.get("overlap", {})
        if "overlapped" in ov and "legacy" in ov:  # per-schedule (train)
            ovs = (f"{ov['overlapped'].get('overlap_fraction', 0.0):.0%}"
                   f"/{ov['legacy'].get('overlap_fraction', 0.0):.0%}")
        else:
            ovs = f"{ov.get('overlap_fraction', 0.0):.0%}"
        extra = (f" trace={rec['trace_s']}s peak={rec['memory']['peak_bytes']/2**30:.2f}GiB "
                 f"dom={r['dominant']} c/m/n={r['compute_s']:.4f}/{r['memory_s']:.4f}/"
                 f"{r['collective_s']:.4f}s"
                 f" ovl={ovs}")
        if rec.get("wire_tiers"):
            # effective/capacity MiB per tier at its cadence
            extra += " tiers=" + ",".join(
                f"{t['network']}@e{t['every']}:"
                f"{t['effective_bytes'] / 2**20:.2f}"
                f"/{t['capacity_bytes'] / 2**20:.2f}MiB"
                for t in rec["wire_tiers"])
        if rec.get("moe_a2a"):
            # compressed ep_a2a activation traffic per step
            m = rec["moe_a2a"]
            extra += (f" moe_a2a={m['per_step_bytes'] / 2**20:.2f}MiB"
                      f"@{m['codec']}")
        if rec.get("fidelity"):
            # probe cadence + probe-step overhead
            f = rec["fidelity"]
            extra += (f" fid@e{f['every']}:"
                      f"+{f['extra_wire_bytes'] / 2**20:.2f}MiB"
                      f"/+{sum(f['extra_launches'].values())}launch")
    elif status == "skipped":
        extra = " " + rec["reason"]
    else:
        extra = " " + rec["error"][:160]
    print(f"[dryrun] {rec['arch']:20s} {rec['shape']:12s} {rec['mesh']:8s} {status}{extra}",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sync", default="loco")
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="enable the bucketed scheduler for train shapes "
                         "with this fp32 bucket target (MiB)")
    ap.add_argument("--policy", default=None,
                    help="per-bucket wire policy for train shapes, e.g. "
                         "'body=loco4+topk1%%+every4' (same grammar as "
                         "launch/train.py --policy); tier cadence and "
                         "capacity-vs-effective bytes land in the "
                         "wire_tiers record and the tiers= column")
    ap.add_argument("--fidelity-every", type=int, default=None,
                    help="also run the fidelity-probe step for train "
                         "shapes and report the probe cadence plus the "
                         "probe step's overhead (extra wire bytes and "
                         "collective launches against a normal step) in "
                         "the fid= column")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="run the primary train step on the flat schedule "
                         "(the overlap record still reports both "
                         "schedules)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (nothing is allocated "
                         "on either; the plan is the same)")
    ap.add_argument("--world", default=None, metavar="DPxTP",
                    help="a smaller fake world, DPxTP or PODSxDATAxTP, in "
                         "place of the production mesh")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    overrides: dict = {}
    if args.bucket_mb is not None:
        overrides["bucket_bytes"] = int(args.bucket_mb * 2**20)
    if not args.overlap:
        overrides["overlap"] = False
    if args.fidelity_every is not None:
        overrides["fidelity_every"] = args.fidelity_every
    if args.policy:
        from repro_torch.core import policy as POL
        # same base sync default_run builds, so presets inherit correctly
        overrides["policy"] = POL.parse_policy(
            args.policy,
            SyncConfig(strategy=args.sync, quant=QuantConfig(mode="block")))

    from repro_torch.configs.all_archs import ASSIGNED

    world = parse_world(args.world) if args.world else None
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    recs = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                mesh_name = (world or MESH.make_production_mesh(
                    multi_pod=mp)).name
                if args.skip_existing:
                    name = f"{a}__{s}__{mesh_name}__{args.sync}.json"
                    if os.path.exists(os.path.join(args.out, name)):
                        print(f"[dryrun] {a} {s} exists, skip")
                        continue
                recs.append(dryrun_one(
                    a, s, multi_pod=mp, sync_strategy=args.sync,
                    out_dir=args.out, run_overrides=overrides or None,
                    device=args.device, world=world))
    return recs


if __name__ == "__main__":
    main()
