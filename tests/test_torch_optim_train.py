"""The training slice under every optimizer of the CLI, against the JAX
reference (CPU, reduced llama2-400m, dp 2).

The reference's ``make_init`` state is carried into the port
(``interop.from_reference``); the reference trains under ``shard_map`` on
2 host devices, the port on a spawned 2-rank gloo group (at the same
time), both 4 steps at ``--warmup 0 --lr 1e-3`` on the CLI's synthetic
batches.  Each case holds the port's losses to the reference's within the
loss limits of ``tests/test_torch_train.py`` (2e-3 relative at step 0,
2e-2 absolute after): ``--optimizer adam|sgd|lamb|adafactor`` here, and
``--schedule wsd``, ``--quant-mode fixed``, ``--quant-mode tensor
--error-codec bf16`` and ``--error-codec none`` in
``tests/test_torch_codec_train.py``, which shares this harness.  One more
case shows that the limits can see a wrong optimizer: the port's lamb
falls outside them against the reference's adam, as does every other
pair.  The CLI accepts every new flag and maps it onto the reference's
``RunConfig``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.core.loco import SyncConfig as JSync
from repro.core.quantizer import QuantConfig as JQuant
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import make_local_mesh
from repro.configs.base import ShapeConfig as JShape
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.core.quantizer import QuantConfig
from repro_torch.data.synthetic import DataConfig, make_batch_fn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TTF
from test_torch_train import (BATCH, JCFG, LATER_ATOL, MICRO, SEQ,
                              STEP0_RTOL, TCFG)

STEPS, LR = 4, 1e-3
# case -> (RunConfig fields other than sync, QuantConfig fields)
CASES = {
    "adam": ({}, {}),
    "sgd": ({"optimizer": "sgd"}, {}),
    "lamb": ({"optimizer": "lamb"}, {}),
    "adafactor": ({"optimizer": "adafactor"}, {}),
    "wsd": ({"schedule": "wsd"}, {}),
    "fixed": ({}, {"mode": "fixed"}),
    "tensor-bf16": ({}, {"mode": "tensor", "error_codec": "bf16"}),
    "error-none": ({}, {"error_codec": "none"}),
}
OPTIMIZER_CASES = ("adam", "sgd", "lamb", "adafactor")


def _cfgs(case):
    run, quant = CASES[case]
    common = dict(microbatch=MICRO, total_steps=STEPS, warmup_steps=0,
                  lr=LR, **run)
    return (jsteps.RunConfig(sync=JSync(quant=JQuant(**quant)), **common),
            tsteps.RunConfig(sync=SyncConfig(quant=QuantConfig(**quant)),
                             **common))


def _batches():
    """The CLI's synthetic (zipf) batches, which a model can learn from
    in a few steps, so that the optimizers part ways."""
    fn = make_batch_fn(DataConfig(vocab=TCFG.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    return [fn(i)["tokens"].numpy().astype(np.int32) for i in range(STEPS)]


def _reference_init(case):
    mesh = make_local_mesh(dp=2, tp=1)
    init_fn, _ = jsteps.make_init(JCFG, _cfgs(case)[0], mesh)
    return mesh, init_fn(jax.random.PRNGKey(0))


def _reference_losses(case, mesh, state):
    """The reference's per-step losses at dp 2 from ``state``."""
    chunks, states, opt = state
    bundle = jsteps.make_train_step(JCFG, _cfgs(case)[0], mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    losses = []
    for i, tok in enumerate(_batches()):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
    return losses


def _port_losses(host, case, topo):
    ts = interop.from_reference(*host, groups=TTF.build_groups(TCFG, 1),
                                rank=topo.rank, dp=topo.dp)
    step_fn = tsteps.make_train_step(TCFG, _cfgs(case)[1], topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    return [float(step_fn(ts, i, {"tokens": torch.from_numpy(t).long()})
                  ["loss"]) for i, t in enumerate(_batches())]


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, 2, rdv)
    topo = MeshTopo.from_group(dist.group.WORLD)
    res = {c: _port_losses(h, c, topo) for c, h in hosts.items()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_cases(cases, d) -> dict:
    """{case: (port losses of rank 0, of rank 1, reference losses)}: the
    port's two ranks train every case while the reference does."""
    inits = {c: _reference_init(c) for c in cases}
    hosts = {c: jax.tree.map(np.asarray, st) for c, (_, st) in inits.items()}
    ctx = tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                              nprocs=2, join=False, start_method="spawn")
    ref = {c: _reference_losses(c, *inits[c]) for c in cases}
    while not ctx.join():
        pass
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(2)]
    return {c: (ranks[0][c], ranks[1][c], ref[c]) for c in cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(OPTIMIZER_CASES, tmp_path_factory.mktemp("optim"))


def _gaps(port, ref):
    return [abs(a - b) for a, b in zip(port, ref)]


def _within(port, ref) -> bool:
    gaps = _gaps(port, ref)
    return gaps[0] <= STEP0_RTOL * abs(ref[0]) and max(gaps[1:]) <= LATER_ATOL


def check_case(runs, case):
    port, port1, ref = runs[case]
    print(f"{case}: port {port} reference {ref} gaps {_gaps(port, ref)}")
    assert port == port1  # the dp-mean loss
    assert all(np.isfinite(port))
    assert _within(port, ref), _gaps(port, ref)


@pytest.mark.parametrize("case", OPTIMIZER_CASES)
def test_optimizer_matches_reference(runs, case):
    check_case(runs, case)


def test_limits_see_a_wrong_optimizer(runs):
    """The port's lamb against the reference's adam leaves the limits,
    and so does every pair of distinct optimizers: the cases can tell a
    wrong optimizer from a right one."""
    port_lamb, ref_adam = runs["lamb"][0], runs["adam"][2]
    print(f"port lamb {port_lamb} reference adam {ref_adam}")
    assert not _within(port_lamb, ref_adam)
    for a in OPTIMIZER_CASES:
        for b in OPTIMIZER_CASES:
            if a != b:
                assert not _within(runs[a][0], runs[b][2]), (a, b)


def test_cli_maps_knobs_as_the_reference():
    """The CLI's new flags build the reference's RunConfig fields."""
    argv = ["--arch", "llama2-400m", "--optimizer", "lamb", "--schedule",
            "wsd", "--quant-mode", "fixed", "--quant-scale", "1024",
            "--error-codec", "bf16", "--metrics-jsonl", "x.jsonl"]
    jrun = jtrain.make_run(jtrain.build_args(argv))
    trun = ttrain.make_run(ttrain.build_args(argv))
    assert (trun.optimizer, trun.schedule, trun.telemetry) == \
        (jrun.optimizer, jrun.schedule, jrun.telemetry) == \
        ("lamb", "wsd", True)
    assert dataclasses.asdict(trun.sync.quant) == \
        dataclasses.asdict(jrun.sync.quant)
    targs = ttrain.build_args(["--arch", "llama2-400m"])
    jargs = jtrain.build_args(["--arch", "llama2-400m"])
    for k in ("quant_mode", "quant_scale", "error_codec", "optimizer",
              "schedule", "telemetry", "metrics_jsonl", "metrics_every",
              "profile_steps"):
        assert getattr(targs, k) == getattr(jargs, k), k
    for name in ("sgd", "adam", "adamw", "lamb", "adafactor",
                 "adafactor_flat"):
        assert ttrain.build_args(["--arch", "x", "--optimizer",
                                  name]).optimizer == name
