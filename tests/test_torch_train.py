"""The dense model and the whole training slice of the port against the JAX
reference (CPU, reduced llama2-400m, seq 32, global batch 8, tp 1).

Module level, on f32 inputs (rtol 1e-5): ``rmsnorm``, ``rope`` (half-split
layout), causal attention and ``dense_block``.

Slice level: the reference's ``make_init`` state is carried into the port
with ``interop.from_reference``; both train 3 steps on the same numpy
batches, with ``--sync fp`` and then ``--sync loco``, at dp=1 (in process)
and dp=2 (the port on a spawned 2-rank gloo group, the reference under
``shard_map``).  Step-0 losses agree within 2e-3 relative, steps 1-2 within
2e-2 absolute: bounds set from the fp run, where no codec is involved and
the gap is bf16 matmul / reduction order alone (observed gaps: PERF.md).
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
from jax.sharding import PartitionSpec as P

from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.models import common as JC
from repro.models import transformer as JTF
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import common as TC
from repro_torch.models import transformer as TTF

JCFG = jreduced(jget_arch("llama2-400m"))
TCFG = reduced(get_arch("llama2-400m"))
SEQ, BATCH, STEPS, MICRO = 32, 8, 3, 2
STEP0_RTOL, LATER_ATOL = 2e-3, 2e-2


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_reduced_config_mirrors_reference():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    jg = JTF.build_groups(JCFG, 1)
    tg = TTF.build_groups(TCFG, 1)
    assert [(g.name, g.n_layers) for g in jg] == [(g.name, g.n_layers)
                                                  for g in tg]
    for a, b in zip(jg, tg):
        assert [dataclasses.asdict(i) for i in a.infos] == \
            [dataclasses.asdict(i) for i in b.infos]


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x, s = _f32(rng, 2, 8, 256), _f32(rng, 256)
    np.testing.assert_allclose(
        TC.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(JC.rmsnorm(jnp.asarray(x), jnp.asarray(s))),
        rtol=1e-5, atol=1e-6)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = _f32(rng, 2, SEQ, 4, 64)
    got = TC.rope(torch.from_numpy(x), torch.arange(SEQ), 1e4).numpy()
    want = np.asarray(JC.rope(jnp.asarray(x), jnp.arange(SEQ), 1e4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_matches_reference():
    rng = np.random.default_rng(2)
    q, k, v = (_f32(rng, 2, SEQ, 4, 64) for _ in range(3))
    pos = jnp.arange(SEQ, dtype=jnp.int32)
    want = np.asarray(JC.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos, causal=True))
    got = TC.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dense_block_matches_reference():
    rng = np.random.default_rng(3)
    lay = JTF.head_layout(JCFG, 1)
    infos = [i for g in JTF.build_groups(JCFG, 1) if g.name == "block"
             for i in g.infos]
    p = {i.name: _f32(rng, *i.shape, scale=i.fan_scale()) if i.init == "normal"
         else np.ones(i.shape, np.float32) for i in infos}
    x = _f32(rng, 2, SEQ, JCFG.d_model)
    mesh = make_local_mesh(dp=1, tp=1)

    def body(p, x):
        y, _, _ = JTF.dense_block(p, x, JCFG, lay, 0, jnp.arange(SEQ), None)
        return y

    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x)))
    got = TTF.dense_block({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), TCFG,
                          TTF.head_layout(TCFG, 1), torch.arange(SEQ)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", [2, 1])
def test_gqa_dense_block_matches_reference(kv):
    """Grouped-query attention (4 query heads over ``kv`` kv heads): the
    port's ``expand_kv`` gather branch against the reference's, f32."""
    jcfg = dataclasses.replace(JCFG, n_kv_heads=kv)
    tcfg = dataclasses.replace(TCFG, n_kv_heads=kv)
    rng = np.random.default_rng(30 + kv)
    lay = JTF.head_layout(jcfg, 1)
    tlay = TTF.head_layout(tcfg, 1)
    assert (lay.hl, lay.kvl) == (tlay.hl, tlay.kvl) == (4, kv)
    np.testing.assert_array_equal(tlay.kv_map("cpu").numpy(),
                                  np.asarray(lay.kv_map()))
    infos = [i for g in JTF.build_groups(jcfg, 1) if g.name == "block"
             for i in g.infos]
    assert [dataclasses.asdict(i) for i in infos] == [
        dataclasses.asdict(i) for g in TTF.build_groups(tcfg, 1)
        if g.name == "block" for i in g.infos]
    p = {i.name: _f32(rng, *i.shape, scale=i.fan_scale()) if i.init == "normal"
         else np.ones(i.shape, np.float32) for i in infos}
    x = _f32(rng, 2, SEQ, jcfg.d_model)
    mesh = make_local_mesh(dp=1, tp=1)

    def body(p, x):
        a, _ = JTF.attention_block(p, x, jcfg, lay, 0, jnp.arange(SEQ), None)
        y, _, _ = JTF.dense_block(p, x, jcfg, lay, 0, jnp.arange(SEQ), None)
        return a, y

    want = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
        check_vma=False))({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))
    tp_ = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    got_a = TTF.attention_block(tp_, tx, tcfg, tlay, torch.arange(SEQ))
    got_y = TTF.dense_block(tp_, tx, tcfg, tlay, torch.arange(SEQ))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_and_clip_match_reference(name):
    from repro.optim import optimizers as JOPT
    from repro_torch.optim import optimizers as TOPT

    rng = np.random.default_rng(4)
    p = {"g": {"a": _f32(rng, 1024), "b": _f32(rng, 3, 512)}}
    grads = [{"g": {k: _f32(rng, *v.shape, scale=0.1) for k, v in p["g"].items()}}
             for _ in range(3)]
    mask = {"g": {"a": 1.0, "b": 0.0}}
    jopt, topt = JOPT.OPTIMIZERS[name](weight_decay=0.1), \
        TOPT.OPTIMIZERS[name](weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, p)
    tp = TOPT.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(grads):
        jg, jn = JOPT.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = TOPT.clip_by_global_norm(TOPT.tree_map(torch.from_numpy, g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, js = jopt.update(jg, js, jp, jnp.int32(step), jnp.float32(1e-2),
                             jax.tree.map(jnp.float32, mask))
        tp, ts = topt.update(tg, ts, tp, torch.tensor(step),
                             torch.tensor(1e-2), mask)
    for k in p["g"]:
        np.testing.assert_allclose(tp["g"][k].numpy(), np.asarray(jp["g"][k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_reference(name):
    from repro.optim.schedules import make_schedule as jsched
    from repro_torch.optim.schedules import make_schedule as tsched

    j, t = jsched(name, 3e-4, 100, 10), tsched(name, 3e-4, 100, 10)
    for step in (0, 1, 5, 9, 10, 50, 89, 95, 99, 150):
        np.testing.assert_allclose(float(t(step)), float(j(jnp.int32(step))),
                                   rtol=1e-6, err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# slice level
# ---------------------------------------------------------------------------

def _batches():
    rng = np.random.default_rng(42)
    return [rng.integers(0, TCFG.vocab, (BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _run_cfgs(strategy):
    common = dict(optimizer="adam", microbatch=MICRO, total_steps=STEPS,
                  warmup_steps=2, lr=2e-3)
    return (jsteps.RunConfig(sync=JSync(strategy=strategy), **common),
            tsteps.RunConfig(sync=SyncConfig(strategy=strategy), **common))


def _reference(dp, strategy):
    """(init state as numpy trees, per-step losses) of the JAX reference."""
    mesh = make_local_mesh(dp=dp, tp=1)
    run = _run_cfgs(strategy)[0]
    init_fn, _ = jsteps.make_init(JCFG, run, mesh)
    chunks, states, opt = init_fn(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, (chunks, states, opt))
    bundle = jsteps.make_train_step(JCFG, run, mesh,
                                    JShape("t", SEQ, BATCH, "train"))
    losses = []
    for i, tok in enumerate(_batches()):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
    return host, losses


def _port_losses(host, strategy, topo):
    groups = TTF.build_groups(TCFG, 1)
    ts = interop.from_reference(*host, groups=groups, rank=topo.rank,
                                dp=topo.dp)
    step_fn = tsteps.make_train_step(TCFG, _run_cfgs(strategy)[1], topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    return [float(step_fn(ts, i, {"tokens": torch.from_numpy(t).long()})
                  ["loss"]) for i, t in enumerate(_batches())]


def _assert_close(port, ref):
    gaps = [abs(a - b) for a, b in zip(port, ref)]
    print(f"port {port} reference {ref} gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(ref[0]), gaps
    assert max(gaps[1:]) <= LATER_ATOL, gaps


@pytest.fixture(scope="module")
def reference():
    return {(dp, s): _reference(dp, s) for dp in (1, 2)
            for s in ("fp", "loco")}


@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield g


@pytest.mark.parametrize("strategy", ["fp", "loco"])
def test_slice_dp1_matches_reference(reference, group1, strategy):
    host, ref = reference[(1, strategy)]
    port = _port_losses(host, strategy, MeshTopo.from_group(group1))
    _assert_close(port, ref)
    assert all(np.isfinite(port)) and port[-1] < port[0]


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, 2, rdv)
    topo = MeshTopo.from_group(dist.group.WORLD)
    res = {s: _port_losses(hosts[s], s, topo) for s in ("fp", "loco")}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_dp2(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    hosts = {s: reference[(2, s)][0] for s in ("fp", "loco")}
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                        nprocs=2, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("strategy", ["fp", "loco"])
def test_slice_dp2_matches_reference(reference, port_dp2, strategy):
    ref = reference[(2, strategy)][1]
    _assert_close(port_dp2[0][strategy], ref)
    assert port_dp2[0][strategy] == port_dp2[1][strategy]  # dp-mean loss


def test_cli_trains_on_cpu(group1):
    out = ttrain.main(["--arch", "llama2-400m", "--reduced", "--steps", "2",
                       "--seq-len", "16", "--global-batch", "4",
                       "--microbatch", "2", "--device", "cpu",
                       "--log-every", "1"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["peak_mem_bytes"] is None
