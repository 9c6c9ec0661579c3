"""``--moe-a2a block8+ef``: the MoE combine's error feedback against the JAX
reference (CPU, reduced deepseek-v3-moe).

* ``a2a_exchange_ef`` at tp 2 (two spawned gloo ranks against the
  reference under ``shard_map``), a slot buffer whose row pads from 600 to
  1024 elements, over two rounds whose residual evolves: the received
  rows bit for bit, the new residual (bf16) bit for bit; its cotangent is
  the stateless exchange's bit for bit.
* Training from the reference's init: dp 1 x tp 2 (the same spawn,
  microbatch 1, sequence parallelism on) and dp 1 x tp 1 (in process,
  microbatch 2), 3 steps each, within the MoE loss limits of
  ``tests/test_torch_moe_train.py`` (step 0 within 2e-3 relative, later
  2e-2 absolute, router losses 2e-2 relative).  The residual stacks
  after steps 0 and 1 against the reference's: element by element they
  cannot be compared, because a residual is chaotic in the rounding of
  its input (``h - decode(encode(h))`` with int8 codes of ``h``'s bf16
  values; scaling the port's own weights by 1 + 2^-12 leaves its
  residuals as far from its unscaled run's, relative L2 1.4, as from the
  reference's).  Each 512-element row's largest residual is half the
  row's quantum, though, and that scale survives: its median relative
  gap is held to ``ROW_RTOL`` (0.004-0.021 measured at tp 2 and tp 1),
  and the same statistic against the other layer's or the other step's
  rows reads 0.18 or more, so a residual filed under the wrong layer or
  step fails.
* The wiring, on the tp 1 run with every EF exchange recorded: each
  layer reads what its own layer left at the previous microbatch (the
  step's input state at the first), remat's recomputation reads and
  computes the same, the state after a step is the last microbatch's,
  and the combine differs from block8's exactly where the residual is
  not zero.
* ``--remat`` on and off leave the same residuals and losses bit for bit
  (the recomputed forward reads the step's input state and stores
  nothing).
* The fingerprint's ``moe_a2a`` key equals the reference's as JSON, and a
  checkpoint written under ``block8+ef`` refuses to restore under
  ``block8`` (``CheckpointMismatch``).
* The ``states/_moe_a2a/ef`` entry crosses both ways byte for byte: the
  reference restores the port's checkpoint and the port resumes the
  reference's.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

from repro.checkpoint import checkpoint as JCKPT
from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import act_comm as JACT
from repro.core.flatparam import MeshTopo as JTopo
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.state import serial as jserial
from repro_torch import interop
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import act_comm as ACT
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TTF
from repro_torch.state import serial
from repro_torch.state.manifest import CheckpointMismatch

STEP0_RTOL, LATER_ATOL, ROUTER_RTOL = 2e-3, 2e-2, 2e-2
ROW_RTOL = 0.05
SEQ, STEPS = 32, 3
# tp -> (global batch, microbatch)
TRAIN = {1: (8, 2), 2: (4, 1)}
SHAPE4 = (2, 1, 3, 200)   # (tp, El, cap, d): 600 per peer, padded to 1024
N_PAD = 1024


def _cfgs(codec="block8+ef"):
    return tuple(dataclasses.replace(c, moe_a2a_codec=codec) for c in (
        jreduced(jget_arch("deepseek-v3-moe")),
        reduced(get_arch("deepseek-v3-moe"))))


def _run_cfgs(tp, **kw):
    common = dict(optimizer="adam", microbatch=TRAIN[tp][1],
                  total_steps=STEPS, warmup_steps=2, lr=2e-3, **kw)
    return (jsteps.RunConfig(sync=JSync(strategy="loco"), **common),
            tsteps.RunConfig(sync=SyncConfig(strategy="loco"), **common))


def _shape(tp, side):
    return (JShape, ShapeConfig)[side]("t", SEQ, TRAIN[tp][0], "train")


def _batches(vocab, tp):
    rng = np.random.default_rng(45)
    return [rng.integers(0, vocab, (TRAIN[tp][0], SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _exchange_inputs():
    rng = np.random.default_rng(9)
    tp = SHAPE4[0]
    x = rng.standard_normal((2, tp) + SHAPE4).astype(np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)  # bf16 activations
    err0 = (rng.standard_normal((tp, tp * N_PAD)) * 0.01).astype(
        jnp.bfloat16)
    w = rng.standard_normal((tp,) + SHAPE4).astype(np.float32)
    return x, np.asarray(err0), w


# ---------------------------------------------------------------------------
# the port's ranks (dp 1 x tp 2)
# ---------------------------------------------------------------------------

def _port_train(tp, host, topo, remat=True):
    """Per-step metrics, the final state and the residual stack
    ``(n_layers, len)`` after each step."""
    _, tcfg = _cfgs()
    ts = interop.from_reference(*host, groups=TTF.build_groups(tcfg, tp),
                                rank=topo.rank, dp=topo.dp,
                                tp_rank=topo.tp_rank)
    step_fn = tsteps.make_train_step(tcfg, _run_cfgs(tp, remat=remat)[1],
                                     topo, torch.device("cpu"),
                                     _shape(tp, 1))
    out, efs = [], []
    for i, t in enumerate(_batches(tcfg.vocab, tp)):
        m = step_fn(ts, i, {"tokens": torch.from_numpy(t).long()})
        out.append({k: float(m[k]) for k in ("loss", "moe_aux", "moe_z")})
        efs.append(ts.states[ACT.EF_STATE_KEY]["ef"][:, 0, 0].clone())
    return out, ts, efs


def _worker(rank, rdv, out_dir, host):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, 2, rdv)
    data, model = tmesh.mesh_groups(2)
    x, err0, w = _exchange_inputs()
    err = torch.from_numpy(err0[rank].view(np.int16)).view(torch.bfloat16)
    rounds = []
    for r in range(2):
        xr = torch.from_numpy(x[r, rank]).to(torch.bfloat16)
        xe = xr.clone().requires_grad_()
        y, err = ACT.a2a_exchange_ef(xe, err, model)
        (y.float() * torch.from_numpy(w[rank])).sum().backward()
        xs = xr.clone().requires_grad_()
        (ACT.a2a_exchange(xs, model).float()
         * torch.from_numpy(w[rank])).sum().backward()
        rounds.append((y.detach().float(), err.clone(), xe.grad.clone(),
                       xs.grad.clone()))
    topo = MeshTopo.from_group(data, model=model)
    losses, ts, efs = _port_train(2, host, topo)
    torch.save({"rounds": rounds, "losses": losses,
                "ef": ts.states[ACT.EF_STATE_KEY]["ef"].clone(), "efs": efs},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _ref_exchange():
    mesh = make_local_mesh(dp=1, tp=2)
    x, err0, _ = _exchange_inputs()

    def body(xx, ee):
        y, ne = JACT.a2a_exchange_ef(xx[0], ee[0], "model")
        return y[None], ne[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P("model"), P("model")),
                              out_specs=(P("model"), P("model")),
                              check_vma=False))
    err, out = jnp.asarray(err0), []
    for r in range(2):
        y, err = f(jnp.asarray(x[r]).astype(jnp.bfloat16), err)
        out.append((np.asarray(y, np.float32), np.asarray(err)))
    return out


def _ref_init(tp):
    jcfg, _ = _cfgs()
    mesh = make_local_mesh(dp=1, tp=tp)
    init_fn, _ = jsteps.make_init(jcfg, _run_cfgs(tp)[0], mesh,
                                  _shape(tp, 0))
    return mesh, init_fn(jax.random.PRNGKey(0))


def _ref_train(tp, mesh, state, ckpt_dir=None):
    """Per-step metrics and the global residual stack ``(n_layers, dp,
    tp, len)`` after each step; with ``ckpt_dir`` a checkpoint after step
    1."""
    jcfg, _ = _cfgs()
    run = dataclasses.replace(_run_cfgs(tp)[0], sequence_parallel=True)
    bundle = jsteps.make_train_step(jcfg, run, mesh, _shape(tp, 0))
    chunks, states, opt = state
    out, efs = [], []
    for i, tok in enumerate(_batches(jcfg.vocab, tp)):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           {"tokens": jnp.asarray(tok)})
        out.append({k: float(m[k]) for k in ("loss", "moe_aux", "moe_z")})
        efs.append(np.asarray(states[JACT.EF_STATE_KEY]["ef"], np.float32))
        if i == 0 and ckpt_dir is not None:
            fp = jsteps.state_fingerprint(
                run, bundle.helpers["groups"], bundle.helpers["topo"],
                bundle.helpers["plan"], arch=jcfg, shape=_shape(tp, 0))
            JCKPT.save(ckpt_dir, 1, {"chunks": chunks, "states": states,
                                     "opt": opt}, fingerprint=fp)
    return out, efs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ef_tp2")
    mesh2, st2 = _ref_init(2)
    ctx = tmp.start_processes(
        _worker, args=(str(d / "rdv"), str(d),
                       jax.tree.map(np.asarray, st2)),
        nprocs=2, join=False, start_method="spawn")
    mesh1, st1 = _ref_init(1)
    host1 = jax.tree.map(np.asarray, st1)
    ckpt = str(d / "ref_ckpt")
    ref = {"exchange": _ref_exchange(), 2: _ref_train(2, mesh2, st2),
           1: _ref_train(1, mesh1, st1, ckpt)}
    while not ctx.join():
        pass
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(2)]
    return ranks, ref, host1, ckpt


@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield MeshTopo.from_group(g, model=tmesh.model_group())


def _bf16_bytes(t):
    return t.contiguous().view(torch.int16).numpy().tobytes()


def _assert_close(port, ref):
    gaps = [abs(p["loss"] - r["loss"]) for p, r in zip(port, ref)]
    print(f"port {port}\nreference {ref}\nloss gaps {gaps}")
    assert gaps[0] <= STEP0_RTOL * abs(ref[0]["loss"]), gaps
    assert max(gaps[1:]) <= LATER_ATOL, gaps
    for key in ("moe_aux", "moe_z"):
        for p, r in zip(port, ref):
            assert abs(p[key] - r[key]) <= ROUTER_RTOL * abs(r[key]), \
                (key, p[key], r[key])
    assert all(np.isfinite(p["loss"]) for p in port)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def test_ef_exchange_matches_reference(runs):
    ranks, ref, _, _ = runs
    for r, (y, ne) in enumerate(ref["exchange"]):
        for rank in range(2):
            gy, gne, _, _ = ranks[rank]["rounds"][r]
            np.testing.assert_array_equal(gy.numpy(), y[rank],
                                          err_msg=f"round {r} rank {rank}")
            assert _bf16_bytes(gne) == np.ascontiguousarray(
                ne[rank]).view(np.int16).tobytes(), (r, rank)
    # the residual carries what no peer received, and it evolved
    r0, r1 = (ranks[0]["rounds"][i][1] for i in range(2))
    assert float(r1.float().abs().max()) > 0 and not torch.equal(r0, r1)


def test_ef_cotangent_is_the_stateless_exchange(runs):
    ranks, _, _, _ = runs
    for rank in range(2):
        for _, _, g_ef, g_plain in ranks[rank]["rounds"]:
            assert torch.equal(g_ef, g_plain)
            assert float(g_ef.float().abs().max()) > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _row_gap(port_ef, ref_ef) -> float:
    """The median relative gap between the two stacks' largest residual
    per 512-element row (about half the row's int8 quantum) over the rows
    either stack fills; ``(n_layers, len)`` each."""
    a, b = (np.abs((x.float().numpy() if isinstance(x, torch.Tensor)
                    else np.asarray(x, np.float32))
                   .reshape(x.shape[0], -1, 512)).max(-1)
            for x in (port_ef, ref_ef))
    live = (a > 0) | (b > 0)
    return float(np.median(np.abs(a - b)[live] / np.maximum(a, b)[live]))


def _assert_residuals_track(port_efs, ref_efs):
    """After steps 0 and 1 the port's residuals fill the reference's rows
    at the reference's scale, and the check sees a residual taken from
    the wrong layer or the wrong step."""
    for step in (0, 1):
        got, want = port_efs[step], ref_efs[step]
        gap = _row_gap(got, want)
        wrong = (_row_gap(got.flip(0), want),
                 _row_gap(port_efs[1 - step], want))
        print(f"step {step}: row gap {gap:.4f}; wrong layer, wrong step "
              f"{wrong[0]:.4f}, {wrong[1]:.4f}")
        assert gap <= ROW_RTOL, (step, gap)
        assert min(wrong) > 2 * ROW_RTOL, (step, wrong)


def test_tp2_training_matches_reference(runs):
    ranks, ref, _, _ = runs
    losses, ref_efs = ref[2]
    _assert_close(ranks[0]["losses"], losses)
    assert ranks[1]["losses"] == ranks[0]["losses"]
    for rank in range(2):
        ef = ranks[rank]["ef"]
        assert ef.dtype == torch.bfloat16 and ef.shape[:3] == (2, 1, 1)
        assert float(ef.float().abs().max()) > 0
        _assert_residuals_track(ranks[rank]["efs"],
                                [e[:, 0, rank] for e in ref_efs])


@pytest.fixture(scope="module")
def spied1(runs, group1):
    """The tp 1 run (remat on) with every EF exchange recorded: the
    residual before each step and every call's ``(x, err, y, new_err)``."""
    _, _, host1, _ = runs
    calls, exchange = [], ACT.a2a_exchange_ef

    def spy(x4, err, group):
        y, new_err = exchange(x4, err, group)
        calls.append(tuple(t.detach().clone() for t in (x4, err, y, new_err))
                     + (group,))
        return y, new_err

    ACT.a2a_exchange_ef = spy
    try:
        losses, ts, efs = _port_train(1, host1, group1)
    finally:
        ACT.a2a_exchange_ef = exchange
    return losses, ts, efs, calls


def test_tp1_training_matches_reference(runs, spied1):
    _, ref, _, _ = runs
    losses, ts, efs, _ = spied1
    _assert_close(losses, ref[1][0])
    assert float(ts.states[ACT.EF_STATE_KEY]["ef"].float().abs().max()) > 0
    _assert_residuals_track(efs, [e[:, 0, 0] for e in ref[1][1]])


def test_residual_is_carried_in_order(spied1):
    """Each layer's exchange reads the residual its own layer left at the
    previous microbatch (the step's input state at the first), the
    recomputed forward of the backward reads and computes the same, the
    state after a step is the last microbatch's, and the combine differs
    from block8's exactly where the residual is not zero."""
    _, _, efs, calls = spied1
    L = efs[0].shape[0]
    accum = TRAIN[1][0] // TRAIN[1][1]
    assert len(calls) == STEPS * accum * 2 * L   # forward, then recompute
    prev = torch.zeros_like(efs[0])
    for step in range(STEPS):
        for k in range(accum):
            mb = calls[(step * accum + k) * 2 * L:][:2 * L]
            fwd, rec = mb[:L], mb[L:][::-1]
            for layer in range(L):
                x, err, y, new_err, group = fwd[layer]
                assert torch.equal(err, prev[layer]), (step, k, layer)
                for a, b in zip(rec[layer][:4], fwd[layer][:4]):
                    assert torch.equal(a, b), (step, k, layer)
                with torch.no_grad():
                    plain = ACT.a2a_exchange(x, group)
                first = step == 0 and k == 0
                assert torch.equal(y, plain) == first, (step, k, layer)
                assert float(new_err.float().abs().max()) > 0
            prev = torch.stack([c[3] for c in fwd])
        assert torch.equal(efs[step], prev), step


def test_remat_leaves_the_same_residuals(runs, group1, spied1):
    _, _, host1, _ = runs
    l_on, ts_on, _, _ = spied1
    l_off, ts_off, _ = _port_train(1, host1, group1, remat=False)
    assert l_on == l_off
    a, b = (t.states[ACT.EF_STATE_KEY]["ef"] for t in (ts_on, ts_off))
    assert _bf16_bytes(a) == _bf16_bytes(b)


# ---------------------------------------------------------------------------
# fingerprint and checkpoints
# ---------------------------------------------------------------------------

def _fingerprints(topo, codec="block8+ef"):
    jcfg, tcfg = _cfgs(codec)
    jrun, trun = _run_cfgs(1)
    mesh = make_local_mesh(dp=1, tp=1)
    jtopo = JTopo.from_mesh(mesh)
    jgroups = jsteps.build_model(jcfg, 1).groups()
    jfp = jsteps.state_fingerprint(jrun, jgroups, jtopo, None, arch=jcfg,
                                   shape=_shape(1, 0))
    tfp = tsteps.state_fingerprint(trun, TTF.build_groups(tcfg, 1), topo,
                                   None, tcfg, _shape(1, 1))
    return jfp, tfp


def test_fingerprint_is_the_references(group1):
    jfp, tfp = _fingerprints(group1)
    assert tfp["moe_a2a"]["codec"] == "block8+ef"
    assert tfp["moe_a2a"]["state_len"] == ACT.ef_state_len(
        _cfgs()[1], TRAIN[1][1] * SEQ, 1) > 0
    assert json.dumps(tfp, sort_keys=True) == json.dumps(jfp, sort_keys=True)
    assert "moe_a2a" not in _fingerprints(group1, "block8")[1]


def test_checkpoint_crosses_both_ways(runs, group1, tmp_path):
    _, _, host1, ref_ckpt = runs
    _, tcfg = _cfgs()
    trun = _run_cfgs(1)[1]
    jfp, tfp = _fingerprints(group1)
    # the reference's checkpoint resumes in the port, residuals byte for byte
    ts = tsteps.make_init(tcfg, trun, group1, torch.device("cpu"), 0,
                          _shape(1, 1))
    assert CKPT.resume(ref_ckpt, ts, group1, fingerprint=tfp) == 1
    stored = jserial.flatten(JCKPT.restore(
        ref_ckpt, 1, _ref_template(), fingerprint=jfp))
    ref_ef = np.asarray(stored["states/_moe_a2a/ef"])
    assert float(np.abs(ref_ef.astype(np.float32)).max()) > 0
    assert _bf16_bytes(ts.states[ACT.EF_STATE_KEY]["ef"]) == \
        np.ascontiguousarray(ref_ef).view(np.int16).tobytes()
    # the port's checkpoint restores in the reference, byte for byte
    losses, ts, _ = _port_train(1, host1, group1)
    ckpt = str(tmp_path / "port")
    CKPT.save_train_state(ckpt, 3, ts, group1, fingerprint=tfp)
    got = jserial.flatten(JCKPT.restore(ckpt, 3, _ref_template(),
                                        fingerprint=jfp))
    mine = serial.flatten({"chunks": ts.chunks, "states": ts.states,
                           "opt": ts.opt})
    assert set(got) == set(mine)
    assert np.ascontiguousarray(got["states/_moe_a2a/ef"]).view(
        np.int16).tobytes() == _bf16_bytes(mine["states/_moe_a2a/ef"])
    # a codec flip is a named mismatch
    _, b8 = _fingerprints(group1, "block8")
    flip = tsteps.make_init(_cfgs("block8")[1], trun, group1,
                            torch.device("cpu"))
    with pytest.raises(CheckpointMismatch, match="moe_a2a"):
        CKPT.resume(ckpt, flip, group1, fingerprint=b8)


def _ref_template():
    jcfg, _ = _cfgs()
    mesh = make_local_mesh(dp=1, tp=1)
    init_fn, _ = jsteps.make_init(jcfg, _run_cfgs(1)[0], mesh, _shape(1, 0))
    chunks, states, opt = init_fn(jax.random.PRNGKey(1))
    return {"chunks": chunks, "states": states, "opt": opt}
