"""The state-space, hybrid and audio families train in the port as in the
JAX reference (CPU, ``--sync loco``, Adam, 3 steps, global batch 8,
microbatch 2, seq 32, dp 1, tp 1): the port of
``tests/test_smoke_archs.py::test_train_step`` for mamba2-2.7b,
zamba2-2.7b and whisper-small, held to the reference's losses.

Each config, reduced, starts from the reference's ``make_init`` state
(``interop.from_reference``) and sees the same numpy batches (whisper's
frames too: 32 frames of bf16 and ``dec_len`` 32 tokens).  Seq 32 keeps
the SSD scan in one chunk of 32 steps, where the reference's gradient is
finite (tests/test_torch_ssm.py pins its NaN at 128).  Bounds are the
north star's: step-0 loss within 2e-3 relative, steps 1-2 within 2e-2
absolute.  The dp 2 x tp 2 runs are in tests/test_torch_families_dist.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape, get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core.loco import SyncConfig as JSync
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro_torch import interop
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

BATCH, STEPS, MICRO, SEQ = 8, 3, 2, 32
STEP0_RTOL, LATER_ATOL = 2e-3, 2e-2
ARCHS = ["mamba2-2.7b", "zamba2-2.7b", "whisper-small"]


def cfgs(arch):
    """(reference, port) reduced configs."""
    return jreduced(jget_arch(arch)), reduced(get_arch(arch))


def batches(cfg, seq=SEQ, batch=BATCH, steps=STEPS):
    """Per step the numpy batch: tokens, and for an encoder-decoder its
    bf16-exact frames (seq_len of them) and dec_len + 1 tokens."""
    rng = np.random.default_rng(46)
    out = []
    for _ in range(steps):
        b = {}
        if cfg.enc_dec:
            fr = rng.standard_normal((batch, seq, cfg.d_model)).astype(
                np.float32)
            b["frames"] = np.asarray(jnp.asarray(fr).astype(jnp.bfloat16)
                                     .astype(jnp.float32))
        n = cfg.dec_len if cfg.enc_dec else seq
        b["tokens"] = rng.integers(0, cfg.vocab, (batch, n + 1)).astype(
            np.int32)
        out.append(b)
    return out


def run_cfgs(micro=MICRO, **kw):
    common = dict(optimizer="adam", microbatch=micro, total_steps=STEPS,
                  warmup_steps=2, lr=2e-3, **kw)
    return (jsteps.RunConfig(sync=JSync(strategy="loco"), **common),
            tsteps.RunConfig(sync=SyncConfig(strategy="loco"), **common))


def _jbatch(b):
    return {k: (jnp.asarray(v).astype(jnp.bfloat16) if k == "frames"
                else jnp.asarray(v)) for k, v in b.items()}


def _tbatch(b):
    return {k: (torch.from_numpy(np.array(v)).bfloat16() if k == "frames"
                else torch.from_numpy(v).long()) for k, v in b.items()}


def _init(jcfg, dp, tp, batch, micro, seq):
    mesh = make_local_mesh(dp=dp, tp=tp)
    run = run_cfgs(micro)[0]
    shape = JShape("t", seq, batch, "train")
    init_fn, _ = jsteps.make_init(jcfg, run, mesh, shape)
    return mesh, run, shape, init_fn(jax.random.PRNGKey(0))


def init_host(jcfg, dp=1, tp=1, batch=BATCH, micro=MICRO, seq=SEQ):
    """The reference's ``make_init`` state as numpy trees."""
    return jax.tree.map(np.asarray, _init(jcfg, dp, tp, batch, micro,
                                          seq)[3])


def reference(jcfg, dp=1, tp=1, batch=BATCH, micro=MICRO, seq=SEQ,
              steps=STEPS):
    """(init state as numpy trees, per-step losses, the states after the
    last step as numpy trees) of the reference."""
    mesh, run, shape, (chunks, states, opt) = _init(jcfg, dp, tp, batch,
                                                    micro, seq)
    host = jax.tree.map(np.asarray, (chunks, states, opt))
    bundle = jsteps.make_train_step(jcfg, run, mesh, shape)
    losses = []
    for i, b in enumerate(batches(jcfg, seq, batch, steps)):
        chunks, states, opt, m = bundle.fn(chunks, states, opt, jnp.int32(i),
                                           _jbatch(b))
        losses.append(float(m["loss"]))
    return host, losses, jax.tree.map(np.asarray, states)


def port(tcfg, host, topo, batch=BATCH, micro=MICRO, seq=SEQ,
         steps=STEPS):
    """(per-step losses, the train state after the last step)."""
    ts = interop.from_reference(
        *host, groups=tsteps.model_groups(tcfg, topo.tp), rank=topo.rank,
        dp=topo.dp, tp_rank=topo.tp_rank)
    step_fn = tsteps.make_train_step(tcfg, run_cfgs(micro)[1], topo,
                                     torch.device("cpu"),
                                     ShapeConfig("t", seq, batch, "train"))
    losses = [float(step_fn(ts, i, _tbatch(b))["loss"])
              for i, b in enumerate(batches(tcfg, seq, batch, steps))]
    return losses, ts


def assert_close(got, ref):
    gaps = [abs(p - r) for p, r in zip(got, ref)]
    print(f"port {got}\nreference {ref}\nloss gaps {gaps}")
    assert len(got) == len(ref) == STEPS
    assert all(np.isfinite(got))
    assert gaps[0] <= STEP0_RTOL * abs(ref[0]), gaps
    assert max(gaps[1:]) <= LATER_ATOL, gaps


@pytest.fixture(scope="module")
def topo1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield MeshTopo.from_group(g, model=tmesh.model_group())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_trains_like_reference(topo1, arch):
    jcfg, tcfg = cfgs(arch)
    host, ref, _ = reference(jcfg)
    got, _ = port(tcfg, host, topo1)
    assert_close(got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_groups_mirror_reference(arch):
    """The declarations (group and tensor names, shapes, ``tp_dim``,
    ``loco``, ``decay``, init) equal the reference's, full and reduced, at
    tp 1 and 2; the configs equal the reference's field for field."""
    jstep = jsteps.build_model
    for j, t in ((jget_arch(arch), get_arch(arch)), cfgs(arch)):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.d_inner, j.ssm_heads) == (t.d_inner, t.ssm_heads)
        for tp in (1, 2):
            jg = jstep(j, tp).groups()
            tg = tsteps.model_groups(t, tp)
            assert [(g.name, g.n_layers) for g in jg] == \
                [(g.name, g.n_layers) for g in tg]
            for a, b in zip(jg, tg):
                assert [dataclasses.asdict(i) for i in a.infos] == \
                    [dataclasses.asdict(i) for i in b.infos]


def test_hybrid_shared_block_syncs_once_per_microbatch(topo1, monkeypatch):
    """Reduced zamba2 applies the shared block twice per forward (two
    super-blocks of one mamba layer); each loco tensor of it is gathered,
    and synced, once per microbatch: the LoCo wrappers run once per loco
    tensor of every group and microbatch (the counts chip_smoke.py's
    launch derivation assumes)."""
    from repro_torch.kernels import loco_quant as LQ

    calls = {}
    for name in ("fused_compress", "dequant_mean"):
        def wrapped(*a, _fn=getattr(LQ, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(LQ, name, wrapped)
    _, tcfg = cfgs("zamba2-2.7b")
    run = run_cfgs()[1]
    ts = tsteps.make_init(tcfg, run, topo1, torch.device("cpu"))
    step_fn = tsteps.make_train_step(tcfg, run, topo1, torch.device("cpu"),
                                     ShapeConfig("t", SEQ, BATCH, "train"))
    step_fn(ts, 0, _tbatch(batches(tcfg, steps=1)[0]))
    groups = tsteps.model_groups(tcfg, 1)
    shared = sum(i.loco for g in groups if g.name == "shared"
                 for i in g.infos)
    loco = sum((g.n_layers or 1) for g in groups for i in g.infos if i.loco)
    assert shared == 7    # s_wq, s_wk, s_wv, s_wo and the SwiGLU s_w1-3
    accum = BATCH // MICRO
    assert calls == {"fused_compress": loco * accum,
                     "dequant_mean": loco * accum}


def test_sinusoidal_matches_reference():
    """whisper's position table: the exponents are the reference's bit for
    bit (XLA folds ``-log(10000) / (half - 1)`` into one f32 factor); the
    table's exp, sin and cos are the libraries' own (0.98 of the bf16
    entries the encoder adds are the same, the rest one bf16 ulp)."""
    import math

    from repro.models import whisper as JW
    from repro_torch.models import whisper as TW

    for T, d in ((1500, 768), (32, 256)):
        half = d // 2
        want = np.asarray(jax.jit(lambda a: -math.log(10000.0) * a / max(
            half - 1, 1))(jnp.arange(half, dtype=jnp.float32)))
        got = TW.C.scale_by(torch.arange(half, dtype=torch.float32),
                            -math.log(10000.0) / max(half - 1, 1))
        assert np.array_equal(got.numpy(), want)
        j = np.asarray(jax.jit(lambda p: JW.sinusoidal(p, d))(
            jnp.arange(T, dtype=jnp.int32)))
        t = TW.sinusoidal(torch.arange(T), d)
        assert np.abs(t.numpy() - j).max() <= 2e-4
        jb = np.asarray(jnp.asarray(j).astype(jnp.bfloat16), np.float32)
        tb = t.bfloat16().float().numpy()
        assert (jb == tb).mean() >= 0.98
        assert np.abs(jb - tb).max() <= 2.0 ** -7


def test_hybrid_depth_is_whole_super_blocks():
    """zamba2's layers run in super-blocks of ``hybrid_attn_every``: a
    depth that splits one is refused (the reference's reshape fails
    there), 12 of 54 layers make two."""
    cfg = get_arch("zamba2-2.7b")
    with pytest.raises(ValueError, match="super-blocks"):
        tsteps.model_groups(dataclasses.replace(cfg, n_layers=7), 1)
    groups = tsteps.model_groups(dataclasses.replace(cfg, n_layers=12), 1)
    assert [(g.name, g.n_layers) for g in groups] == [
        ("embed", None), ("final", None), ("block", 12), ("shared", None)]
