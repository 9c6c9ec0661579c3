"""Codec math of the PyTorch port against the JAX reference (CPU).

The same numpy inputs go through ``repro`` (jax) and ``repro_torch``
(torch): quantizer, int4 packing, the error codecs and the loco / ef /
naive4 codecs' encode and decode_mean.  Payloads and scales must match bit
for bit.  A stored f8 error may be one f8 quantum off on fewer than 5e-3 of
the elements: the tolerance ``tests/test_kernels.py`` grants the Pallas
kernel against the same oracle (a 1-ulp f32 difference upstream can flip a
round-to-even tie of the f8 encode).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg_base
from repro.core import codec as jcodec
from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro_torch.configs import base as tcfg_base
from repro_torch.core import codec as tcodec
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.interop import to_torch

ESCALE = 2.0**14


def _np(x) -> np.ndarray:
    """torch or jax array -> numpy (f8/bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float8_e4m3fn, torch.bfloat16):
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name in ("float8_e4m3fn", "bfloat16"):
        x = x.astype(np.float32)
    return x


def assert_f8_close(got, want):
    """At most one f8 quantum apart, on fewer than 5e-3 of the elements."""
    a, b = _np(got), _np(want)
    de = np.abs(a - b)
    quantum = np.maximum(np.maximum(np.abs(a), np.abs(b)) / 8.0, 2.0**-9)
    assert (de <= quantum + 1e-12).all(), float(de.max())
    assert (de != 0).mean() < 5e-3, float((de != 0).mean())


def _grad(rng, n, scale=1e-3, zero_blocks=True):
    """Per-256-block magnitudes from 1e-6 to 1, some all-zero blocks."""
    g = rng.standard_normal(n).astype(np.float32)
    mag = (10.0 ** rng.uniform(-6, 0, n // 256)).astype(np.float32)
    g = (g.reshape(-1, 256) * mag[:, None] * scale / 1e-3).reshape(-1)
    if zero_blocks:
        g.reshape(-1, 256)[::5] = 0.0
    return g.astype(np.float32)


def _f8_state(rng, n, spread=200.0):
    """A stored f8 error with |e * escale| beyond 448 for some entries
    (stored values saturate at 448) and exact zeros."""
    e = np.clip(rng.standard_normal(n) * spread, -448, 448).astype(np.float32)
    e[::7] = 0.0
    j = jnp.asarray(e).astype(jnp.float8_e4m3fn)
    return j, to_torch(np.asarray(j))


def test_config_fields_mirror_reference():
    fq = {f.name for f in dataclasses.fields(jQ.QuantConfig)}
    assert fq == {f.name for f in dataclasses.fields(tQ.QuantConfig)}
    fs = {f.name for f in dataclasses.fields(jloco.SyncConfig)}
    # the port picks kernels by tensor device, not by flag
    assert fs - {"use_kernels"} == {
        f.name for f in dataclasses.fields(tloco.SyncConfig)}
    fa = {f.name for f in dataclasses.fields(jcfg_base.ArchConfig)}
    assert fa == {f.name for f in dataclasses.fields(tcfg_base.ArchConfig)}
    assert tQ.DEFAULT_BLOCK == jQ.DEFAULT_BLOCK == 256


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_unpack_int4_bitexact(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 8, (6, 1026)).astype(np.int8)   # odd nibble slots too
    jp = np.asarray(jQ.pack_int4(jnp.asarray(q)))
    tp = tQ.pack_int4(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tQ.unpack_int4(to_torch(jp)).numpy(), q)
    np.testing.assert_array_equal(np.asarray(jQ.unpack_int4(jnp.asarray(tp))), q)


@pytest.mark.parametrize("mode", ["block", "fixed", "tensor"])
@pytest.mark.parametrize("bits", [4, 8])
def test_compress_decompress_bitexact(mode, bits):
    rng = np.random.default_rng(bits * 10 + len(mode))
    x = _grad(rng, 4096)
    cfg = dict(bits=bits, mode=mode, scale=2.0**10)
    jcfg, tcfg = jQ.QuantConfig(**cfg), tQ.QuantConfig(**cfg)
    jp, js = jQ.compress(jnp.asarray(x), jcfg)
    tp, ts = tQ.compress(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tQ.decompress(tp, ts, tcfg).numpy(),
        np.asarray(jQ.decompress(jp, js, jcfg)))


@pytest.mark.parametrize("codec", ["f8", "bf16", "int8", "none"])
def test_error_codecs(codec):
    rng = np.random.default_rng(7)
    # |e * escale| up to ~1600: beyond the f8 bound of 448
    e = (rng.standard_normal(8192) * 0.03).astype(np.float32)
    e[:16] = [0.0, -0.0, 1e-9, -1e-9, 0.05, -0.05, 0.1, -0.1,
              448 / ESCALE, -448 / ESCALE, 449 / ESCALE, 1.0, -1.0,
              2.0**-23, 7e-3, -7e-3]
    jcfg, tcfg = jQ.QuantConfig(error_codec=codec), tQ.QuantConfig(error_codec=codec)
    je = jQ.error_encode(jnp.asarray(e), jcfg)
    te = tQ.error_encode(torch.from_numpy(e), tcfg)
    assert te.dtype == tQ.error_dtype(tcfg)
    if codec == "f8":
        assert np.isfinite(_np(te)).all() and np.abs(_np(te)).max() == 448.0
        assert_f8_close(te, je)
    else:
        np.testing.assert_array_equal(_np(te), _np(je))
    np.testing.assert_array_equal(
        tQ.error_decode(to_torch(np.asarray(je)), tcfg).numpy(),
        np.asarray(jQ.error_decode(je, jcfg)))


CELLS = [("loco", 4), ("loco", 8), ("ef", 4), ("ef", 8),
         ("naive4", 4), ("naive4", 8)]


def _cfgs(strategy, bits, mode="block"):
    kw = dict(bits=bits, mode=mode, error_codec="f8", error_scale=ESCALE,
              scale=2.0**10)
    return (jloco.SyncConfig(strategy=strategy, quant=jQ.QuantConfig(**kw)),
            tloco.SyncConfig(strategy=strategy, quant=tQ.QuantConfig(**kw)))


def _states(strategy, rng, n):
    if strategy == "loco":
        return _f8_state(rng, n)
    if strategy == "ef":
        e = (rng.standard_normal(n) * 1e-3).astype(np.float32)
        j = jnp.asarray(e).astype(jnp.bfloat16)
        return j, to_torch(np.asarray(j))
    return jnp.zeros((1,), jnp.float32), torch.zeros(1)


@pytest.mark.parametrize("strategy,bits", CELLS)
@pytest.mark.parametrize("mode", ["block", "tensor"])
def test_codec_encode_matches_reference(strategy, bits, mode):
    rng = np.random.default_rng(bits + len(strategy) + len(mode))
    n = 8 * 512
    g = _grad(rng, n)
    jcfg, tcfg = _cfgs(strategy, bits, mode)
    js, ts = _states(strategy, rng, n)
    jwire, jnew = jcodec.get_codec(jcfg).encode_ref(jnp.asarray(g), js)
    twire, tnew = tcodec.get_codec(tcfg).encode(torch.from_numpy(g), ts)
    np.testing.assert_array_equal(twire["payload"].numpy(),
                                  np.asarray(jwire["payload"]))
    np.testing.assert_array_equal(twire["scales"].numpy(),
                                  np.asarray(jwire["scales"]))
    if strategy == "loco":
        assert tnew.dtype == torch.float8_e4m3fn
        assert_f8_close(tnew, jnew)
    else:
        np.testing.assert_array_equal(_np(tnew), _np(jnew))


@pytest.mark.parametrize("strategy,bits", CELLS)
@pytest.mark.parametrize("D", [1, 2, 4])
def test_codec_decode_mean_matches_reference(strategy, bits, D):
    rng = np.random.default_rng(100 + D * bits)
    n_chunk = 2 * 512
    jcfg, tcfg = _cfgs(strategy, bits)
    rows = [jcodec.get_codec(_cfgs("naive4", bits)[0]).encode_ref(
        jnp.asarray(_grad(rng, n_chunk)), None)[0] for _ in range(D)]
    jrecv = {k: jnp.stack([r[k] for r in rows]) for k in rows[0]}
    trecv = {k: to_torch(np.asarray(v)) for k, v in jrecv.items()}
    want = np.asarray(jcodec.get_codec(jcfg).decode_mean_ref(jrecv))
    got = tcodec.get_codec(tcfg).decode_mean(trecv).numpy()
    if D <= 2:  # one add and an exact division: no order to differ in
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("strategy", ["fp", "loco", "ef", "naive4"])
def test_sim_sync_matches_reference(strategy):
    rng = np.random.default_rng(5)
    N, n = 2, 2 * 512
    g = np.stack([_grad(rng, n) for _ in range(N)])
    jcfg, tcfg = _cfgs(strategy, 4)
    jst = jloco.sim_init(jcfg, N, n)
    tst = tloco.sim_init(tcfg, N, n)
    for step in (1, 2):
        jg, jst = jloco.sim_sync(jnp.asarray(g), jst, jnp.int32(step), jcfg)
        tg, tst = tloco.sim_sync(torch.from_numpy(g), tst, step, tcfg)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        if strategy == "loco":
            assert_f8_close(tst, jst)
            tst = to_torch(np.asarray(jst))  # continue from the same state
        elif strategy == "ef":
            np.testing.assert_array_equal(_np(tst), _np(jst))


def test_maybe_reset_schedule():
    cfg = tloco.SyncConfig(strategy="loco", reset_every=4)
    s = torch.ones(8).to(torch.float8_e4m3fn)
    for step in range(10):
        want = step > 0 and step % 4 == 0
        out = tloco.maybe_reset(s, step, cfg)
        assert bool((out.float() == 0).all()) == want, step
        ref = jloco.maybe_reset(jnp.ones(8, jnp.float8_e4m3fn), jnp.int32(step),
                                jloco.SyncConfig(strategy="loco", reset_every=4))
        assert bool((np.asarray(ref).astype(np.float32) == 0).all()) == want
    assert not tloco.reset_due(4, tloco.SyncConfig(strategy="naive4",
                                                   reset_every=4))


@pytest.mark.parametrize("kw,msg", [
    (dict(every=0), "must be >= 1"),
    (dict(strategy="naive4", every=2), "stateful codec"),
    (dict(every=3, reset_every=512), "multiple of"),
])
def test_validate_cadence_rejects(kw, msg):
    with pytest.raises(ValueError, match=msg):
        tloco.validate_cadence(tloco.SyncConfig(**kw))


def test_stochastic_rounding_needs_generator():
    cfg = tloco.SyncConfig(strategy="loco",
                           quant=tQ.QuantConfig(stochastic_rounding=True))
    codec = tcodec.get_codec(cfg)
    with pytest.raises(ValueError, match="stochastic_rounding"):
        codec.encode(torch.zeros(512), tloco.init_state(cfg, 512))
    wire, _ = codec.encode(torch.randn(512), tloco.init_state(cfg, 512),
                           torch.Generator().manual_seed(0))
    assert wire["payload"].shape == (256,)


def test_wire_shapes_mirror_reference():
    for strategy, bits in CELLS:
        for mode in ("block", "fixed", "tensor"):
            jcfg, tcfg = _cfgs(strategy, bits, mode)
            js = jcodec.get_codec(jcfg).wire_shapes(4096)
            ts = tcodec.get_codec(tcfg).wire_shapes(4096)
            assert js.keys() == ts.keys()
            for k in js:
                assert (js[k].shape, js[k].comm) == (ts[k].shape, ts[k].comm)
                assert jnp.dtype(js[k].dtype).itemsize == ts[k].dtype.itemsize
