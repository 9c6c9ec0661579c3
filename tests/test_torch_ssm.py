"""The port's mamba2 SSD scan and mixer (``repro_torch.models.ssm``) against
the JAX reference (``repro.models.ssm``) on the CPU, on numpy inputs from
a seed.

* the ports of ``tests/test_models.py::test_ssd_chunked_vs_recurrence``
  and ``::test_ssd_state_continuation_matches_decode``: same shapes and
  tolerances (2e-4 absolute), the chunked scan against its own
  recurrence;
* ``ssd_chunked`` against the reference's on the same inputs: within
  1e-5 of the output's largest value (cumsum, exp and the f32 einsums add
  in other orders; the gap measured is 6e-6 of it at T = 512);
* ``_causal_conv`` with and without a cache, f32 and bf16: bit for bit;
* ``softplus`` against ``jax.nn.softplus``: within 3e-7 relative
  forward and 6e-7 backward (the libraries' exp and log1p differ on 8%
  of inputs: 2.6e-7 at most near x = -0.9, and 4.9e-7 in the derivative
  ``exp(x - softplus(x))``; torch's own softplus, ``log1p(exp(x))`` and
  ``x`` above 20, is 2.2e-7 and 6.4e-7 off);
* ``mamba2_mixer`` against the reference's on the same weights: within
  one bf16 ulp of the output's scale (1/128 of its largest value; 4.0e-3
  of it measured, and 57% of the outputs differ: XLA keeps the fused
  bf16 elementwise chains in f32 where torch rounds each op);
* the reference's fault: at T = 128 its gradient in ``dt`` is NaN, where
  a chunk's sums of step sizes overflow ``exp`` above the diagonal; the
  port's is finite and equals the reference's wherever that one is finite
  (within 2e-6 of the gradient's largest value).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.launch.mesh import make_local_mesh
from repro.models import ssm as JS
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT


def _softplus_np(x):
    return np.asarray(jax.nn.softplus(jnp.asarray(x)))


def ssd_inputs(seed, B, T, H, P, N, a_scale=0.5):
    """(X, dt, A, Bm, Cm) f32 numpy: dt = softplus(N(0, 1)), A = -exp(N(0,
    a_scale))."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = _softplus_np(rng.standard_normal((B, T, H)).astype(np.float32))
    A = (-np.exp(rng.standard_normal(H) * a_scale)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return X, dt, A, Bm, Cm


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_ssd_chunked_vs_recurrence():
    X, dt, A, Bm, Cm = _t(ssd_inputs(0, 2, 48, 3, 8, 16))
    Y1, S1 = TS.ssd_chunked(X, dt, A, Bm, Cm)
    Y2, S2 = TS.ssd_reference(X, dt, A, Bm, Cm)
    np.testing.assert_allclose(Y1.numpy(), Y2.numpy(), atol=2e-4)
    np.testing.assert_allclose(S1.numpy(), S2.numpy(), atol=2e-4)


@pytest.mark.parametrize("T", [512, 1100])
def test_ssd_chunked_is_the_recurrence_in_f64(T):
    """In f64 the chunked scan is the sequential recurrence to 1e-12 of
    the output's largest value, over 2 chunks of 256 and over 275 chunks
    of 4: the chunking changes only the rounding."""
    X, dt, A, Bm, Cm = (a.double() for a in _t(ssd_inputs(T, 2, T, 3, 8,
                                                          16)))
    Y1, S1 = TS.ssd_chunked(X, dt, A, Bm, Cm)
    Y2, S2 = TS.ssd_reference(X, dt, A, Bm, Cm)
    assert TS.chunk_len(T) == {512: 256, 1100: 4}[T]
    assert (Y1 - Y2).abs().max() <= 1e-12 * Y2.abs().max()
    assert (S1 - S2).abs().max() <= 1e-12 * S2.abs().max()


def test_ssd_state_continuation_matches_decode():
    """prefill state + ssd_step == longer prefill (cache correctness)."""
    X, dt, A, Bm, Cm = _t(ssd_inputs(1, 1, 33, 2, 4, 8, a_scale=1.0))
    Yf, Sf = TS.ssd_chunked(X, dt, A, Bm, Cm)
    _, Sp = TS.ssd_chunked(X[:, :-1], dt[:, :-1], A, Bm[:, :-1], Cm[:, :-1])
    y_last, S_step = TS.ssd_step(Sp, X[:, -1], dt[:, -1], A, Bm[:, -1],
                                 Cm[:, -1])
    np.testing.assert_allclose(y_last.numpy(), Yf[:, -1].numpy(), atol=2e-4)
    np.testing.assert_allclose(S_step.numpy(), Sf.numpy(), atol=2e-4)


@pytest.mark.parametrize("T,group", [
    (48, None), (256, None), (512, None), (1100, None),
    (1024, 1), (1024, 3), (1536, 4), (768, 2)],
    ids=["48", "256", "512", "1100", "1024-group1", "1024-group3",
         "1536-group4", "768-group2"])
def test_ssd_chunked_matches_reference(T, group, monkeypatch):
    """One chunk (48), one full chunk (256), two chunks and the
    inter-chunk recurrence (512), and 1,100 steps, which the halving rule
    cuts into 275 chunks of 4 (a 1,100-token prefill's scan), with and
    without an initial state.  With ``group`` (``ssm.GROUP``) the scan
    runs over groups of that many chunks of 256 (the last one short on
    1,024 steps in groups of 3 and 1,536 in groups of 4), each from the
    state the one before it left: bit for bit the whole form (all chunks
    in one group)."""
    a = ssd_inputs(T, 2, T, 3, 8, 16)
    rng = np.random.default_rng(T + 1)
    S0 = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
    for init in (None, S0):
        Yj, Sj = JS.ssd_chunked(*map(jnp.asarray, a), init_state=(
            None if init is None else jnp.asarray(init)))
        init_t = None if init is None else torch.from_numpy(init)
        if group is not None:
            monkeypatch.setattr(TS, "GROUP", group)
        Yt, St = TS.ssd_chunked(*_t(a), init_state=init_t)
        Yj, Sj = np.asarray(Yj), np.asarray(Sj)
        assert np.abs(Yt.numpy() - Yj).max() <= 1e-5 * np.abs(Yj).max()
        assert np.abs(St.numpy() - Sj).max() <= 1e-5 * np.abs(Sj).max()
        if group is not None:
            monkeypatch.setattr(TS, "GROUP", T)       # one group
            Yw, Sw = TS.ssd_chunked(*_t(a), init_state=init_t)
            assert T > group * TS.CHUNK
            assert torch.equal(Yt, Yw) and torch.equal(St, Sw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_matches_reference(dtype, cached):
    rng = np.random.default_rng(3)
    x, w, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 9, 5), (4, 5), (2, 3, 5)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    yj, ccj = JS._causal_conv(*(jnp.asarray(v).astype(jd) for v in (x, w)),
                              jnp.asarray(c).astype(jd) if cached else None)
    yt, cct = TS._causal_conv(*(torch.from_numpy(v).to(td) for v in (x, w)),
                              torch.from_numpy(c).to(td) if cached else None)
    assert np.array_equal(np.asarray(yj, np.float32), yt.float().numpy())
    assert np.array_equal(np.asarray(ccj, np.float32), cct.float().numpy())
    # the new cache is the last K - 1 inputs: a continuation sees them
    assert torch.equal(cct, torch.from_numpy(x).to(td)[:, -3:])


def test_mamba_conv_caches_own_their_storage():
    """A mamba layer's three conv caches after a 64-token prompt and after
    one decode step are (B, K-1, ch) bf16 tensors that own B (K-1) ch
    elements of storage: the contexts, not views into the conv's whole
    (B, K-1 + T, ch) input, which a cache kept alive through the prefill
    and every decode step after it."""
    cfg = dataclasses.replace(reduced(get_arch("mamba2-2.7b")), d_model=64)
    p = {k: torch.from_numpy(v).bfloat16()
         for k, v in _mixer_params(cfg, 9).items()}
    p["normm"] = torch.ones(64, dtype=torch.bfloat16)
    Bb, K = 2, cfg.d_conv
    cache = TT.init_decode_state(cfg, 1, Bb, 65, "cpu").mamba[0]
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (Bb, 65, 64)).astype(np.float32)).bfloat16()
    for T, single in ((64, False), (1, True)):
        with torch.inference_mode():
            TT.mamba_layer(p, x[:, :T] if not single else x[:, 64:], cfg,
                           cache=cache, single_step=single)
        for c, ch in zip(cache.conv, (cfg.d_inner, cfg.ssm_state,
                                      cfg.ssm_state)):
            assert c.shape == (Bb, K - 1, ch) and c.dtype == torch.bfloat16
            assert c.untyped_storage().nbytes() == Bb * (K - 1) * ch * 2


def test_mixer_prefill_continues_a_filled_cache():
    """A prompt's mixer in two calls, the second from the conv contexts and
    SSD state the first left, is the one call over the whole prompt (f32:
    within 1e-5 of the output's largest value; the two calls chunk it
    otherwise), its contexts bit for bit."""
    cfg = dataclasses.replace(reduced(get_arch("mamba2-2.7b")), d_model=64)
    p = {k: torch.from_numpy(v) for k, v in _mixer_params(cfg, 11).items()}
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 96, 64)).astype(np.float32))
    y, (cc, S) = TS.mamba2_mixer(x, p, cfg)
    y1, (cc1, S1) = TS.mamba2_mixer(x[:, :64], p, cfg)
    y2, (cc2, S2) = TS.mamba2_mixer(x[:, 64:], p, cfg, conv_cache=cc1,
                                    ssm_state=S1)
    got = torch.cat([y1, y2], 1)
    assert (got - y).abs().max() <= 1e-5 * y.abs().max()
    assert (S2 - S).abs().max() <= 1e-5 * S.abs().max()
    assert all(torch.equal(a, b) for a, b in zip(cc2, cc))


def test_softplus_matches_jax():
    x = (np.random.default_rng(4).standard_normal(1 << 18) * 8).astype(
        np.float32)
    x[:4] = (0.0, 25.0, -25.0, 90.0)
    want = _softplus_np(x)
    xt = torch.from_numpy(x).requires_grad_()
    got = TS.softplus(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=3e-7)
    gw = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(
        jnp.asarray(x)))
    got.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gw, rtol=6e-7)


def _mixer_params(cfg, seed):
    """Random local params of one mamba2 mixer (tp = 1), f32 numpy, in
    the reference's names (``normg`` included)."""
    rng = np.random.default_rng(seed)
    d, dil, N, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.d_conv)
    shapes = {"w_z": (d, dil), "w_x": (d, dil), "w_B": (d, N),
              "w_C": (d, N), "w_dt": (d, H), "conv_x": (K, dil),
              "conv_B": (K, N), "conv_C": (K, N), "w_out": (dil, d)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    p.update(dt_bias=(rng.standard_normal(H) * 0.5).astype(np.float32),
             A_log=(rng.standard_normal(H) * 0.5).astype(np.float32),
             D=np.ones(H, np.float32),
             normg=(1 + 0.1 * rng.standard_normal(dil)).astype(np.float32))
    return p


@pytest.mark.parametrize("T", [32, 256])
def test_mamba2_mixer_matches_reference(T):
    """The mixer on bf16 weights and activations: projections, the
    conv, softplus, the scan, the gated per-head norm, the output
    projection.  T = 256: one full chunk at the reduced widths."""
    jcfg = dataclasses.replace(jreduced(jget_arch("mamba2-2.7b")),
                               d_model=64)
    tcfg = dataclasses.replace(reduced(get_arch("mamba2-2.7b")), d_model=64)
    p = _mixer_params(tcfg, 5)
    x = np.random.default_rng(6).standard_normal((2, T, 64)).astype(
        np.float32)
    yj, (ccj, Sj) = jax.jit(jax.shard_map(
        lambda x, p: JS.mamba2_mixer(x, p, jcfg),
        mesh=make_local_mesh(dp=1, tp=1), in_specs=(P(), P()),
        out_specs=P(), check_vma=False))(
        jnp.asarray(x).astype(jnp.bfloat16),
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()})
    yt, (cct, St) = TS.mamba2_mixer(
        torch.from_numpy(x).bfloat16(),
        {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}, tcfg)
    yj = np.asarray(yj, np.float32)
    assert yt.dtype == torch.bfloat16 and yt.shape == (2, T, 64)
    assert np.abs(yt.float().numpy() - yj).max() <= np.abs(yj).max() / 128
    Sj = np.asarray(Sj)
    assert np.abs(St.numpy() - Sj).max() <= np.abs(Sj).max() / 128
    for a, b in zip(ccj, cct):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_reference_ssd_grad_nan_fault():
    """At T = 128 (one chunk) with dt = softplus(N(0, 1)): head 0 (A = -1)
    sums its step sizes past exp's range above the diagonal, and the
    reference's gradient in dt is NaN there; head 1 (A = -0.05) stays in
    range.  The port masks before the exp: its gradient is finite, and
    the reference's wherever that one is finite."""
    X, dt, _, Bm, Cm = ssd_inputs(7, 1, 128, 2, 4, 8)
    A = np.array([-1.0, -0.05], np.float32)
    W = np.random.default_rng(8).standard_normal(X.shape).astype(np.float32)

    def jloss(dt_):
        Y, _ = JS.ssd_chunked(jnp.asarray(X), dt_, jnp.asarray(A),
                              jnp.asarray(Bm), jnp.asarray(Cm))
        return jnp.sum(Y * W)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(dt)))
    dtt = torch.from_numpy(dt.copy()).requires_grad_()
    Y, _ = TS.ssd_chunked(*_t((X,)), dtt, *_t((A, Bm, Cm)))
    (Y * torch.from_numpy(W)).sum().backward()
    gt = dtt.grad.numpy()
    finite = np.isfinite(gj)
    assert np.isnan(gj[..., 0]).all() and finite[..., 1].all()
    assert np.isfinite(gt).all()
    gap = np.abs(gt[finite] - gj[finite]).max()
    assert gap <= 2e-6 * np.abs(gj[finite]).max(), gap
    # and the forward is the reference's
    Yj, _ = JS.ssd_chunked(*map(jnp.asarray, (X, dt, A, Bm, Cm)))
    assert np.abs(Y.detach().numpy() - np.asarray(Yj)).max() <= \
        1e-5 * np.abs(np.asarray(Yj)).max()
