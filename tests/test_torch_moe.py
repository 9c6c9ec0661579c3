"""The MoE layer of the port against the JAX reference (CPU, reduced
deepseek-v3-moe: 4 experts, top-2, 2 expert groups with 1 routable, one
shared expert).

``route``: weights within 1e-6 and the same expert sets (``torch.topk`` and
``jax.lax.top_k`` may order ties differently, so sets are compared);
``_dispatch_indices``: equal.  ``moe_block`` (``ep_a2a`` with the ``fp`` and
``block8`` codecs, ``tp_dense``), forward and the gradients of
``sum(y^2) + aux + z`` with respect to the input and every weight:

* in f32, within 1e-4 of the reference's largest magnitude (the fp codec
  and tp_dense: only summation order differs) or 2e-2 (block8: an input
  one ulp off can move an int8 code by one, 1/127 of its block's absmax);
* in bf16 (the training dtype), within 3e-2 of the largest magnitude: a few
  bf16 ulps (2^-8 each) of rounding at other places (matmul outputs, the
  silu, the scatter transposes) plus the block8 code moves above.
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
from repro.models import moe as JMOE
from repro_torch.configs.base import get_arch, reduced
from repro_torch.interop import to_torch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as TMOE

JCFG = jreduced(jget_arch("deepseek-v3-moe"))
TCFG = reduced(get_arch("deepseek-v3-moe"))
B, S = 2, 16


@pytest.fixture(scope="module")
def model_group():
    with tmesh.dp_group(torch.device("cpu")):
        yield tmesh.model_group()


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_route_matches_reference(grouped, seed):
    rng = np.random.default_rng(seed)
    T, d, E, k = 64, 32, 16, 4
    G, gk = (4, 2) if grouped else (1, 0)
    x = rng.standard_normal((T, d)).astype(np.float32)
    wr = rng.standard_normal((d, E)).astype(np.float32) * 0.3
    jv, ji, jaux = JMOE.route(jnp.asarray(x), jnp.asarray(wr), k, E, G, gk)
    tv, ti, taux = TMOE.route(torch.from_numpy(x), torch.from_numpy(wr), k,
                              E, G, gk)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1),
                                  np.sort(np.asarray(ji), 1))
    order_t, order_j = np.argsort(ti.numpy(), 1), np.argsort(np.asarray(ji), 1)
    np.testing.assert_allclose(np.take_along_axis(tv.numpy(), order_t, 1),
                               np.take_along_axis(np.asarray(jv), order_j, 1),
                               rtol=1e-6, atol=1e-6)
    for key in ("aux", "z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6)
    if grouped:  # every token's experts lie in at most gk groups
        assert max(len(set(row)) for row in ti.numpy() // (E // G)) <= gk


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_dispatch_indices_match_reference(cap):
    rng = np.random.default_rng(cap)
    topi = rng.integers(0, 8, (40, 2)).astype(np.int32)
    jslot, jvalid = JMOE._dispatch_indices(jnp.asarray(topi), 8, cap)
    tslot, tvalid = TMOE._dispatch_indices(torch.from_numpy(topi).long(), 8,
                                           cap)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def _params(cfg, seed, dtype):
    rng = np.random.default_rng(seed)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    fs = cfg.n_shared_experts * f
    shapes = {"router": (d, E), "w1": (E, d, f), "w3": (E, d, f),
              "w2": (E, f, d), "ws1": (d, fs), "ws3": (d, fs),
              "ws2": (fs, d)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for k, s in shapes.items()}
    p["router"] *= 4.0  # confident routing: few near-ties
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return {k: np.asarray(jnp.asarray(v).astype(dtype)) for k, v in p.items()}, \
        np.asarray(jnp.asarray(x).astype(dtype))


def _reference(cfg, p, x):
    """(y, [aux, z], grads of sum(y^2) + aux + z w.r.t. x and p) of the JAX
    moe_block under shard_map on a dp=1, tp=1 mesh."""
    mesh = make_local_mesh(dp=1, tp=1)

    def body(x, p):
        def loss(x, p):
            y, aux = JMOE.moe_block(x, p, cfg)
            return (jnp.sum(y.astype(jnp.float32) ** 2) + aux["aux"]
                    + aux["z"]), (y, jnp.stack([aux["aux"], aux["z"]]))
        (_, (y, a)), g = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(x, p)
        return y, a, g

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                              out_specs=P(), check_vma=False))
    y, a, (gx, gp) = f(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    return (_f32(y), _f32(a), {"x": _f32(gx),
                               **{k: _f32(v) for k, v in gp.items()}})


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _port(cfg, p, x, group):
    tx = to_torch(x).requires_grad_()
    tp = {k: to_torch(v).requires_grad_() for k, v in p.items()}
    y, aux = TMOE.moe_block(tx, tp, cfg, group)
    (torch.sum(y.float() ** 2) + aux["aux"] + aux["z"]).backward()
    return (y.detach().float().numpy(),
            np.array([float(aux["aux"].detach()), float(aux["z"].detach())]),
            {"x": tx.grad.float().numpy(),
             **{k: v.grad.float().numpy() for k, v in tp.items()
                if v.grad is not None}})


IMPLS = {"ep-fp": dict(moe_a2a_codec="fp"),
         "ep-block8": dict(moe_a2a_codec="block8"),
         "tp_dense": dict(moe_impl="tp_dense", moe_a2a_codec="fp")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", list(IMPLS))
def test_moe_block_matches_reference(model_group, impl, dtype):
    jcfg = dataclasses.replace(JCFG, **IMPLS[impl])
    tcfg = dataclasses.replace(TCFG, **IMPLS[impl])
    p, x = _params(jcfg, 3, jnp.dtype(dtype))
    y_r, a_r, g_r = _reference(jcfg, p, x)
    y_t, a_t, g_t = _port(tcfg, p, x, model_group)
    tol = (3e-2 if dtype == "bfloat16"
           else 2e-2 if impl == "ep-block8" else 1e-4)
    np.testing.assert_allclose(a_t, a_r, rtol=1e-5)
    errs = {name: float(np.abs(got - want).max() / np.abs(want).max())
            for name, got, want in [("y", y_t, y_r)] + [
                (k, g_t[k], g_r[k]) for k in g_r]}
    print(f"{impl} {dtype}: largest error {max(errs.values()):.3g} "
          f"({max(errs, key=errs.get)}), tolerance {tol}")
    assert max(errs.values()) <= tol, errs
    assert np.isfinite(y_t).all() and all(np.isfinite(g).all()
                                          for g in g_t.values())


def test_block8_stays_near_fp(model_group):
    """block8 against the fp codec inside the port: the reference's own
    parity bound (5% of the output's largest magnitude)."""
    p, x = _params(JCFG, 4, jnp.float32)
    y_fp = _port(dataclasses.replace(TCFG, moe_a2a_codec="fp"), p, x,
                 model_group)[0]
    y_b8 = _port(TCFG, p, x, model_group)[0]
    assert np.abs(y_b8 - y_fp).max() <= 0.05 * np.abs(y_fp).max()
    assert np.abs(y_b8 - y_fp).max() > 0  # the codec really ran


def test_dropped_token_leaves_slots_zero(model_group):
    """A huge token that loses the capacity race adds nothing to the slot
    buffer: every slot no kept token owns is exactly zero, and the block8
    output stays near fp (the scale never saw the dropped token)."""
    d, k, E, cap = 8, 2, 4, 1
    xs = torch.randn(9, d)
    xs[5] *= 1e4
    topi = torch.tensor([[0, 1]] * 9)
    slot, valid = TMOE._dispatch_indices(topi, E, cap)
    assert valid.sum() == 2 and bool(valid[:2].all())   # token 0 keeps both
    buf = TMOE._dispatch(xs, slot, valid, k, E * cap)
    assert torch.equal(buf[:2], xs[0].expand(2, d))
    assert torch.count_nonzero(buf[2:]) == 0

    # routed experts only, every token routed to expert 0 first: with
    # capacity 1 only the earliest token is kept, the huge one is dropped
    b8 = dataclasses.replace(TCFG, n_shared_experts=0)
    p, x = _params(JCFG, 5, jnp.float32)
    x = x[:1, :9].copy()
    x[0, 5] *= 1e4
    p["router"] = np.zeros_like(p["router"])
    p["router"][0, 0] = 10.0
    y_fp = TMOE.moe_block(to_torch(x), {k: to_torch(v) for k, v in p.items()},
                          dataclasses.replace(b8, moe_a2a_codec="fp"),
                          model_group, deterministic_capacity=1)[0]
    y_b8 = TMOE.moe_block(to_torch(x), {k: to_torch(v) for k, v in p.items()},
                          b8, model_group, deterministic_capacity=1)[0]
    kept = float(y_fp.abs().max())
    assert kept > 0  # somebody survived the capacity race
    assert float((y_b8 - y_fp).abs().max()) <= 0.05 * kept


def test_ep_a2a_needs_the_model_group():
    p, x = _params(JCFG, 6, jnp.float32)
    with pytest.raises(ValueError, match="model process group"):
        TMOE.moe_block(to_torch(x), {k: to_torch(v) for k, v in p.items()},
                       TCFG, None)
