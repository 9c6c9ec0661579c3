"""The port's optimizers, schedules and optimizer rule against the JAX
reference (CPU, numpy inputs from a seed).

Each optimizer gets the same ``(L, chunk)`` stacked leaf and 1-D leaf, the
same gradients and the same weight-decay mask, and takes 3 steps on both
sides; parameters and states agree within rtol 1e-6 / atol 1e-7 (``sgd``
bit for bit: it only multiplies and adds).  The schedules agree at every
step of a 20-step run; ``steps._make_opt`` maps names and passes the
weight decay as the reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.optim import optimizers as JOPT
from repro.optim.schedules import make_schedule as jsched
from repro_torch.launch import steps as tsteps
from repro_torch.optim import optimizers as TOPT
from repro_torch.optim.schedules import make_schedule as tsched

RTOL, ATOL = 1e-6, 1e-7
CASES = {
    "sgd": {},
    "sgd_momentum": dict(momentum=0.9),
    "sgd_decay": dict(momentum=0.9, weight_decay=0.1),
    "lamb": {},
    "adafactor": {},
    "adafactor_decay": dict(weight_decay=0.01),
    "adafactor_flat": {},
    "adafactor_flat_decay": dict(weight_decay=0.01),
    "adam": dict(weight_decay=0.1),
    "adamw": {},
}


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs():
    """A stacked ``(L, chunk)`` leaf, a 1-D leaf and one of the other
    group, 3 steps of gradients and a mask that decays two of them."""
    rng = np.random.default_rng(17)
    p = {"block": {"w": _f32(rng, 3, 512, scale=0.02),
                   "norm": _f32(rng, 256)},
         "embed": {"tok": _f32(rng, 1024, scale=0.02)}}
    grads = [{g: {k: _f32(rng, *v.shape, scale=0.1) for k, v in sub.items()}
              for g, sub in p.items()} for _ in range(3)]
    mask = {"block": {"w": 1.0, "norm": 0.0}, "embed": {"tok": 1.0}}
    return p, grads, mask


def _run_both(name, kw):
    base = name.split("_decay")[0].replace("sgd_momentum", "sgd")
    p, grads, mask = _inputs()
    jopt, topt = JOPT.OPTIMIZERS[base](**kw), TOPT.OPTIMIZERS[base](**kw)
    jp = jax.tree.map(jnp.asarray, p)
    tp = TOPT.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    jmask = jax.tree.map(jnp.float32, mask)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.int32(step), jnp.float32(1e-2), jmask)
        tp, ts = topt.update(TOPT.tree_map(torch.from_numpy, g), ts, tp,
                             torch.tensor(step), torch.tensor(1e-2), mask)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_reference(name):
    (jp, js), (tp, ts) = _run_both(name, CASES[name])
    exact = name.startswith("sgd")
    for g in jp:
        for k in jp[g]:
            want = np.asarray(jp[g][k])
            got = tp[g][k].numpy()
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=f"{g}/{k}")
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{g}/{k}")
    jl = jax.tree.leaves(js)
    tl = [t for t in _state_leaves(ts)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


def _state_leaves(state):
    """Leaves of a port optimizer state in ``jax.tree.leaves`` order
    (sorted dict keys, tuples in order)."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _state_leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _state_leaves(s)]
    return [state]


@pytest.mark.parametrize("name,n_state", [("sgd", 0), ("adafactor_flat", 1),
                                          ("lamb", 2), ("adam", 2)])
def test_state_arity(name, n_state):
    p, _, _ = _inputs()
    st = TOPT.OPTIMIZERS[name]().init(TOPT.tree_map(torch.from_numpy, p))
    assert len(st) == n_state


def test_lamb_trust_ratio_is_per_stacked_leaf():
    """The trust ratio is taken over the whole ``(L, chunk)`` leaf, as the
    reference takes it: scaling one layer's row moves the other rows'
    update (a per-layer ratio would leave them alone)."""
    p, grads, mask = _inputs()
    opt = TOPT.lamb()

    def step(params):
        tp = TOPT.tree_map(torch.from_numpy, params)
        new, _ = opt.update(TOPT.tree_map(torch.from_numpy, grads[0]),
                            opt.init(tp), tp, torch.tensor(0),
                            torch.tensor(1e-2), mask)
        return (new["block"]["w"] - tp["block"]["w"]).numpy()

    base = step(p)
    p2 = {g: dict(sub) for g, sub in p.items()}
    p2["block"]["w"] = p["block"]["w"].copy()
    p2["block"]["w"][0] *= 4.0
    moved = step(p2)
    assert not np.allclose(moved[1:], base[1:], rtol=1e-3)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_every_step(name):
    j, t = jsched(name, 1e-3, 20, 3), tsched(name, 1e-3, 20, 3)
    for step in range(20):
        np.testing.assert_allclose(float(t(step)), float(j(jnp.int32(step))),
                                   rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "lamb",
                                  "adafactor", "adafactor_flat"])
def test_make_opt_rule_matches_reference(name):
    """``adafactor`` runs as ``adafactor_flat``; only adam, adamw and lamb
    get the run's weight decay (sgd and adafactor none)."""
    p, grads, mask = _inputs()
    jrun = jsteps.RunConfig(optimizer=name, weight_decay=0.3)
    trun = tsteps.RunConfig(optimizer=name, weight_decay=0.3)
    jopt, topt = jsteps._make_opt(jrun), tsteps._make_opt(trun)
    jp = jax.tree.map(jnp.asarray, p)
    tp = TOPT.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    assert len(js) == len(ts)
    jmask = jax.tree.map(jnp.float32, mask)
    for step in range(2):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads[step]), js, jp,
                             jnp.int32(step), jnp.float32(1e-2), jmask)
        tp, ts = topt.update(TOPT.tree_map(torch.from_numpy, grads[step]),
                             ts, tp, torch.tensor(step), torch.tensor(1e-2),
                             mask)
    for g in jp:
        for k in jp[g]:
            np.testing.assert_allclose(tp[g][k].numpy(), np.asarray(jp[g][k]),
                                       rtol=RTOL, atol=ATOL)
