"""The port's FSDP gathers (``autograd.Function``s) on the CPU.

* On a spawned 2-rank gloo group, ``gather_fp``'s gradient is the mean of
  the ranks' gradients (bf16 reduce-scatter), and ``gather_with_sync``'s
  gradient shards and new error states match the reference's
  ``custom_vjp`` gathers under ``shard_map`` at dp=2 on the same inputs.
* On a 1-rank group, the backward updates the compressor state exactly once
  per backward, with and without ``torch.utils.checkpoint`` (whose
  recomputation reruns the gather's forward, not its backward).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P
from torch.utils.checkpoint import checkpoint

from repro.core import hijack as jhijack
from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro_torch.core import codec as tcodec
from repro_torch.core import hijack as thijack
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.launch import mesh as tmesh
from test_torch_codec import assert_f8_close

N, n = 2, 4 * 512
LOCO = dict(strategy="loco")


def _xs(seed=0):
    return np.random.default_rng(seed).standard_normal((N, n)).astype(
        np.float32) * 1e-2


def _w(seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _grad_on_rank(rank, group, sync_cfg):
    """One backward of sum(gather(w) * x_rank): (chunk grad, new state)."""
    x = torch.from_numpy(_xs()[rank])
    c = n // N
    w = torch.from_numpy(_w()[rank * c:(rank + 1) * c]).requires_grad_()
    if sync_cfg is None:
        flat = thijack.gather_fp(w.to(torch.bfloat16), group)
        state = None
    else:
        state = tloco.init_state(sync_cfg, n)
        flat = thijack.gather_with_sync(w.to(torch.bfloat16), state,
                                        sync_cfg, group)
    (flat.float() * x).sum().backward()
    return w.grad.clone(), state


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    group = dist.group.WORLD
    res = {"fp": _grad_on_rank(rank, group, None),
           "loco": _grad_on_rank(rank, group, tloco.SyncConfig(**LOCO))}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port2(tmp_path_factory):
    d = tmp_path_factory.mktemp("hijack")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=N,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(N)]


def _reference(mesh, sync_cfg):
    def body(w, st, x):
        def loss(w, st):
            if sync_cfg is None:
                flat = jhijack.gather_fp(w, ("data",))
            else:
                flat = jhijack.gather_with_sync(w, st.reshape(-1), sync_cfg,
                                                ("data",))
            return jnp.sum(flat.astype(jnp.float32) * x.reshape(-1))
        gw, gs = jax.grad(loss, argnums=(0, 1))(w, st)
        return gw, gs

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(P("data"), P("data"), P("data")),
                               out_specs=(P("data"), P("data")),
                               check_vma=False))
    cfg = sync_cfg or jloco.SyncConfig(strategy="fp")
    st = jnp.stack([jloco.init_state(cfg, n) for _ in range(N)])
    gw, gs = fn(jnp.asarray(_w()).astype(jnp.bfloat16), st,
                jnp.asarray(_xs()))
    return (np.asarray(gw.astype(jnp.float32)).reshape(N, -1),
            np.asarray(gs.astype(jnp.float32)))


def test_gather_fp_grad_is_mean(port2, mesh22):
    want, _ = _reference(mesh22, None)
    xs = _xs()
    mean = (xs.sum(0) / N).reshape(N, -1)
    for rank in range(N):
        got = port2[rank]["fp"][0].numpy()
        np.testing.assert_array_equal(got, want[rank])
        np.testing.assert_allclose(got, mean[rank], rtol=1e-2, atol=1e-4)


def test_gather_with_sync_matches_reference(port2, mesh22):
    jcfg = jloco.SyncConfig(strategy="loco", quant=jQ.QuantConfig())
    want_g, want_s = _reference(mesh22, jcfg)
    for rank in range(N):
        got_g, got_s = port2[rank]["loco"]
        np.testing.assert_array_equal(got_g.numpy(), want_g[rank])
        assert_f8_close(got_s, want_s[rank])
        assert float(got_s.float().abs().max()) > 0


@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield g


@pytest.mark.parametrize("remat", [False, True])
def test_backward_updates_state_once(group1, monkeypatch, remat):
    cfg = tloco.SyncConfig(**LOCO)
    calls = {"fwd": 0, "bwd": 0}
    real_sync, real_gather = thijack.dist_sync, thijack.all_gather_flat

    def counting_sync(*a, **k):
        calls["bwd"] += 1
        return real_sync(*a, **k)

    def counting_gather(*a, **k):
        calls["fwd"] += 1
        return real_gather(*a, **k)

    monkeypatch.setattr(thijack, "dist_sync", counting_sync)
    monkeypatch.setattr(thijack, "all_gather_flat", counting_gather)
    x = torch.from_numpy(_xs()[0])
    w = torch.from_numpy(_w()).requires_grad_()
    state = tloco.init_state(cfg, n)

    def layer(a):
        flat = thijack.gather_with_sync(w.to(torch.bfloat16), state, cfg,
                                        group1)
        return (flat.float() * x * a).sum()

    codec = tcodec.get_codec(cfg)
    g = x.to(torch.bfloat16).float()   # the bf16 cotangent the sync sees
    expect = tloco.init_state(cfg, n)
    for i in range(2):  # the second backward compensates with the first's error
        a = torch.ones(1, requires_grad=True)
        loss = checkpoint(layer, a, use_reentrant=False) if remat else layer(a)
        loss.backward()
        _, expect = codec.encode(g, expect)
        assert torch.equal(state.view(torch.uint8), expect.view(torch.uint8))
        assert calls["bwd"] == i + 1
    assert calls["fwd"] == (4 if remat else 2)  # remat regathers in backward


def test_error_feedback_threads_across_backwards(group1):
    """Port of the reference's ``test_hijack_state_threading``: with an
    identical gradient twice, naive quantization repeats its rounding error
    while LoCo's compensation cancels it (Lemma 2)."""
    qfix = dict(mode="fixed", scale=2.0**10, error_scale=2.0**14)
    cfg = tloco.SyncConfig(strategy="loco", quant=tQ.QuantConfig(**qfix),
                           beta=1.0)
    naive = tloco.SyncConfig(strategy="naive4", quant=tQ.QuantConfig(**qfix))
    x = torch.from_numpy(_xs()[0]) * 0.1
    state = tloco.init_state(cfg, n)

    def grad(c, st):
        w = torch.zeros(n, dtype=torch.bfloat16, requires_grad=True)
        (thijack.gather_with_sync(w, st, c, group1).float() * x).sum().backward()
        return w.grad.float()

    g1, g2 = grad(cfg, state), grad(cfg, state)
    gn = grad(naive, tloco.init_state(naive, n))
    acc_loco = (g1 + g2 - 2 * x).abs().mean()
    acc_naive = (2 * gn - 2 * x).abs().mean()
    assert float(acc_loco) < 0.7 * float(acc_naive)


def test_stochastic_rounding_rejected(group1):
    cfg = tloco.SyncConfig(quant=tQ.QuantConfig(stochastic_rounding=True))
    with pytest.raises(ValueError, match="stochastic_rounding"):
        thijack.gather_with_sync(torch.zeros(512, dtype=torch.bfloat16),
                                 tloco.init_state(cfg, 512), cfg, group1)
