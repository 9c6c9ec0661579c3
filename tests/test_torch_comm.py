"""The port's distributed sync on a 2-rank gloo group against the JAX
reference's ``dist_sync`` under ``shard_map`` at dp=2 (CPU).

Two ranks are spawned once per module; each runs ``dist_sync`` for every
strategy over two rounds whose compressor state evolves, plus the raw
collectives.  The parent runs the reference on the same numpy gradients
(the ``test_dist_matches_simulation`` pattern) and compares: synced shards
bit for bit (the wire is exact and the D=2 mean is one add and an exact
halving; the fp baseline's bf16 reduce-scatter likewise), f8 states within
one f8 quantum on fewer than 5e-3 of the elements.
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

from repro.core import comm as jcomm
from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro_torch.core import codec as tcodec
from repro_torch.core import comm as tcomm
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.launch import mesh as tmesh
from test_torch_codec import _np, assert_f8_close

N, n = 2, 4 * 512
CASES = {
    "fp": dict(strategy="fp"),
    "loco": dict(strategy="loco"),
    "loco8": dict(strategy="loco", bits=8),
    "ef": dict(strategy="ef"),
    "naive4": dict(strategy="naive4"),
    "loco-tensor": dict(strategy="loco", mode="tensor"),   # gather leaf
    "naive4-fixed": dict(strategy="naive4", mode="fixed"),  # static leaf
}


def _cfgs(kw):
    kw = dict(kw)
    strategy = kw.pop("strategy")
    q = dict(bits=kw.get("bits", 4), mode=kw.get("mode", "block"),
             scale=2.0**10)
    return (jloco.SyncConfig(strategy=strategy, quant=jQ.QuantConfig(**q)),
            tloco.SyncConfig(strategy=strategy, quant=tQ.QuantConfig(**q)))


def _grads(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((2, N, n)).astype(np.float32) * 1e-3
    g[:, 1, :256] *= 300.0  # one peer's block far larger: per-node scales
    return g


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    group = dist.group.WORLD
    res = {}
    for name, kw in CASES.items():
        cfg = _cfgs(kw)[1]
        st = tloco.init_state(cfg, n)
        rounds = []
        for r, g in enumerate(_grads(len(name))):
            shard, st = tcomm.dist_sync(torch.from_numpy(g[rank]), st, cfg,
                                        group)
            rounds.append((tcomm.all_gather_flat(shard, group), st.clone()))
        res[name] = rounds
    rows = torch.stack([torch.arange(3, dtype=torch.int32) + 10 * rank
                        + 100 * peer for peer in range(N)])
    res["a2a"] = tcomm.all_to_all_chunks(rows, group)
    x = torch.arange(8, dtype=torch.float32) + rank
    res["psum_scatter"] = tcomm.psum_scatter_flat(x, group)
    res["all_gather"] = tcomm.all_gather_flat(x[:2], group)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("comm")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=N,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(N)]


def _reference(mesh, cfg, g_rounds):
    def body(g, st):
        shard, new = jcomm.dist_sync(g.reshape(-1), st.reshape(-1), cfg,
                                     ("data",))
        return jcomm.all_gather_flat(shard, ("data",)), new[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"),) * 2,
                               out_specs=(P(None), P("data")),
                               check_vma=False))
    st = jnp.stack([jloco.init_state(cfg, n) for _ in range(N)])
    out = []
    for g in g_rounds:
        full, st = fn(jnp.asarray(g), st)
        out.append((np.asarray(full), st))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_dist_sync_matches_reference(port, mesh22, name):
    jcfg, tcfg = _cfgs(CASES[name])
    want = _reference(mesh22, jcfg, _grads(len(name)))
    for r, (full, jst) in enumerate(want):
        for rank in range(N):
            got_full, got_st = port[rank][name][r]
            np.testing.assert_array_equal(got_full.numpy(), full,
                                          err_msg=f"round {r} rank {rank}")
            if not tcfg.needs_state():
                continue
            ref_st = np.asarray(jst)[rank]
            if got_st.dtype == torch.float8_e4m3fn:
                assert_f8_close(got_st, ref_st)
            else:
                np.testing.assert_array_equal(_np(got_st), _np(ref_st))
    # the state evolved: round 2 compensated round 1's error
    if tcfg.needs_state():
        assert float(port[0][name][1][1].float().abs().max()) > 0


def test_collectives_rank_order(port):
    for rank in range(N):
        # row j of what rank receives = peer j's row for rank
        want = torch.stack([torch.arange(3, dtype=torch.int32) + 10 * peer
                            + 100 * rank for peer in range(N)])
        assert torch.equal(port[rank]["a2a"], want)
        total = sum(torch.arange(8, dtype=torch.float32) + r for r in range(N))
        assert torch.equal(port[rank]["psum_scatter"],
                           total[rank * 4:(rank + 1) * 4])
        assert torch.equal(port[rank]["all_gather"],
                           torch.tensor([0.0, 1.0, 1.0, 2.0]))


def test_exchange_wire_packs_leaves_bit_exactly(port):
    """The coalesced exchange moves bytes verbatim: a loco wire decoded by
    the receiver equals the sender's own decode of the same rows."""
    _, tcfg = _cfgs(CASES["loco"])
    g = _grads(len("loco"))[0]
    codec = tcodec.get_codec(tcfg)
    wires = [codec.encode(torch.from_numpy(g[r]), tloco.init_state(tcfg, n))[0]
             for r in range(N)]
    for rank in range(N):
        recv = {k: torch.stack([w[k].reshape(N, -1)[rank] for w in wires])
                for k in wires[0]}
        want = codec.decode_mean(recv)
        got = port[rank]["loco"][0][0][rank * n // N:(rank + 1) * n // N]
        assert torch.equal(got, want)
