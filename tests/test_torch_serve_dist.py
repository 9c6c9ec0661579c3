"""Serving at dp 2 x tp 2 (the reference's ``mesh22``) on one spawned
4-rank gloo group, against the JAX reference under ``shard_map`` (CPU).

Three configs, each a prompt then one teacher-forced decode step, the
cache sized to the prompt and the step, one row per data rank:

* ``CP_CFG`` of ``tests/test_decode_consistency.py``: one kv head under
  tp 2, so the cache is context-parallel (``build_cp_cache``,
  ``cp_append``, ``cp_decode_attention``'s max and sums over the model
  group); the reference test's bounds against the port's own forward
  (atol 1e-1, > 99% argmax agreement);
* ``SWA_CFG``: a window of 8 under a prompt of 20, the ring wrapped
  (atol 3e-2 against the forward);
* reduced mamba2-2.7b, its SSD heads sharded over the model group (atol
  5e-2 against the forward).

On every config the decode logits are the reference decode's within
XREF_ATOL (tests/test_torch_decode.py), and the greedy tokens of the
vocab-parallel argmax (``steps.greedy``: each rank's max and first
argmax, a max and a min over the model group) are the reference's.
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

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core.flatparam import MeshTopo as JTopo
from repro.core.flatparam import ServeStore as JStore
from repro.core.flatparam import init_serve_params_local, serve_param_specs
from repro.launch.steps import build_model as jbuild_model
from repro.models import transformer as JTF
from repro_torch import interop
from repro_torch.configs.base import ArchConfig, get_arch, reduced
from repro_torch.core import flatparam as FP
from repro_torch.core.flatparam import MeshTopo
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from test_torch_decode import ARCH_ATOL, SWA_ATOL, XREF_ATOL

DP, TP, B = 2, 2, 2
_CP = dict(name="cp-test", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=1, d_ff=128, vocab=128, source="test")
_SWA = dict(_CP, name="swa-test", n_kv_heads=2, attn_kind="swa", window=8)
CASES = {  # name: (reference cfg, port cfg, prompt, atol vs the forward)
    "cp": (JArch(**_CP), ArchConfig(**_CP), 12, 1e-1),
    "swa": (JArch(**_SWA), ArchConfig(**_SWA), 20, SWA_ATOL),
    "mamba2": (jreduced(jget_arch("mamba2-2.7b")),
               reduced(get_arch("mamba2-2.7b")), 12, ARCH_ATOL),
}


def _ref_setup(jcfg, mesh):
    topo = JTopo.from_mesh(mesh)
    model = jbuild_model(jcfg, TP)
    groups = model.groups()
    pspecs = serve_param_specs(groups, topo)
    params = jax.jit(jax.shard_map(
        lambda k: init_serve_params_local(groups, k, topo), mesh=mesh,
        in_specs=(P(),), out_specs=pspecs, check_vma=False))(
            jax.random.PRNGKey(0))
    return topo, model, groups, pspecs, params


def _reference(jcfg, S: int, tokens, mesh):
    """Under shard_map: the forward's last logits, the decode's and its
    greedy tokens, the reference's sample (``make_decode_step``'s
    pmax/pmin)."""
    topo, model, groups, pspecs, params = _ref_setup(jcfg, mesh)

    def body(params, tokens):
        store = JStore(groups, params, topo)
        full, _, _ = model.forward(store, tokens, remat=False)
        st = JTF.init_decode_state(jcfg, TP, tokens.shape[0], S + 1)
        _, _, st = model.forward(store, tokens[:, :S], caches=st,
                                 remat=False)
        logits, _ = model.decode_step(store, st, tokens[:, S:])
        vl = logits.shape[-1]
        col0 = jax.lax.axis_index("model") * vl
        local_max = jnp.max(logits, axis=-1)
        local_arg = jnp.argmax(logits, axis=-1) + col0
        gmax = jax.lax.pmax(local_max, "model")
        cand = jnp.where(local_max >= gmax, local_arg, jnp.int32(2**30))
        tok = jax.lax.pmin(cand, "model").astype(jnp.int32)
        return full[:, -1], logits[:, 0], tok[:, 0]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(pspecs, P("data")),
        out_specs=(P("data", "model"), P("data", "model"), P("data")),
        check_vma=False))
    return [np.asarray(a, np.float32)
            for a in fn(params, jnp.asarray(tokens, jnp.int32))]


def _worker(rank, rdv, out_dir, hosts):
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    tmesh.init_file_group(cpu, rank, DP * TP, rdv)
    topo = MeshTopo.from_group(*tmesh.mesh_groups(TP))
    res = {"where": (topo.rank, topo.tp_rank)}
    for name, (params, tokens) in hosts.items():
        cfg, S = CASES[name][1], CASES[name][2]
        groups = tsteps.model_groups(cfg, TP)
        mine = interop.serve_from_reference(params, groups=groups,
                                            tp_rank=topo.tp_rank)
        tok = torch.from_numpy(tokens)
        prefill = tsteps.make_prefill_step(cfg, topo, cpu, batch=B,
                                           window=S + 1)
        decode = tsteps.make_decode_step(cfg, topo, cpu)
        _, state = prefill(mine, {"tokens": tok[:, :S]})
        rows = tsteps.serve_rows(B, topo)
        nxt, logits, state = decode(mine, state, tok[rows, S:])
        model = tsteps.build_model(cfg, TP, model_group=topo.model)
        with torch.inference_mode():
            full, _ = model.forward(FP.ServeStore(groups, mine), tok[rows],
                                    remat=False)
        res[name] = (full[:, -1].float().numpy(), logits.float().numpy(),
                     nxt.numpy(), state.kv[0].window if state.kv else None)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _assemble(ranks, name, k):
    """Item ``k`` of every rank's result for ``name`` as the global
    (rows, vocab) array: data ranks stacked, model ranks' shards side by
    side."""
    by = {r["where"]: r[name][k] for r in ranks}
    return np.concatenate([np.concatenate([by[(d, m)] for m in range(TP)],
                                          axis=-1) for d in range(DP)])


@pytest.fixture(scope="module")
def results(tmp_path_factory, mesh22):
    """The reference's weights (numpy) and tokens (B, S + 1) per case go
    to the ranks, which serve while the reference runs here."""
    d = tmp_path_factory.mktemp("serve_dist")
    rng = np.random.default_rng(3)
    hosts = {name: (jax.tree.map(np.asarray, _ref_setup(c[0], mesh22)[-1]),
                    rng.integers(0, c[0].vocab, (B, c[2] + 1)))
             for name, c in CASES.items()}
    ctx = tmp.start_processes(_worker, args=(str(d / "rdv"), str(d), hosts),
                              nprocs=DP * TP, join=False,
                              start_method="spawn")
    ref = {name: _reference(c[0], c[2], hosts[name][1], mesh22)
           for name, c in CASES.items()}
    while not ctx.join():
        pass
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(DP * TP)]
    return ref, ranks


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_forward_and_reference(results, name):
    ref, ranks = results
    r_dec = ref[name][1]
    full = _assemble(ranks, name, 0)
    dec = _assemble(ranks, name, 1)
    atol = CASES[name][3]
    np.testing.assert_allclose(dec, full, atol=atol)
    if name == "cp":
        assert (dec.argmax(-1) == full.argmax(-1)).mean() > 0.99
        # each model rank keeps half the window's slots
        assert {r[name][3] for r in ranks} == {(CASES[name][2] + 2) // 2}
    np.testing.assert_allclose(dec, r_dec, atol=XREF_ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_tokens_are_the_references(results, name):
    """Every model rank of a data rank samples the same token, and the
    tokens are the reference's pmax/pmin sample of its own logits."""
    ref, ranks = results
    by = {r["where"]: r[name][2] for r in ranks}
    for d in range(DP):
        assert all(np.array_equal(by[(d, m)], by[(d, 0)])
                   for m in range(TP))
    got = np.concatenate([by[(d, 0)] for d in range(DP)])[:, 0]
    np.testing.assert_array_equal(got, ref[name][2].astype(np.int64))
