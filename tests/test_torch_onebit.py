"""The onebit gradient wire of the port against the JAX reference (CPU).

Sign packing is bit-exact.  Given the same scale, the plain ``onebit_pack``
equals the Pallas kernel in interpret mode bit for bit (signs and bf16
error), exact and negative zeros included.  The codec computes its scale
as ``mean|h|``, which the two frameworks sum in different orders: the scale
agrees within 1e-6 relative, the signs exactly, and the bf16 error within
one bf16 ulp plus 2e-6 of its largest magnitude (a scale a few f32 ulps
off moves the difference ``h - d`` by that much).  ``sim_sync`` and
``dist_sync`` at dp=2 (gloo, against the reference under ``shard_map``),
two state-evolving rounds: shards within 2e-6 of their largest magnitude
(the mean of two peers' +-scale may nearly cancel), states as above.
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

from repro.core import codec as jcodec
from repro.core import comm as jcomm
from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro.kernels import sign_pack as JSP
from repro_torch.core import codec as tcodec
from repro_torch.core import comm as tcomm
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.interop import to_torch
from repro_torch.kernels import sign_pack as SP
from repro_torch.launch import mesh as tmesh
from test_torch_codec import _np

BF16_ULP = 2.0**-7   # one bf16 ulp is at most 2^-7 of the value it rounds


def _h(seed, n=4 * 512):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    h[::97] = 0.0
    h[1::89] = -0.0
    return h


def assert_bf16_close(got, want):
    """One bf16 ulp of the value, plus 2e-6 of the largest magnitude: where
    h - d nearly cancels, a scale 1e-6 off moves the small result by that
    much before it is rounded."""
    a, b = _np(got), _np(want)
    tol = BF16_ULP * np.maximum(np.abs(a), np.abs(b)) + 2e-6 * np.abs(b).max()
    assert (np.abs(a - b) <= tol).all(), float(np.abs(a - b).max())


def assert_shard_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_unpack_signs_bitexact(seed):
    bits = np.random.default_rng(seed).integers(0, 2, (3, 1024)).astype(np.uint8)
    jp = np.asarray(jQ.pack_signs(jnp.asarray(bits)))
    tp = tQ.pack_signs(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tQ.unpack_signs(torch.from_numpy(tp)).numpy(),
                                  bits)
    assert tQ.SIGN_PACK == jQ.SIGN_PACK == 8


@pytest.mark.parametrize("seed", [0, 1])
def test_onebit_pack_plain_matches_pallas(seed):
    h = _h(seed)
    scale = np.float32(np.abs(h).mean())
    jp, je = JSP.onebit_pack(jnp.asarray(h), jnp.asarray(scale),
                             interpret=True)
    tp, te = SP.onebit_pack(torch.from_numpy(h), torch.tensor(scale))
    assert tp.dtype == torch.uint8 and te.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_np(te), _np(je))
    # an exact or negative zero encodes as bit 0 (-scale): e_new = +scale
    bits = tQ.unpack_signs(tp).numpy()
    assert (bits[h == 0] == 0).all()
    np.testing.assert_array_equal(_np(te)[h == 0],
                                  _np(torch.tensor(scale).to(torch.bfloat16)))


def test_onebit_wrapper_checks_and_counts():
    SP.reset_launches()
    SP.onebit_pack(torch.randn(512), torch.tensor(1.0))
    assert sum(SP.LAUNCHES.values()) == 0        # CPU: plain version
    with pytest.raises(ValueError):
        SP.onebit_pack(torch.randn(256), torch.tensor(1.0))
    with pytest.raises(ValueError):
        SP.onebit_pack(torch.randn(512), torch.ones(2))
    with pytest.raises(ValueError):
        SP.onebit_pack(torch.randn(512, device="meta"),
                       torch.ones((), device="meta"))


def _cfgs():
    return (jloco.SyncConfig(strategy="onebit"),
            tloco.SyncConfig(strategy="onebit"))


@pytest.mark.parametrize("seed", [0, 1])
def test_onebit_codec_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = _h(seed)
    e = (rng.standard_normal(g.shape[0]) * 1e-4).astype(np.float32)
    je_ = jnp.asarray(e).astype(jnp.bfloat16)
    jcfg, tcfg = _cfgs()
    jc, tc = jcodec.get_codec(jcfg), tcodec.get_codec(tcfg)
    jwire, jnew = jc.encode_ref(jnp.asarray(g), je_)
    twire, tnew = tc.encode(torch.from_numpy(g), to_torch(np.asarray(je_)))
    np.testing.assert_array_equal(twire["payload"].numpy(),
                                  np.asarray(jwire["payload"]))
    np.testing.assert_allclose(twire["scales"].numpy(),
                               np.asarray(jwire["scales"]), rtol=1e-6)
    assert tnew.dtype == torch.bfloat16 == tc.state_dtype()
    assert_bf16_close(tnew, jnew)
    ref_wire, _ = tc.encode_ref(torch.from_numpy(g), to_torch(np.asarray(je_)))
    for k in twire:
        assert torch.equal(twire[k], ref_wire[k])
    # decode_mean of the same received rows is exact at D = 2
    recv = {k: jnp.stack([v, v * 0 + v[::-1]]) for k, v in jwire.items()}
    np.testing.assert_array_equal(
        tc.decode_mean({k: to_torch(np.asarray(v)) for k, v in recv.items()})
        .numpy(), np.asarray(jc.decode_mean_ref(recv)))
    js, ts = jc.wire_shapes(4096), tc.wire_shapes(4096)
    assert {k: (v.shape, v.comm) for k, v in js.items()} == \
        {k: (v.shape, v.comm) for k, v in ts.items()}


def test_onebit_sim_sync_matches_reference():
    rng = np.random.default_rng(5)
    N, n = 2, 2 * 512
    g = (rng.standard_normal((N, n)) * 1e-3).astype(np.float32)
    jcfg, tcfg = _cfgs()
    jst, tst = jloco.sim_init(jcfg, N, n), tloco.sim_init(tcfg, N, n)
    for step in (1, 2):
        jg, jst = jloco.sim_sync(jnp.asarray(g), jst, jnp.int32(step), jcfg)
        tg, tst = tloco.sim_sync(torch.from_numpy(g), tst, step, tcfg)
        assert_shard_close(tg, jg)
        assert_bf16_close(tst, jst)
        tst = to_torch(np.asarray(jst))  # continue from the same state


# ---------------------------------------------------------------------------
# dist_sync at dp=2
# ---------------------------------------------------------------------------

N, n = 2, 4 * 512


def _grads():
    g = np.random.default_rng(11).standard_normal((2, N, n)).astype(np.float32)
    g[:, 1] *= 30.0  # one peer's scale far larger
    return g * 1e-3


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, N, rdv)
    group = dist.group.WORLD
    cfg = _cfgs()[1]
    st = tloco.init_state(cfg, n)
    rounds = []
    for g in _grads():
        shard, st = tcomm.dist_sync(torch.from_numpy(g[rank]), st, cfg, group)
        rounds.append((tcomm.all_gather_flat(shard, group), st.clone()))
    torch.save(rounds, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("onebit")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=N,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(N)]


def test_onebit_dist_sync_matches_reference(port, mesh22):
    cfg = _cfgs()[0]

    def body(g, st):
        shard, new = jcomm.dist_sync(g.reshape(-1), st.reshape(-1), cfg,
                                     ("data",))
        return jcomm.all_gather_flat(shard, ("data",)), new[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh22, in_specs=(P("data"),) * 2,
                               out_specs=(P(None), P("data")),
                               check_vma=False))
    st = jnp.stack([jloco.init_state(cfg, n) for _ in range(N)])
    for r, g in enumerate(_grads()):
        full, st = fn(jnp.asarray(g), st)
        for rank in range(N):
            got_full, got_st = port[rank][r]
            assert_shard_close(got_full, full)
            assert got_st.dtype == torch.bfloat16
            assert_bf16_close(got_st, np.asarray(st)[rank])
    assert float(port[0][1][1].float().abs().max()) > 0
