"""The MoE activation wire of the port against the JAX reference (CPU).

On CPU tensors ``act_encode``/``act_decode`` run their plain versions,
which must equal the Pallas kernels in interpret mode and the reference's
``act_comm.quant_rows``/``dequant_rows`` bit for bit, also on all-zero rows,
rows with a value near the f32 maximum and denormals.  The packed send
buffer of ``_encode`` must equal the reference's byte for byte, and the
exchange over a 2-rank gloo ``model`` group must equal the reference's on
``mesh22``'s model axis, forward and cotangent, bit for bit (the wire is
exact: the same codes and scales cross it).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import act_comm as JACT
from repro.kernels import act_quant as JAQ
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import act_comm as TACT
from repro_torch.interop import to_torch
from repro_torch.kernels import act_quant as AQ
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as TTF

BLK = 512


def _rows(seed, rows=24):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, BLK)).astype(np.float32)
    h *= (10.0 ** rng.uniform(-6, 3, rows)).astype(np.float32)[:, None]
    h[1] = 0.0                                   # dead slot
    h[2, 17] = 3.0e38                            # near the f32 maximum
    h[3] = rng.standard_normal(BLK).astype(np.float32) * 1e-39  # denormals
    h[4, :7] = [0.0, -0.0, 0.5, -0.5, 1.5, 2.5, -2.5]           # ties
    h[4] *= 127.0 / 2.5
    return h


@pytest.mark.parametrize("seed", [0, 1])
def test_act_encode_decode_plain_match_pallas(seed):
    h = _rows(seed)
    tq, ts = AQ.act_encode(torch.from_numpy(h))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    for jq, js in (JAQ.act_encode(jnp.asarray(h), interpret=True),
                   JACT.quant_rows(jnp.asarray(h))):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq[1] == 0).all() and (tq[3] == 0).all()
    td = AQ.act_decode(tq, ts).numpy()
    for jd in (JAQ.act_decode(jnp.asarray(tq.numpy()), jnp.asarray(ts.numpy()),
                              interpret=True),
               JACT.dequant_rows(jnp.asarray(tq.numpy()),
                                 jnp.asarray(ts.numpy()))):
        np.testing.assert_array_equal(td, np.asarray(jd))
    assert (td[1] == 0).all() and np.isfinite(td).all()
    assert TACT.ACT_BLOCK == JACT.ACT_BLOCK and TACT.QMAX == JACT.QMAX


def test_cpu_tensors_never_count_launches():
    AQ.reset_launches()
    q, s = AQ.act_encode(torch.randn(4, BLK))
    AQ.act_decode(q, s)
    assert sum(AQ.LAUNCHES.values()) == 0


@pytest.mark.parametrize("case", ["width", "dtype", "scale", "device", "empty"])
def test_wrappers_reject_bad_inputs(case):
    with pytest.raises(ValueError):
        if case == "width":
            AQ.act_encode(torch.zeros(4, 256))
        elif case == "dtype":
            AQ.act_encode(torch.zeros(4, BLK, dtype=torch.bfloat16))
        elif case == "scale":
            AQ.act_decode(torch.zeros(4, BLK, dtype=torch.int8), torch.ones(3))
        elif case == "device":
            AQ.act_encode(torch.zeros(4, BLK, device="meta"))
        else:
            AQ.act_encode(torch.zeros(0, BLK))


@pytest.mark.parametrize("shape4", [(1, 2, 3, 40), (2, 2, 3, 40),
                                    (1, 4, 8, 128)])
def test_encode_bytes_match_reference(shape4):
    tp = shape4[0]
    n_pp = int(np.prod(shape4[1:]))
    n_pad = -(-n_pp // BLK) * BLK
    x = np.random.default_rng(n_pp).standard_normal(shape4).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(JACT._encode(jx, n_pp, n_pad, tp))
    tx = to_torch(np.asarray(jx))
    got = TACT._encode(tx, n_pp, n_pad, tp)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == TACT.wire_row_bytes(n_pp) == JACT.wire_row_bytes(n_pp)
    dec = TACT._decode(got, n_pp, n_pad, tp, shape4, torch.bfloat16)
    jdec = JACT._decode(jnp.asarray(want), n_pp, n_pad, tp, shape4,
                        jnp.bfloat16)
    np.testing.assert_array_equal(dec.float().numpy(),
                                  np.asarray(jdec).astype(np.float32))


@pytest.mark.parametrize("arch", ["deepseek-v3-moe"])
@pytest.mark.parametrize("red", [False, True])
def test_a2a_geometry_matches_reference(arch, red):
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    if red:
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for n_tokens in (64, 4096, 4097):
        for tp in (1, 2, 4):
            assert TACT.a2a_geometry(tcfg, n_tokens, tp) == \
                JACT.a2a_geometry(jcfg, n_tokens, tp)
    if not red:  # the exchange chip_smoke.py times: 81,920 rows of 512
        g = TACT.a2a_geometry(tcfg, 4096, 1)
        assert (g["cap"], g["n_pad"] // BLK) == (640, 81920)


def test_block8_ef_is_refused():
    # the one check, made when the model is built (check_supported): a
    # codec the reference does not have is refused; block8+ef, ported
    # since, builds (tests/test_torch_act_comm_ef.py trains it)
    base = reduced(get_arch("deepseek-v3-moe"))
    cfg = dataclasses.replace(base, moe_a2a_codec="int4")
    with pytest.raises(NotImplementedError, match="moe_a2a_codec.*ROADMAP"):
        TTF.build_groups(cfg, 1)
    ef = dataclasses.replace(base, moe_a2a_codec="block8+ef")
    assert TTF.build_groups(ef, 1) == TTF.build_groups(base, 1)
    assert TACT.MOE_A2A_CODECS == JACT.MOE_A2A_CODECS


# ---------------------------------------------------------------------------
# the exchange over a 2-rank model group against mesh22's model axis
# ---------------------------------------------------------------------------

TP, EL, CAP, D = 2, 2, 3, 40           # n_pp = 240 < 512: the pad path


def _xw():
    rs = np.random.default_rng(7)
    X = rs.standard_normal((TP, TP, EL, CAP, D)).astype(np.float32)
    W = rs.standard_normal((TP, TP, EL, CAP, D)).astype(np.float32)
    return X, W


def _worker(rank, rdv, out_dir):
    torch.set_num_threads(1)
    tmesh.init_file_group(torch.device("cpu"), rank, TP, rdv)
    group = dist.group.WORLD  # the two ranks are one model axis of size TP
    X, W = _xw()
    x = torch.from_numpy(X[rank]).requires_grad_()
    y = TACT.a2a_exchange(x, group)
    (y * torch.from_numpy(W[rank])).sum().backward()
    raw = TACT.a2a_raw(torch.from_numpy(X[rank]), group)
    torch.save({"y": y.detach(), "g": x.grad, "raw": raw},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("act")
    tmp.start_processes(_worker, args=(str(d / "rdv"), str(d)), nprocs=TP,
                        start_method="spawn")
    return [torch.load(d / f"rank{r}.pt") for r in range(TP)]


def test_a2a_exchange_matches_reference(port, mesh22):
    X, W = _xw()

    def body(x, w):
        y = JACT.a2a_exchange(x[0], "model")

        def loss(xr):
            return jnp.sum(JACT.a2a_exchange(xr, "model") * w[0])
        return y[None], jax.grad(loss)(x[0])[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh22,
                              in_specs=(P("model"), P("model")),
                              out_specs=(P("model"), P("model")),
                              check_vma=False))
    y, g = (np.asarray(a) for a in f(jnp.asarray(X), jnp.asarray(W)))
    for r in range(TP):
        np.testing.assert_array_equal(port[r]["y"].numpy(), y[r])
        np.testing.assert_array_equal(port[r]["g"].numpy(), g[r])
        # the raw exchange is the permutation: row j of rank r is what
        # rank j sent to r
        for j in range(TP):
            np.testing.assert_array_equal(port[r]["raw"][j].numpy(), X[j, r])
