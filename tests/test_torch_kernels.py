"""The port's kernels: plain versions against the Pallas kernels (CPU), and
the CUDA kernels against the plain versions (on a card only).

On CPU tensors a wrapper runs its plain PyTorch version, which must compute
what ``repro.kernels.loco_quant`` computes in interpret mode: payload and
scales bit for bit, ``e_new`` within one f8 quantum on fewer than 5e-3 of
the elements (``tests/test_kernels.py``'s tolerance), the peer mean exactly
at D <= 2 and within rtol 1e-6 beyond (XLA may sum the D rows in another
order).  The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import loco_quant as JLQ
from repro_torch.interop import to_torch
from repro_torch.kernels import loco_quant as LQ
from test_torch_codec import _np, assert_f8_close


def _inputs(seed, n, err):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    mag = 10.0 ** rng.uniform(-6, 0, n // 256)
    g = (g.reshape(-1, 256) * mag[:, None]).reshape(-1).astype(np.float32)
    g.reshape(-1, 256)[1::4] = 0.0                       # all-zero blocks
    if err == "f8":
        e = np.clip(rng.standard_normal(n) * 200, -448, 448).astype(np.float32)
        je = jnp.asarray(e).astype(jnp.float8_e4m3fn)
    else:
        je = jnp.asarray(rng.standard_normal(n) * 1e-3).astype(jnp.bfloat16)
    return g, je, to_torch(np.asarray(je))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("err", ["f8", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_compress_plain_matches_pallas(bits, err, seed):
    n = 6 * 512
    g, je, te = _inputs(seed, n, err)
    beta, escale = (0.5, 2.0**14) if err == "f8" else (1.0, 1.0)
    jq, js, jn = JLQ.fused_compress(jnp.asarray(g), je, bits=bits, beta=beta,
                                    escale=escale, err=err, interpret=True)
    tq, ts, tn = LQ.fused_compress(torch.from_numpy(g), te, bits=bits,
                                   beta=beta, escale=escale, err=err)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tn.dtype == te.dtype
    if err == "f8":
        assert_f8_close(tn, jn)
    else:
        np.testing.assert_array_equal(_np(tn), _np(jn))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_mean_plain_matches_pallas(D, bits):
    n_chunk = 4 * 512
    g, je, _ = _inputs(D + bits, D * n_chunk, "f8")
    jq, js, _ = JLQ.fused_compress(jnp.asarray(g), je, bits=bits, beta=0.5,
                                   escale=2.0**14, interpret=True)
    pay, sc = jq.reshape(D, -1), js.reshape(D, -1)
    want = np.asarray(JLQ.dequant_mean(pay, sc, bits=bits, interpret=True))
    got = LQ.dequant_mean(to_torch(np.asarray(pay)), to_torch(np.asarray(sc)),
                          bits=bits).numpy()
    if D <= 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_cpu_tensors_never_count_launches():
    LQ.reset_launches()
    g = torch.randn(1024)
    q, s, _ = LQ.fused_compress(g, torch.zeros(1024).to(torch.float8_e4m3fn),
                                beta=0.5, escale=2.0**14)
    LQ.fused_compress(g, torch.zeros(1024, dtype=torch.bfloat16), beta=1.0,
                      escale=1.0, err="bf16")
    LQ.dequant_mean(q[None], s[None])
    e = torch.zeros(1024).to(torch.float8_e4m3fn)
    LQ.fused_compress(g.to(torch.bfloat16), e, beta=0.5, escale=2.0**14,
                      e_out=e)
    LQ.dequant_mean(q[None], s[None], out_dtype=torch.bfloat16)
    assert sum(LQ.LAUNCHES.values()) == 0


@pytest.mark.parametrize("case", ["dtype", "length", "err", "bits",
                                  "scales", "device", "dtype_f16",
                                  "e_out_dtype", "e_out_shape",
                                  "e_out_device", "align", "strided",
                                  "out_dtype", "payload_align"])
def test_wrappers_reject_bad_inputs(case):
    """Shape, dtype, alignment and device are checked on every device (the
    CPU runs the plain version, but takes only what the kernel takes)."""
    g = torch.randn(1024)
    e = torch.zeros(1024).to(torch.float8_e4m3fn)
    kw = dict(beta=0.5, escale=2.0**14)
    pay, sc = torch.zeros(1, 512, dtype=torch.int8), torch.ones(1, 4)
    with pytest.raises(ValueError):
        if case == "dtype":
            LQ.fused_compress(g.double(), e, **kw)
        elif case == "length":
            LQ.fused_compress(g[:768], e[:768], **kw)
        elif case == "err":
            LQ.fused_compress(g, e, err="bf16", **kw)
        elif case == "bits":
            LQ.fused_compress(g, e, bits=2, **kw)
        elif case == "scales":
            LQ.dequant_mean(torch.zeros(1, 512, dtype=torch.int8),
                            torch.ones(1, 3))
        elif case == "device":
            LQ.fused_compress(g.to("meta"), e.to("meta"), **kw)
        elif case == "dtype_f16":
            LQ.fused_compress(g.half(), e, **kw)
        elif case == "e_out_dtype":
            LQ.fused_compress(g, e, e_out=e.to(torch.bfloat16), **kw)
        elif case == "e_out_shape":
            LQ.fused_compress(g, e, e_out=torch.zeros(2048).to(e.dtype), **kw)
        elif case == "e_out_device":
            LQ.fused_compress(g, e, e_out=e.to("meta"), **kw)
        elif case == "align":
            LQ.fused_compress(torch.randn(1025)[1:], e, **kw)
        elif case == "strided":
            LQ.fused_compress(torch.randn(2048)[::2], e, **kw)
        elif case == "out_dtype":
            LQ.dequant_mean(pay, sc, out_dtype=torch.float16)
        else:
            LQ.dequant_mean(torch.zeros(1, 1024 + 1, dtype=torch.int8)
                            [:, 1:], sc)
