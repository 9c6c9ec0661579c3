"""Training's fused attention kernels (``kernels/attention``) on a card,
against the plain path (``blockwise_attention`` with every key in one
block, differentiated by autograd) and against the same formulas in f64.

At h2o-danube-1.8b's shape (4 x 2,048 tokens, 32 heads of 80), mixtral's
(2 x 1,024, 128), hd 64 with a window of 512 < S, and a ragged S of 1,000:
the output and dq, dk, dv of the kernels lie no further from f64 (relative
L2 error) than 1.5 times the plain path's; the output within ATTN_ATOL of
the plain path's; lse the plain path's within LSE_RTOL; three backward
passes give the same bits; and each call launches each kernel once.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a GPU machine that has none:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_attention_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels import attention as KA
from repro_torch.models import common as C

# name: (B, S, H, hd, window)
CASES = {"danube": (4, 2048, 32, 80, 4096),
         "mixtral": (2, 1024, 32, 128, 4096),
         "hd64-window512": (2, 2048, 16, 64, 512),
         "ragged1000": (2, 1000, 16, 80, None),
         "ragged1000-hd128": (2, 1000, 8, 128, 300)}
ERR_FACTOR = 1.5     # kernel's error against f64 over the plain path's
ATTN_ATOL = 2e-3     # test_torch_blockwise's training attention at 1,024 keys
LSE_RTOL = 1e-5      # the scores sum in another order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(name, dev):
    """q, k (unit normal), v (2^-4 of one: outputs under 0.5, where a bf16
    ulp is 2^-9 at most) and the output's gradient, bf16, from the case's
    seed."""
    B, S, H, hd, _ = CASES[name]
    gen = torch.Generator(device=dev).manual_seed(sorted(CASES).index(name))
    q, k, v, g = (torch.randn(B, S, H, hd, generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(4))
    return q, k, v * 2**-4, g


def _kernel(q, k, v, g, window):
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = KA.attention(*xs, window)
    out.backward(g)
    return [out.detach()] + [x.grad for x in xs]


def _plain(q, k, v, g, window):
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = KA.attention_plain(*xs, window)
    out.backward(g)
    return [out.detach()] + [x.grad for x in xs]


def _f64(q, k, v, g, window):
    """The same formulas in f64, one batch element at a time: q scaled and
    rounded as both paths round it, the exact softmax, its gradient."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qs = (q.float() * scale).to(q.dtype)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    w = S if window is None else window
    keep = (j <= i) & (j > i - w)
    outs = [[], [], [], []]
    for b in range(B):
        qd, kd, vd, gd = (x[b].double().transpose(0, 1)
                          for x in (qs, k, v, g))
        s = (qd @ kd.transpose(-1, -2)).masked_fill(~keep, -math.inf)
        p = torch.softmax(s, dim=-1)
        del s
        o = p @ vd
        ds = p * (gd @ vd.transpose(-1, -2) - (gd * o).sum(-1, keepdim=True))
        for lst, x in zip(outs, (o, ds @ kd * scale,
                                 ds.transpose(-1, -2) @ qd,
                                 p.transpose(-1, -2) @ gd)):
            lst.append(x.transpose(0, 1))
        del p, ds
    return [torch.stack(x) for x in outs]


def _rel(x, ref) -> float:
    return float((x.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_attention_against_plain_and_f64(cuda_device, name):
    window = CASES[name][4]
    q, k, v, g = _inputs(name, cuda_device)
    KA.reset_launches()
    got = _kernel(q, k, v, g, window)
    torch.cuda.synchronize()
    assert dict(KA.LAUNCHES) == {"attention_fwd": 1, "attention_bwd_dq": 1,
                                 "attention_bwd_dkdv": 1}
    plain = _plain(q, k, v, g, window)
    ref = _f64(q, k, v, g, window)
    report = []
    for what, a, p, r in zip(("out", "dq", "dk", "dv"), got, plain, ref):
        ek, ep = _rel(a, r), _rel(p, r)
        report.append(f"{what} kernel {ek:.3e} plain {ep:.3e} "
                      f"(max abs {float((a.double() - r).abs().max()):.3e} "
                      f"/ {float((p.double() - r).abs().max()):.3e})")
        assert ek <= ERR_FACTOR * ep, report
    print(f"{name}: " + "; ".join(report))
    assert float((got[0].float() - plain[0].float()).abs().max()) \
        <= ATTN_ATOL
    _, lse = KA.attention_fwd(q, k, v, window)
    _, lse_plain = KA.attention_fwd_plain(q, k, v, window)
    torch.testing.assert_close(lse, lse_plain, rtol=LSE_RTOL, atol=0)


@pytest.mark.parametrize("name", ["danube", "ragged1000-hd128"])
def test_cuda_attention_backward_is_deterministic(cuda_device, name):
    """No atomics: three backward passes give the same bits."""
    window = CASES[name][4]
    q, k, v, g = _inputs(name, cuda_device)
    runs = [_kernel(q, k, v, g, window) for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_cuda_common_attention_launches_as_dispatched(cuda_device):
    """``common.attention`` launches the kernels where ``takes`` says so
    and nothing otherwise (soft cap, not causal, hd 32, f32, Sq != Sk)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)

    def rand(B, S, H, hd, dtype=torch.bfloat16):
        return torch.randn(B, S, H, hd, generator=gen, device=cuda_device,
                           dtype=dtype).requires_grad_()

    q, k, v = (rand(1, 256, 2, 64) for _ in range(3))
    KA.reset_launches()
    C.attention(q, k, v, window=100).sum().backward()
    assert dict(KA.LAUNCHES) == {"attention_fwd": 1, "attention_bwd_dq": 1,
                                 "attention_bwd_dkdv": 1}
    KA.reset_launches()
    C.attention(q, k, v, softcap=50.0).sum().backward()
    C.attention(q, k, v, causal=False).sum().backward()
    x32 = rand(1, 256, 2, 32)
    C.attention(x32, x32, x32).sum().backward()
    x = rand(1, 64, 2, 64, torch.float32)
    C.attention(x, x, x).sum().backward()
    C.attention(q, rand(1, 128, 2, 64), rand(1, 128, 2, 64),
                causal=False).sum().backward()
    assert not KA.LAUNCHES
