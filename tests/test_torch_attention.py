"""Training's fused attention (``kernels/attention``) on the CPU: the rule
by which ``models/common.attention`` takes it, its plain versions (the
plain path's bits, forward and backward, also under the layer's remat),
the planned path on fake tensors, its accounting under a recorder, and
the launches a dry run of an h2o-danube-1.8b training step plans.

The kernels themselves run on a card: tests/test_torch_attention_cuda.py.
"""
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis import op_stats as OS
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import attention as KA
from repro_torch.kernels import wrap as W
from repro_torch.launch import dryrun as DR
from repro_torch.models import common as C

BF16, F32 = torch.bfloat16, torch.float32
KERNELS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv")

# (device, dtype, causal, softcap, q shape, kv shape) -> takes the kernels
RULE = [
    ("cpu", BF16, True, None, (2, 64, 4, 64), (2, 64, 4, 64), True),
    ("cuda", BF16, True, None, (4, 2048, 32, 80), (4, 2048, 32, 80), True),
    ("cuda", BF16, True, None, (2, 1024, 32, 128), (2, 1024, 32, 128), True),
    ("cuda", BF16, True, 50.0, (2, 128, 4, 128), (2, 128, 4, 128), False),
    ("cuda", BF16, False, None, (2, 128, 4, 64), (2, 128, 4, 64), False),
    ("cuda", BF16, False, None, (2, 32, 4, 64), (2, 1500, 4, 64), False),
    ("cuda", BF16, True, None, (2, 128, 4, 96), (2, 128, 4, 96), False),
    ("cuda", BF16, True, None, (2, 128, 4, 32), (2, 128, 4, 32), False),
    ("cuda", F32, True, None, (2, 128, 4, 64), (2, 128, 4, 64), False),
    ("cuda", BF16, True, None, (2, 128, 4, 128), (2, 128, 4, 64), False),
    ("meta", BF16, True, None, (2, 128, 4, 64), (2, 128, 4, 64), False),
]


def _tensor(device, dtype, shape):
    if device == "cuda":  # a planned (fake) CUDA tensor: shapes only
        with FakeTensorMode():
            return torch.empty(shape, dtype=dtype, device="cuda")
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("row", RULE, ids=[
    f"{d}-{str(t)[6:]}-{'causal' if c else 'all'}-cap{s}-{q[-1]}-{kv[1]}"
    for d, t, c, s, q, kv, _ in RULE])
def test_dispatch_rule(row):
    device, dtype, causal, softcap, qshape, kvshape, want = row
    q = _tensor(device, dtype, qshape)
    k = v = _tensor(device, dtype, kvshape)
    assert KA.takes(q, k, v, causal, softcap) is want


def _inputs(B, S, H, hd, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, H, hd, generator=gen).to(BF16)
            for _ in range(4)]


def _bits(t):
    return t.view(torch.int16) if t.dtype == BF16 else t


CPU_CASES = [(2, 96, 4, 64, None), (1, 150, 2, 80, 40), (2, 64, 2, 128, 17)]


@pytest.mark.parametrize("case", CPU_CASES, ids=lambda c: f"hd{c[3]}")
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_cpu_attention_is_the_plain_paths_bits(case, remat):
    """On a CPU tensor ``common.attention`` goes through the kernels'
    Function, whose plain versions give the plain path's output and
    gradients bit for bit (also under non-reentrant checkpoint, as a
    layer's remat runs it), and launch nothing."""
    B, S, H, hd, window = case
    q, k, v, g = _inputs(B, S, H, hd, seed=hd)
    pos = torch.arange(S)

    def grads(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = (checkpoint(fn, *xs, use_reentrant=False) if remat
               else fn(*xs))
        out.backward(g)
        return [out.detach()] + [x.grad for x in xs]

    W.reset_launches()
    got = grads(lambda *xs: C.attention(*xs, window=window))
    want = grads(lambda *xs: C.blockwise_attention(
        *xs, pos, pos, window=window, block_k=S))
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    assert not W.LAUNCHES


def test_plain_versions_of_the_three_kernels():
    """The forward's lse is log2 of the softmax denominator; the dq
    kernel's D is rowsum(dO * O) and its q scaled the plain path's
    rounding; the three give the plain path's gradients."""
    B, S, H, hd, window = 2, 70, 3, 80, 30
    q, k, v, g = _inputs(B, S, H, hd, seed=3)
    out, lse = KA.attention_fwd_plain(q, k, v, window)
    assert torch.equal(_bits(out), _bits(KA.attention_plain(q, k, v,
                                                            window)))
    qs = (q.float() * (1 / math.sqrt(hd))).to(BF16).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill((j > i) | (j <= i - window), -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1) / math.log(2),
                               rtol=2e-6, atol=0)
    dq, dsum, qs2 = KA.bwd_dq_plain(q, k, v, out, g, window)
    dk, dv = KA.bwd_dkdv_plain(q, k, v, g, window)
    torch.testing.assert_close(dsum, (g.float() * out.float()).sum(-1)
                               .transpose(1, 2))
    assert torch.equal(qs2.float(), qs.transpose(1, 2))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    KA.attention_plain(*xs, window).backward(g)
    for a, b in zip((dq, dk, dv), xs):
        assert torch.equal(_bits(a), _bits(b.grad))


def test_planned_path_returns_the_kernels_shapes():
    """On fake tensors the forward and both backward kernels return their
    outputs' shapes and dtypes, count a planned launch each and launch
    nothing."""
    W.reset_launches()
    before = {n: W.PLANNED[n] for n in KERNELS}
    with FakeTensorMode():
        q, k, v = (torch.empty(2, 256, 4, 80, dtype=BF16).requires_grad_()
                   for _ in range(3))
        out, lse = KA.attention_fwd(q, k, v, 100)
        dq, dsum, qs = KA.attention_bwd_dq(q, k, v, out, lse, out, 100)
        dk, dv = KA.attention_bwd_dkdv(q, qs, k, v, lse, dsum, out, 100)
        y = KA.attention(q, k, v)
        y.sum().backward()
    assert [(tuple(t.shape), t.dtype) for t in (out, lse, dq, dsum, qs, dk,
                                                  dv, y, q.grad)] == [
        ((2, 256, 4, 80), BF16), ((2, 4, 256), F32), ((2, 256, 4, 80), BF16),
        ((2, 4, 256), F32), ((2, 4, 256, 80), BF16), ((2, 256, 4, 80), BF16),
        ((2, 256, 4, 80), BF16), ((2, 256, 4, 80), BF16),
        ((2, 256, 4, 80), BF16)]
    assert {n: W.PLANNED[n] - before[n] for n in KERNELS} == dict.fromkeys(
        KERNELS, 2)
    assert not W.LAUNCHES


def test_recorded_as_three_kernel_ops_with_their_flops_and_bytes():
    """Under a recorder on real CPU tensors a forward and backward is one
    op per kernel, charged its operations (4, 6 and 8 hd per visible
    pair) and bytes, the plain versions' ops uncounted, and the plain
    path's bits."""
    B, S, H, hd, window = 2, 48, 2, 64, 20
    q, k, v, g = _inputs(B, S, H, hd, seed=9)
    pairs = 20 * 21 // 2 + (48 - 20) * 20
    assert KA.pairs(S, window) == pairs == sum(min(i + 1, window)
                                              for i in range(S))
    assert KA.pairs(S, None) == S * (S + 1) // 2
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    with OS.OpStats("cpu") as st:
        out = KA.attention(*xs, window)
        got = torch.autograd.grad(out, xs, g)
    assert dict(st.kernels) == dict.fromkeys(KERNELS, 1) and st.n_ops == 3
    n, rows = B * S * H * hd * 2, B * H * S * 4
    assert st.flops == (4 + 6 + 8) * hd * pairs * B * H
    assert st.bytes == (4 * n + rows) + (7 * n + 2 * rows) + (6 * n
                                                               + 2 * rows)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    want = KA.attention_plain(*ys, window)
    want.backward(g)
    for a, b in zip([out, *got], [want] + [y.grad for y in ys]):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))


def test_danube_training_step_plans_the_kernels():
    """A dry run of h2o-danube-1.8b's benchmark step (seq 2,048 x batch 8,
    microbatch 4, world 1) on fake tensors plans per step 96 forwards (24
    layers x 2 microbatches, again in the remat of each backward), 48 dq
    and 48 dk/dv kernels."""
    rec = DR.dryrun_one("h2o-danube-1.8b", "train_4k", device="cpu",
                        world=DR.parse_world("1x1"),
                        shape=ShapeConfig("t", 2048, 8, "train"),
                        run_overrides={"microbatch": 4})
    assert rec["status"] == "ok", rec.get("traceback")
    assert {n: rec["kernels"][n] for n in KERNELS} == {
        "attention_fwd": 96, "attention_bwd_dq": 48,
        "attention_bwd_dkdv": 48}
