"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  This file imports no JAX, so it also runs on a GPU
machine that has none:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the full model's shapes.
"""
import pytest
import torch

from repro_torch.kernels import loco_quant as LQ


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_kernels_match_plain(cuda_device, bits):
    gen = torch.Generator(device=cuda_device).manual_seed(bits)
    n = 64 * 512
    g = torch.randn(n, generator=gen, device=cuda_device) * 1e-3
    cells = [("f8", (torch.randn(n, generator=gen, device=cuda_device) * 200)
              .clamp(-448, 448).to(torch.float8_e4m3fn), 0.5, 2.0**14),
             ("bf16", torch.zeros(n, dtype=torch.bfloat16, device=cuda_device),
              1.0, 1.0)]
    LQ.reset_launches()
    for err, e, beta, escale in cells:
        kw = dict(bits=bits, beta=beta, escale=escale, err=err)
        got = LQ.fused_compress(g, e, **kw)
        want = LQ.fused_compress_plain(g, e, **kw)
        for k, w in zip(got, want):
            assert torch.equal(k.view(torch.uint8) if k.dtype.itemsize == 1
                               else k, w.view(torch.uint8)
                               if w.dtype.itemsize == 1 else w)
        for D in (1, 2, 4, 8):
            p, s = got[0].reshape(D, -1), got[1].reshape(D, -1)
            assert torch.equal(LQ.dequant_mean(p, s, bits=bits),
                               LQ.dequant_mean_plain(p, s, bits=bits))
    assert LQ.LAUNCHES == {"fused_compress": 2, "dequant_mean": 8}


def _bytes(t):
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


@pytest.mark.parametrize("n", [64 * 512, 33554432])
def test_cuda_loco_interface_variants(cuda_device, n):
    """bf16 gradient in, error written in place, bf16 shard out: bit-exact
    against the plain versions at a small shape and at the deepseek-v3-moe
    expert shape (33,554,432 elements)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = (torch.randn(n, generator=gen, device=cuda_device) * 1e-3).to(
        torch.bfloat16)
    e = (torch.randn(n, generator=gen, device=cuda_device) * 200).clamp(
        -448, 448).to(torch.float8_e4m3fn)
    kw = dict(bits=4, beta=0.5, escale=2.0**14)
    want = LQ.fused_compress_plain(g, e, **kw)
    LQ.reset_launches()
    assert all(torch.equal(_bytes(k), _bytes(w))
               for k, w in zip(LQ.fused_compress(g.float(), e, **kw), want))
    e_in = e.clone()
    got = LQ.fused_compress(g, e_in, e_out=e_in, **kw)
    assert got[2] is e_in
    assert all(torch.equal(_bytes(k), _bytes(w)) for k, w in zip(got, want))
    for D in (1, 2, 4, 8):
        p, s = got[0].reshape(D, -1), got[1].reshape(D, -1)
        ref = LQ.dequant_mean_plain(p, s)
        out = LQ.dequant_mean(p, s, out_dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16
        assert torch.equal(_bytes(out), _bytes(ref.to(torch.bfloat16)))
        assert torch.equal(LQ.dequant_mean(p, s), ref)
    assert LQ.LAUNCHES == {"fused_compress": 2, "dequant_mean": 8}


def test_cuda_loco_dividing_variants(cuda_device):
    """An error scale that is no power of two and D = 3 peers: the kernels
    divide where the main path multiplies, bit-exact all the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    n = 3 * 64 * 512
    g = (torch.randn(n, generator=gen, device=cuda_device) * 1e-3).to(
        torch.bfloat16)
    e = (torch.randn(n, generator=gen, device=cuda_device) * 200).clamp(
        -448, 448).to(torch.float8_e4m3fn)
    kw = dict(bits=4, beta=0.5, escale=3000.0)
    got = LQ.fused_compress(g, e, **kw)
    want = LQ.fused_compress_plain(g, e, **kw)
    assert all(torch.equal(_bytes(k), _bytes(w)) for k, w in zip(got, want))
    p, s = got[0].reshape(3, -1), got[1].reshape(3, -1)
    ref = LQ.dequant_mean_plain(p, s)
    assert torch.equal(LQ.dequant_mean(p, s), ref)
    assert torch.equal(_bytes(LQ.dequant_mean(p, s, out_dtype=torch.bfloat16)),
                       _bytes(ref.to(torch.bfloat16)))


def _act_rows(gen, dev, rows=64):
    h = torch.randn(rows, 512, generator=gen, device=dev)
    h *= 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 8 - 5)
    h[1] = 0.0
    h[2, 5] = 3.0e38
    h[3] *= 1e-39
    return h


def test_cuda_act_kernels_match_plain(cuda_device):
    from repro_torch.kernels import act_quant as AQ

    h = _act_rows(torch.Generator(device=cuda_device).manual_seed(3),
                  cuda_device)
    AQ.reset_launches()
    q, s = AQ.act_encode(h)
    pq, ps = AQ.act_encode_plain(h)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(AQ.act_decode(q, s), AQ.act_decode_plain(q, s))
    assert AQ.LAUNCHES == {"act_encode": 1, "act_decode": 1}


def test_cuda_onebit_pack_matches_plain(cuda_device):
    from repro_torch.kernels import sign_pack as SP

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    h = torch.randn(64 * 512, generator=gen, device=cuda_device) * 1e-3
    h[::97] = 0.0
    h[1::89] = -0.0
    scale = h.abs().mean()
    SP.reset_launches()
    p, e = SP.onebit_pack(h, scale)
    pp, pe = SP.onebit_pack_plain(h, scale)
    assert torch.equal(p, pp)
    assert torch.equal(e.view(torch.int16), pe.view(torch.int16))
    assert SP.LAUNCHES == {"onebit_pack": 1}


@pytest.mark.parametrize("D", [3, 5, 2])
def test_cuda_fp_mean_is_ieee_division(cuda_device, D):
    """The fp wire's mean over D peers, on the card: the f64 quotient
    rounded to f32 (one IEEE division), also where D is no power of two
    and torch would multiply by 1/D for a Python-scalar divisor."""
    from repro_torch.core.comm import fp_mean

    gen = torch.Generator(device=cuda_device).manual_seed(D)
    summed = (torch.randn(1 << 16, generator=gen, device=cuda_device)
              * 1e-2).to(torch.bfloat16)
    got = fp_mean(summed, D)
    assert got.dtype == torch.float32
    want = (summed.double() / D).float()
    assert torch.equal(got, want)
    if D == 3:   # what the repair avoids: a multiply rounds otherwise
        assert not torch.equal(summed.float() / D, want)
