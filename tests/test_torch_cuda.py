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
