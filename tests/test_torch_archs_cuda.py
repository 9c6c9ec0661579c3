"""The model layer on a card: the GQA kv expansion's backward is
deterministic, and the scales and soft caps give the CPU's bits.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a GPU machine that has none:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_archs_cuda.py
"""
import pytest
import torch

from repro_torch.models import common as C


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bytes(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_cuda_expand_kv_backward_is_deterministic(cuda_device):
    """GQA's kv expansion at mixtral's attention shape (2 x 1024 tokens, 32
    q heads over 8 kv heads of 128), bf16: three backward passes give the
    same gradient bit for bit (a gather's backward adds the q heads'
    gradients with atomics, whose order changes between runs)."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    k = torch.randn(2, 1024, 8, 128, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    g = torch.randn(2, 1024, 32, 128, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    lay = C.HeadLayout.make(32, 8, 128, 1)
    grads = []
    for _ in range(3):
        kk = k.clone().requires_grad_()
        out = C.expand_kv(kk, lay.kv_runs())
        assert torch.equal(out, torch.index_select(
            k, 2, lay.kv_map(cuda_device)))
        out.backward(g)
        grads.append(kk.grad)
    assert all(torch.equal(x, grads[0]) for x in grads[1:])


@pytest.mark.parametrize("cap", [50.0, 30.0])
def test_cuda_scales_and_soft_caps_are_the_cpus(cuda_device, cap):
    """The embedding / residual / logit scales (bf16, the scalar rounded to
    bf16) and the soft cap (f32, forward and backward) give the CPU's bits
    on the card."""
    gen = torch.Generator().manual_seed(22)
    x, g = (torch.randn(1 << 20, generator=gen) * 20 for _ in range(2))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        xb = x.bfloat16().to(dev)
        xf = x.to(dev).requires_grad_()
        y = C.soft_cap(xf, cap)
        y.backward(g.to(dev))
        out[dev.type] = [C.scale_by(xb, s).cpu() for s in (
            4608.0 ** 0.5, 12.0, 1.4 / 40 ** 0.5, 256.0 / 2304.0, 0.0625)]
        out[dev.type] += [y.detach().cpu(), xf.grad.cpu()]
    assert all(torch.equal(_bytes(a), _bytes(b))
               for a, b in zip(out["cuda"], out["cpu"]))
