"""repro_torch: PyTorch/CUDA port of the LoCo reproduction.

Mirrors the module layout of the JAX package ``repro`` (``repro_torch.core``
<-> ``repro.core`` and so on) but imports only ``torch``: it runs on a GPU
machine that has no JAX.  Every Pallas kernel of the reference becomes a
kernel written by hand for Hopper (``repro_torch.kernels``), each with a
plain PyTorch version that CPU tensors use.
"""
