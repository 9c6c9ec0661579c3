"""data layer of the PyTorch/CUDA port (mirrors repro.data)."""
