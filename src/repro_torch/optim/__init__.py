"""optim layer of the PyTorch/CUDA port (mirrors repro.optim)."""
