"""checkpoint layer of the PyTorch/CUDA port (mirrors repro.checkpoint)."""
