"""launch layer of the PyTorch/CUDA port (mirrors repro.launch)."""
