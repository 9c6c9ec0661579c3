"""telemetry layer of the PyTorch/CUDA port (mirrors repro.telemetry)."""
