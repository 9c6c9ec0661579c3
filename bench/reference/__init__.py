"""Plain PyTorch references that decide a run's ``correct``."""
