"""Benchmark entry points of the port (``python -m
chsimpy_tpu_torch.benchmarks.<name>``)."""
