"""Benchmark of multiprime_tpu_torch, the PyTorch/CUDA port (see run.py)."""
