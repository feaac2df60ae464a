"""Plain references the benchmark judges the port's outputs against.

Plain NumPy and PyTorch only: nothing here imports the port
(multiprime_tpu_torch), the JAX package (multiprime_tpu) or JAX.
"""
