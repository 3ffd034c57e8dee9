"""Hand-written CUDA kernels of the port and its cuBLAS binding for solver
products (sources under ``csrc/``, built at first use by ``_build.py``),
with their PyTorch wrappers."""
