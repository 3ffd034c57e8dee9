"""Hand-written CUDA kernels of the port (sources under ``csrc/``, built
at first use by ``_build.py``) and their PyTorch wrappers."""
