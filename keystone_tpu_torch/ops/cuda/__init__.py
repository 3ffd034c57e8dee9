"""Hand-written CUDA kernels of the port and its cuBLAS binding for solver
products (sources under ``csrc/``, built at first use by ``_build.py``),
with their PyTorch wrappers."""


def device_counts(device) -> dict:
    """This process's ELL kernel launches, solver-binding calls per product
    kind and, on a CUDA device, peak allocated bytes (``None`` elsewhere):
    the counts a CLI prints, so that a caller in another process can read
    what the work it started launched."""
    import torch

    from . import blocksparse, gemm

    device = torch.device(device)
    return {
        "ell_launches": blocksparse.ell_matmul.launches,
        "solver_gemm_launches": dict(gemm.launches),
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }
