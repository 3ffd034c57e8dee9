"""Precision modes shared by the plain references.

``"fp64"`` is the reference; ``"fp32"`` holds float32 with IEEE
products; ``"tf32"`` (the control) holds float32 and rounds both
operands of every product to TF32's 10-bit mantissa (to nearest, ties to
even) before an IEEE float32 product, which is what a TF32 tensor-core
product reads, on the card and on the CPU alike.
"""

from __future__ import annotations

import torch

#: Reference precision → the floating type its tensors are held in.
DTYPES = {"fp64": torch.float64, "fp32": torch.float32, "tf32": torch.float32}


def dtype_of(precision: str) -> torch.dtype:
    if precision not in DTYPES:
        raise ValueError(f"precision {precision!r}: expected one of {sorted(DTYPES)}")
    return DTYPES[precision]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to a 10-bit mantissa, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` at the mode's precision (TF32 products never come from
    PyTorch's process-wide switches, which stay as they are: off)."""
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b
