"""Published peaks of the card, and the operations and bytes of a dense
product, the yardstick that roofline shares and MFU divide by.

Peaks are NVIDIA's data-sheet dense rates (no sparsity) at the card's
full power limit; the power limit each run reads is printed beside the
shares, since a card set lower runs slower under load. A share is never
computed against a peak measured on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

#: Product kind of the port's solver binding → the peak it runs at.
KIND_PEAK = {
    "ieee_fp32": "fp32",
    "tf32": "tf32",
    "bf16": "bf16",
    "bf16_inputs": "bf16",
    "fp64": "fp64",
}

#: Data-sheet dense peaks by card: FLOP/s per kind and HBM bytes/s.
#: H100 SXM5 (the 80 GB HBM3 part): 67 TFLOP/s fp32 outside the tensor
#: cores, 67 fp64 on the tensor cores, 495 TF32, 989 bf16, 3.35 TB/s.
#: H100 PCIe: 51 / 51 / 378 / 756, 2.0 TB/s.
PEAKS = {
    "h100_sxm": {"fp32": 67e12, "fp64": 67e12, "tf32": 495e12, "bf16": 989e12, "bytes": 3.35e12},
    "h100_pcie": {"fp32": 51e12, "fp64": 51e12, "tf32": 378e12, "bf16": 756e12, "bytes": 2.0e12},
}


def card_peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The peak table of a card by the name CUDA gives it, or None for a
    card this table does not know (then no share is reported)."""
    name = device_name.upper()
    if "H100" not in name:
        return None
    if "PCIE" in name:
        return PEAKS["h100_pcie"]
    return PEAKS["h100_sxm"]


def gemm_counts(m: int, n: int, k: int, itemsize: int, batch: int = 1, accumulate: bool = False,
                gram: bool = False):
    """(FLOP, bytes) of ``batch`` products (m, k)·(k, n): 2·m·n·k FLOP
    each; each operand read once and the output written once (read once
    more when the product accumulates into it). A Gram (``gram``: both
    operands one matrix, m = n) needs only its symmetric half, n·(n+1)·k
    FLOP as a SYRK computes it, and reads its one operand once."""
    if gram:
        flops = float(n) * (n + 1) * k * batch
        elems = k * n + m * n * (2 if accumulate else 1)
    else:
        flops = 2.0 * m * n * k * batch
        elems = m * k + k * n + m * n * (2 if accumulate else 1)
    return flops, float(elems * itemsize * batch)


def least_seconds(flops: float, nbytes: float, kind: str, peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of FLOP over the
    kind's peak and bytes over the memory bandwidth."""
    return max(flops / peaks[KIND_PEAK[kind]], nbytes / peaks["bytes"])
