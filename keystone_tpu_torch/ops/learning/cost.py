"""Cost-model framework for optimizable operators.

Port of ``keystone_tpu/ops/learning/cost.py`` (reference:
nodes/learning/CostModel.scala:6-17,
nodes/learning/LeastSquaresEstimator.scala:17-31). Costs combine cpu
(flops), memory-bandwidth (elements scanned) and network (elements moved
between devices) terms:  max(cpu·flops, mem·elems) + network·elems.

Two weight sources:

1. ``cuda_weights()`` — per-unit costs from the card's own data-sheet
   peaks, looked up by ``torch.cuda.get_device_name``. A card not in
   :data:`CARD_PEAKS` raises: pass ``weights=`` to the estimator.
2. ``DEFAULT_COST_WEIGHTS`` — the reference's own constants
   ("determined empirically via results run on a 16 r3.4xlarge node
   cluster"), used on the CPU so that relative solver choices there
   match the reference's (and the JAX package's on its CPU backend).

``default_cost_weights(device)`` picks by the device's type. Constants
fitted by measurement on the card are not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...device import DeviceLike, resolve_device


@dataclass(frozen=True)
class CostWeights:
    cpu: float      # ms per flop
    mem: float      # ms per element scanned (fp32)
    network: float  # ms per element moved between devices


# reference: LeastSquaresEstimator.scala:29-31 (16×r3.4xlarge cluster).
# The reference never documents its units; only the ratios matter for the
# argmin over solvers, so these are kept verbatim.
DEFAULT_COST_WEIGHTS = CostWeights(cpu=3.8e-4, mem=2.9e-1, network=1.32)

#: Data-sheet peaks by a substring of the card's name: (fp32 FLOP/s
#: outside the tensor cores, memory bytes/s, device-to-device bytes/s).
#: "H100 80GB HBM3" is the NVIDIA H100 SXM5 80GB at its 700 W limit:
#: 67 TFLOP/s fp32, 3.35 TB/s HBM3, 900 GB/s NVLink. A card set below
#: 700 W runs slower under load than these peaks say.
CARD_PEAKS = {
    "H100 80GB HBM3": (67e12, 3.35e12, 900e9),
}


def cuda_weights(name: Optional[str] = None) -> CostWeights:
    """Per-unit costs (ms) from the peaks of the card called ``name``
    (default: CUDA device 0's name). Units match the ``cost()`` formulas:
    flops are raw flop counts, mem/network fp32 element counts (×4
    bytes). For the H100 SXM5: cpu = 1/67e9 ms per flop, mem =
    4/3.35e9 ms per element, network = 4/900e6 ms per element."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    for key, (flops, mem_bytes, link_bytes) in CARD_PEAKS.items():
        if key in name:
            return CostWeights(cpu=1e3 / flops, mem=4e3 / mem_bytes, network=4e3 / link_bytes)
    raise ValueError(
        f"no data-sheet peaks for the card {name!r} (known: {sorted(CARD_PEAKS)}); "
        "pass weights=CostWeights(...) to the estimator"
    )


def default_cost_weights(device: DeviceLike = None) -> CostWeights:
    """Weights for ``device`` (``None``: the CUDA device): the card's own
    peaks on CUDA, the reference's cluster constants on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return DEFAULT_COST_WEIGHTS
    return cuda_weights(torch.cuda.get_device_name(device))


class CostModel:
    """Mixin: operators expose cost(n, d, k, sparsity, num_machines)."""

    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS) -> float:
        raise NotImplementedError


__all__ = [
    "CARD_PEAKS",
    "CostModel",
    "CostWeights",
    "DEFAULT_COST_WEIGHTS",
    "cuda_weights",
    "default_cost_weights",
]
