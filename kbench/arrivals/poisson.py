"""Seeded Poisson arrivals, found by a traffic mix's ``"arrivals":
"poisson"``.

The arithmetic is a copy of ``keystone_tpu_torch/serving/loadgen.py``
(exponential inter-arrival gaps from ``random.Random(seed)`` via
``expovariate``), kept here so the program cannot move the yardstick.
One difference: a run draws a fixed NUMBER of arrivals (rate × seconds),
so every seed offers the same amount of work and only its order in time
differs.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional


def offsets(rate_per_s: float, count: int, seed: int, mix: Optional[Dict[str, Any]] = None) -> List[float]:
    """``count`` arrival offsets (seconds from the first possible
    arrival) of a Poisson process of ``rate_per_s``; the mix sets nothing
    more."""
    if rate_per_s <= 0 or count < 0:
        raise ValueError("rate must be positive and count non-negative")
    rng = random.Random(seed)
    out: List[float] = []
    t = 0.0
    for _ in range(count):
        t += rng.expovariate(rate_per_s)
        out.append(t)
    return out
