"""The comparison that decides ``correct``.

Every number compared is a relative gap between what the timed path
produced and what the plain reference computes from the same inputs:

    score_gap(S, R) = ‖S − R‖_F / ‖R − mean_rows(R)‖_F

in float64 on the host. The denominator is the spread of the reference's
scores about their column means, so the intercept (most of a ±1
indicator's score) cannot hide a wrong weight matrix. Each number has a
limit of its own in the configuration's file (``"limits"``), set from
the readings that ``PERF.md`` lists.
"""

from __future__ import annotations

from typing import Dict

import torch


def score_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got = got.detach().to("cpu", torch.float64)
    want = want.detach().to("cpu", torch.float64)
    if got.shape != want.shape:
        return float("inf")
    spread = torch.linalg.norm(want - want.mean(dim=0, keepdim=True))
    gap = torch.linalg.norm(got - want)
    if not torch.isfinite(gap):
        return float("inf")
    return float(gap / spread) if spread > 0 else float(gap)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` for every reading; a reading with no
    limit in the configuration is a fault of the configuration file."""
    out = {}
    for name, value in readings.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the configuration's limits")
        out[name] = {"value": value, "limit": limits[name]}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
