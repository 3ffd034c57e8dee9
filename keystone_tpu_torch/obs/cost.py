"""Cost predictions carried by the estimators that a cost model chose.

A copy of the ``Prediction`` dataclass of ``keystone_tpu/obs/cost.py``.
``LeastSquaresEstimator.optimize`` pins one on the rung it picks
(``predicted_cost``), with every candidate the argmin saw, and
``obs/solver.py::predicted_attrs`` puts it on the ``solver:fit`` span.

Only the dataclass is ported. The rest of the cost observatory (the
roofline, the plan-scoped prediction book, the ledger join and the drift
sentinel) comes with the observability tier (ROADMAP item 13b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Prediction:
    """One model's cost claim for a node.

    ``calibrated`` marks predictions measured under the exact
    (key, shape class) they will be compared at — only those would be
    drift-scored. ``seconds`` and ``rows_per_s`` are alternative units."""

    model: str  # solver_ladder | autocache | measured_knob | tune | roofline
    key: str = ""  # the ProfileStore key that backed it ("" = none)
    shape: str = ""  # the shape class it was recorded under
    seconds: Optional[float] = None
    rows_per_s: Optional[float] = None
    calibrated: bool = False
    source: str = "observed"  # store provenance (observed | tune)
    #: Every candidate an argmin choice considered, as (name,
    #: seconds-or-None, reason) tuples — "chosen" for the winner,
    #: the rejection reason otherwise.
    candidates: Tuple = ()


__all__ = ["Prediction"]
