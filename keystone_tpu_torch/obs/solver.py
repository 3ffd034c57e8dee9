"""Solver instrumentation helpers: fit spans, ladder-rung iteration spans,
and host-loop iteration counting.

A copy of ``keystone_tpu/obs/solver.py``. The solvers' work is observable
from the host at two levels: the whole solve, and the degradation-ladder
rung loop (each rung attempt is a real iteration of the solve-or-shrink
loop). These helpers give both one vocabulary:

- :func:`fit_span` — ``solver:fit`` span + ``keystone_solver_fit_seconds``
  histogram around a whole fit;
- :func:`rung_span` — ``solver:iteration`` child span +
  ``keystone_solver_rung_attempts_total`` per ladder rung attempt;
- :func:`count_iteration` — ``keystone_solver_iterations_total`` +
  a span event per host-level optimizer step.

All are free when neither a span session nor the metric has consumers —
counters are cheap dict increments; spans no-op without a session.
Neither keeps a reference to an exception that leaves it: the span
records the message string only, so a failed rung's tensors die with
its frame (``reliability/degrade.py``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Iterator

from . import names, spans


@contextmanager
def fit_span(solver: str, **attributes: Any) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        with spans.span("solver:fit", solver=solver, **attributes):
            yield
    finally:
        names.metric(names.SOLVER_FIT_SECONDS).observe(
            time.perf_counter() - t0, solver=solver
        )


@contextmanager
def rung_span(solver: str, rung: Any, index: int) -> Iterator[None]:
    names.metric(names.SOLVER_RUNG_ATTEMPTS).inc(solver=solver)
    with spans.span(
        "solver:iteration", solver=solver, rung=str(rung), rung_index=index
    ):
        yield


def count_iteration(solver: str, n: int = 1, **attributes: Any) -> None:
    names.metric(names.SOLVER_ITERATIONS).inc(n, solver=solver)
    spans.add_span_event("solver:step", solver=solver, **attributes)


def predicted_attrs(estimator: Any) -> dict:
    """Span attributes for a cost prediction pinned on an estimator
    (``predicted_cost``, an ``obs/cost.py::Prediction`` that
    ``LeastSquaresEstimator.optimize`` pins on the rung it picks); ``{}``
    for an estimator without one."""
    prediction = getattr(estimator, "predicted_cost", None)
    if prediction is None:
        return {}
    out: dict = {"predicted_model": prediction.model}
    if getattr(prediction, "seconds", None) is not None:
        out["predicted_cost_ms"] = round(prediction.seconds * 1e3, 3)
    if getattr(prediction, "rows_per_s", None):
        out["predicted_rows_per_s"] = round(prediction.rows_per_s, 1)
    if getattr(prediction, "key", ""):
        out["predicted_key"] = prediction.key
    return out
