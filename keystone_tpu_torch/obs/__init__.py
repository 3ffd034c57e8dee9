"""Observability, copied from ``keystone_tpu/obs/``.

- :mod:`.spans`   — hierarchical spans with trace ids, attributes, events
  and cross-thread context handoff; free when no session is active.
- :mod:`.metrics` — the process-wide registry of labeled counters,
  gauges and histograms, and the canonical ``percentile``.
- :mod:`.names`   — the stable names of the series the port publishes,
  and ``register_all``.
- :mod:`.solver`  — ``fit_span``, ``rung_span`` and ``count_iteration``
  around the solvers and their degradation ladders.
- :mod:`.store`   — the persistent profile store (``ProfileStore``,
  ``get_store``), fingerprinted by torch version, backend and card.
- :mod:`.flight`  — the flight recorder: rings of recent ledger events,
  metric snapshots and marks, dumped on crash-class events.
- :mod:`.quality` — the quality plane: score streams, sketches, the
  sequential gate and the drift detector the refit daemon reads.
- :mod:`.export`  — the Chrome trace of one session, the Prometheus text
  exposition and the span report.
- :mod:`.fleet`   — the fleet plane: worker span fragments, clock
  anchors and metric deltas merged into one trace and one scrape, and
  the ``trace`` command.
- :mod:`.cost`    — the cost observatory: launch-site flop/byte facts,
  the card's probed roofline per product kind, the perf ledger and the
  drift sentinel.
- :mod:`.device`  — memory sampling (the card's allocator counters, or
  host RSS) and profiler annotations.
- :mod:`.profile`, :mod:`.benchdiff`, :mod:`.quality_cli` — the
  ``profile``, ``bench-diff`` and ``quality`` commands.

The serving layer and its fleet, the recovery ledger, the executor (node
counters, ``optimize`` span, ``node:<label>`` spans and the node-seconds
histogram under ``trace()`` or a span session, cost frames with the
observatory on), the optimizer's rule counters and spans, the block
solver and the refit daemon publish into them.
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    percentile,
    reset_registry,
)
from .spans import (
    NOOP_SPAN,
    Span,
    TraceSession,
    active_session,
    add_span_event,
    attach,
    current_context,
    current_span,
    record_span,
    span,
    tracing_session,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "percentile", "reset_registry",
    "NOOP_SPAN", "Span", "TraceSession", "active_session", "add_span_event",
    "attach", "current_context", "current_span", "record_span", "span",
    "tracing_session",
]
