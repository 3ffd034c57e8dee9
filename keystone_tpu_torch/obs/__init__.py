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

The serving layer, the recovery ledger, the executor (node counters,
``optimize`` span, ``node:<label>`` spans and the node-seconds histogram
under ``trace()``), the optimizer's rule counters and spans, and the
block solver publish into them. Device memory sampling, the exporters,
the flight recorder and the cost observatory are not ported yet.
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
