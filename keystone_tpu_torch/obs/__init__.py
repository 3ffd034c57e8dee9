"""Observability, copied from ``keystone_tpu/obs/``.

- :mod:`.spans`   — hierarchical spans with trace ids, attributes, events
  and cross-thread context handoff; free when no session is active.
- :mod:`.metrics` — the process-wide registry of labeled counters,
  gauges and histograms, and the canonical ``percentile``.
- :mod:`.names`   — the stable names of the series the port publishes.

The serving layer and the recovery ledger publish into them. The
executor's and optimizer's spans and counters, device memory sampling,
the exporters and the profile store are not ported yet.
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
