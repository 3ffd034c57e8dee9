"""Exporters: Prometheus text exposition, and the JSON-safe attribute
values span fragments carry.

The part of ``keystone_tpu/obs/export.py`` the fleet plane reads
(:mod:`.fleet`): the frontend's ``GET /metrics`` body and the span
attributes of the merged fleet trace. The single-process Chrome trace
and the span report arrive with the port's ``profile`` and ``trace``
commands (ROADMAP item 13b).

Prometheus format follows the text exposition rules: ``# HELP`` /
``# TYPE`` headers for every registered metric (including zero-series
ones — an exported schema with no samples is itself information),
histograms as cumulative ``_bucket{le=...}`` plus ``_sum``/``_count``.
"""

from __future__ import annotations

from typing import Any, List, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry


def _json_safe(value: Any) -> Any:
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(key, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition of every registered metric."""
    registry = registry or get_registry()
    lines: List[str] = []
    for metric in registry.collect():
        lines.append(f"# HELP {metric.name} {metric.help or metric.name}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        series = metric.series()
        if isinstance(metric, Histogram):
            for key, s in sorted(series.items()):
                cumulative = 0
                for bound, count in zip(metric.buckets, s.bucket_counts):
                    cumulative += count
                    le = 'le="%r"' % (bound,)
                    lines.append(f"{metric.name}_bucket{_fmt_labels(key, le)} {cumulative}")
                cumulative += s.bucket_counts[-1]
                inf = 'le="+Inf"'
                lines.append(f"{metric.name}_bucket{_fmt_labels(key, inf)} {cumulative}")
                lines.append(f"{metric.name}_sum{_fmt_labels(key)} {repr(float(s.sum))}")
                lines.append(f"{metric.name}_count{_fmt_labels(key)} {s.count}")
        elif isinstance(metric, (Counter, Gauge)):
            if not series and not metric.label_names:
                lines.append(f"{metric.name} 0")
            for key, value in sorted(series.items()):
                lines.append(f"{metric.name}{_fmt_labels(key)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"
