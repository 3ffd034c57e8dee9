"""Shared diagnostic type + severity handling for the static tier.

Copied from ``keystone_tpu/diagnostics.py``. One reporting path for all
three static analyzers:

- plan-time graph verification (``workflow/verify.py``, KV1xx-KV4xx) —
  diagnostics anchored to graph *nodes*;
- keystone-lint (``lint/rules.py``, KV5xx) — findings anchored to
  *source locations* (path:line);
- concurrency analysis (``lint/concurrency.py``, KV6xx) — findings
  anchored to source locations, carrying lock/thread details.

There is exactly one :class:`Diagnostic`; the lint package keeps
``Finding`` as a thin subclass (``Finding(rule, path, line, message)``,
``rule`` aliases ``code``) whose JSON is the ``check`` command's. The
``render()`` and ``to_json()`` shapes are the JAX package's, so reports
of the two packages compare field for field.

Stdlib-only: the lint half must be importable (and runnable) without
torch, so nothing here may import beyond the standard library.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: Ordered for worst-of reductions (CI gates fail on ERROR only).
SEVERITY_ORDER = (INFO, WARNING, ERROR)


def worst_severity(severities) -> str:
    """The most severe of ``severities`` (INFO when empty)."""
    worst = INFO
    for severity in severities:
        if SEVERITY_ORDER.index(severity) > SEVERITY_ORDER.index(worst):
            worst = severity
    return worst


@dataclass
class Diagnostic:
    """One finding from any static-tier analyzer.

    ``node`` anchors graph diagnostics; ``path``/``line`` anchor source
    diagnostics. ``details`` carries machine-readable specifics (reason
    keys, lock names, cycle paths) for the ``--json`` consumers.
    """

    code: str
    severity: str
    message: str
    node: Optional[str] = None
    path: Optional[str] = None
    line: Optional[int] = None
    details: Dict[str, Any] = field(default_factory=dict)

    def render(self) -> str:
        if self.path is not None:
            where = f"{self.path}:{self.line}" if self.line else self.path
            return f"{where}: {self.code} {self.message}"
        where = f" [{self.node}]" if self.node else ""
        return f"{self.code} {self.severity}{where}: {self.message}"

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
        }
        if self.node is not None:
            out["node"] = self.node
        if self.path is not None:
            out["path"] = self.path
            out["line"] = self.line
        if self.details:
            out["details"] = self.details
        return out
