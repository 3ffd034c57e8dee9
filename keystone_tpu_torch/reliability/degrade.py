"""Degradation ladders: walk a sequence of progressively cheaper
configurations until one fits on the device. A copy of
``keystone_tpu/reliability/degrade.py``; the serving admission
controller is built on it.

One reusable component that solvers, pipelines and admission control
share: when the full-size configuration won't fit, take the best rung
that does and SAY SO — every degraded result carries ``reduced_from``
and ``reduction_reason`` so a reader can't mistake it for the full-size
run.

Memory discipline: between rungs the failed attempt's buffers must die
before the next allocation (holding both is itself an OOM source).
``run`` therefore keeps only the formatted error string, never the
exception object, so the attempt frame (and the device buffers its
locals pin) is freed when the except block ends.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence

from .errors import is_oom
from .recovery import get_recovery_log


class LadderExhausted(RuntimeError):
    """Every rung of a degradation ladder failed with a degradable error."""


def halving_rungs(full: int, floor: int, align: int = 1) -> List[int]:
    """The halving rung sequence the bench ladders walk: ``full``, then
    repeated halvings (each aligned DOWN to a multiple of ``align``),
    ending with the first value ≤ ``floor`` — that last rung still gets
    attempted; only a failure AT it exhausts the ladder."""
    if full <= 0:
        raise ValueError(f"halving_rungs: full={full} must be positive")
    rungs = [full]
    v = full
    while v > floor:
        v = v // 2
        v -= v % align
        if v <= 0:
            break
        rungs.append(v)
    return rungs


class DegradationLadder:
    """Run an attempt across rungs, degrading on OOM-class failures.

    ``rungs`` are opaque configs (ints, tuples, estimator factories — the
    attempt callable interprets them). After a successful ``run``,
    ``record`` describes what happened; ``annotate`` stamps the standard
    reduction fields onto a result dict.
    """

    def __init__(
        self,
        rungs: Sequence[Any],
        should_degrade: Callable[[BaseException], bool] = is_oom,
        label: str = "ladder",
        on_degrade: Optional[Callable[[Any, str], None]] = None,
    ):
        if not rungs:
            raise ValueError(f"{label}: empty rung list")
        self.rungs = list(rungs)
        self.should_degrade = should_degrade
        self.label = label
        self.on_degrade = on_degrade
        self.last_error: Optional[str] = None
        self.record: Dict[str, Any] = {}

    def run(self, attempt: Callable[[Any], Any]) -> Any:
        self.last_error = None
        for index, rung in enumerate(self.rungs):
            try:
                value = attempt(rung)
            except Exception as exc:
                if not self.should_degrade(exc):
                    raise
                # Keep the STRING only: holding `exc` (and its traceback's
                # frames) across the next rung pins the failed attempt's
                # buffers — see module docstring.
                self.last_error = f"{type(exc).__name__}: {exc}"
                if self.on_degrade is not None:
                    self.on_degrade(rung, self.last_error)
                continue
            self.record = {
                "rung": rung,
                "rung_index": index,
                "first_rung": self.rungs[0],
                "reduced": index > 0,
            }
            if index > 0:
                self.record["reduction_reason"] = (self.last_error or "")[:200]
                get_recovery_log().record(
                    "degrade",
                    self.label,
                    rung_index=index,
                    rung=_printable(rung),
                    first_rung=_printable(self.rungs[0]),
                    reason=self.record["reduction_reason"],
                )
            return value
        raise LadderExhausted(
            f"{self.label}: OOM at every ladder rung: {self.last_error}"
        )

    @property
    def reduced(self) -> bool:
        return bool(self.record.get("reduced"))

    def annotate(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Stamp the standard degradation fields onto a result dict (the
        bench convention: ``extrapolated`` + ``reduced_from`` +
        ``reduction_reason``)."""
        if self.reduced:
            out["extrapolated"] = True
            out["reduced_from"] = _printable(self.record["first_rung"])
            out["reduction_reason"] = self.record["reduction_reason"]
        return out


def _printable(rung: Any) -> Any:
    if isinstance(rung, (int, float, str, bool)) or rung is None:
        return rung
    if isinstance(rung, dict):
        return {k: _printable(v) for k, v in rung.items()}
    if isinstance(rung, (list, tuple)):
        return [_printable(v) for v in rung]
    if callable(rung):
        return getattr(rung, "__qualname__", type(rung).__name__)
    # Default reprs embed per-process addresses ("<... at 0x7f...>") —
    # strip them so recovery-log events compare equal across identical runs.
    return re.sub(r" at 0x[0-9a-fA-F]+", "", repr(rung))
