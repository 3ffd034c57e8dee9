"""The publish/rollback controller: how a passing candidate reaches
traffic, and how a regressing one leaves it.

Port of ``keystone_tpu/refit/publish.py``'s single-process publisher,
:class:`InProcessPublisher`, over a live
:class:`~keystone_tpu_torch.serving.server.PipelineServer`: publish is a
registry hot-swap (in-flight batches finish on the entry they resolved)
followed by a re-warm of every bucket on the server's device, which
restamps the ``cufft_plans_since_warmup`` baseline — serving after a
settled publish meets no new shape.

Before any swap, the candidate passes the KV305 publish verifier
(:func:`~keystone_tpu_torch.workflow.verify.verify_refit_publish`): a
candidate whose per-row output spec or bucket set disagrees with the
incumbent's warmed buckets would meet cold shapes on live traffic —
warn-by-default, ``KEYSTONE_VERIFY=strict`` refuses the publish.

Rollback is an O(1) pointer swap to the registry's retained previous
version — no artifact re-load. Every publish and rollback lands in the
recovery ledger (``refit_publish`` / ``refit_rollback``) and the
``keystone_refit_*`` counters; the daemon's post-publish watch window
decides WHEN to roll back (refit/daemon.py).

``SupervisorPublisher``, the multi-worker fleet's publisher, is ROADMAP
Queue A item 13.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..obs import names as _names
from ..reliability.faultinject import probe
from ..reliability.recovery import get_recovery_log

logger = logging.getLogger(__name__)


@dataclass
class PublishTicket:
    """One publish, with everything rollback needs held in hand."""

    name: str
    version: Any
    prev_version: Any
    source: str
    acks: Dict[str, Any] = field(default_factory=dict)
    digest: Optional[str] = None
    prev_digest: Optional[str] = None
    published_at: float = field(default_factory=time.time)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "version": self.version,
            "prev_version": self.prev_version,
            "source": self.source,
            "acks": {k: dict(v) for k, v in self.acks.items()},
            "digest": self.digest,
        }


def _verify_publish(candidate, incumbent, example, buckets, warmed) -> None:
    """KV305 gate under the KEYSTONE_VERIFY enforcement: warn logs,
    strict raises VerificationError, off skips. An internal verifier
    crash never blocks a publish (only verified findings do)."""
    from ..workflow.verify import VerificationError, verification_mode, verify_refit_publish

    mode = verification_mode()
    if mode == "off":
        return
    try:
        report = verify_refit_publish(
            candidate, incumbent, example=example, buckets=buckets, warmed_buckets=warmed
        )
    except Exception:
        logger.warning("refit publish verification failed internally (ignored)", exc_info=True)
        return
    if not report.ok:
        for d in report.errors():
            logger.warning("refit publish verify: %s", d.render())
        if mode == "strict":
            raise VerificationError(report)


class InProcessPublisher:
    """Publish/rollback against a live :class:`PipelineServer`."""

    def __init__(self, server: Any, name: Optional[str] = None, example: Any = None, warm: bool = True):
        self.server = server
        self.name = name or server.default_model
        #: one request payload — drives the per-bucket re-warm after
        #: every publish/rollback (no example = no re-warm, the caller
        #: owns warming).
        self.example = example
        self.warm = warm
        self._m_publishes = _names.metric(_names.REFIT_PUBLISHES)
        self._m_rollbacks = _names.metric(_names.REFIT_ROLLBACKS)

    # ------------------------------------------------------------------ state
    def current_entry(self):
        return self.server.registry.resolve(self.name)

    def current_model(self):
        return self.current_entry().model

    def apply_live(self, x: np.ndarray) -> np.ndarray:
        """Predictions of the LIVE (currently published) version on the
        server's device — the watch window scores exactly what traffic is
        being served by."""
        from ..data.dataset import ArrayDataset

        out = self.current_entry().batch_apply(
            ArrayDataset(np.asarray(x, np.float32), device=self.server.device)
        )
        data = getattr(out, "data", out)
        if isinstance(data, torch.Tensor):
            data = data.cpu().numpy()
        return np.asarray(data)[: np.asarray(x).shape[0]]

    def serving_stats(self) -> Dict[str, Any]:
        return self.server.stats()

    def settle(self) -> None:
        """End-of-round baseline restamp: shapes met by refit-side work
        (shadow/watch scoring at their own batch sizes) land before this,
        so serving-only traffic between rounds reads
        ``cufft_plans_since_warmup == 0``."""
        restamp = getattr(self.server, "restamp_compile_baseline", None)
        if restamp is not None:
            restamp()

    # ---------------------------------------------------------------- publish
    def publish(self, candidate: Any, round_index: int = 0) -> PublishTicket:
        probe("refit.publish")
        incumbent = self.current_entry()
        _verify_publish(
            candidate,
            incumbent.model,
            self.example,
            self.server.config.buckets(),
            self.server.telemetry.warmed_buckets(),
        )
        entry = self.server.registry.publish(self.name, candidate, source=f"refit:round{round_index}")
        t0 = time.monotonic()
        if self.warm and self.example is not None:
            # The in-process re-warm "ack": every bucket driven through
            # the new version, plan baseline restamped.
            self.server.warmup(self.example, models=[self.name])
        ticket = PublishTicket(
            name=self.name,
            version=entry.version,
            prev_version=incumbent.version,
            source=entry.source,
            acks={
                "in-process": {
                    "kind": "swapped",
                    "version": entry.version,
                    "warmup_s": round(time.monotonic() - t0, 3),
                }
            },
        )
        self._m_publishes.inc()
        get_recovery_log().record(
            "refit_publish",
            self.name,
            version=entry.version,
            prev_version=incumbent.version,
            round=round_index,
        )
        return ticket

    def rollback(self, ticket: PublishTicket, reason: str = "") -> Any:
        """O(1) pointer swap back to the retained previous version, then
        re-warm so rolled-back steady state meets no new shape either."""
        entry = self.server.registry.rollback(self.name, ticket.prev_version)
        if self.warm and self.example is not None:
            self.server.warmup(self.example, models=[self.name])
        self._m_rollbacks.inc()
        get_recovery_log().record(
            "refit_rollback",
            self.name,
            from_version=ticket.version,
            to_version=entry.version,
            reason=reason,
        )
        return entry


__all__ = ["InProcessPublisher", "PublishTicket"]
