"""The publish/rollback controller: how a passing candidate reaches
traffic, and how a regressing one leaves it.

Port of ``keystone_tpu/refit/publish.py``. Two publishers, one per
serving runtime:

- :class:`InProcessPublisher` over a live
  :class:`~keystone_tpu_torch.serving.server.PipelineServer`;
- :class:`SupervisorPublisher` over a
  :class:`~keystone_tpu_torch.serving.supervisor.WorkerSupervisor`
  fleet: the candidate is persisted to a
  :class:`~keystone_tpu_torch.reliability.checkpoint.CheckpointStore`
  under a content digest and the fleet swaps to it by the swap broadcast
  (each worker loads the entry onto its own card, re-warms every bucket
  and acks with its ``warmup_s``); rollback swaps back to the previous
  digest, and restarted workers come up on whatever the fleet serves.

In process, publish is a registry hot-swap (in-flight batches finish on the entry they resolved)
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

"""

from __future__ import annotations

import hashlib
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


class SupervisorPublisher:
    """Publish/rollback across a :class:`WorkerSupervisor` fleet via the
    checkpoint store + swap broadcast (per-worker re-warm acks)."""

    def __init__(
        self,
        supervisor: Any,
        store_path: str,
        name: Optional[str] = None,
        incumbent: Any = None,
        incumbent_digest: Optional[str] = None,
        device: Any = None,
    ):
        from ..reliability.checkpoint import CheckpointStore

        self.supervisor = supervisor
        self.store = CheckpointStore(store_path, device=device)
        self.name = name or supervisor.config.model_name
        #: the daemon fits candidates in THIS process; the incumbent
        #: model object is tracked here for shadow eval (workers hold
        #: their own copies loaded from the store).
        self._current = incumbent
        self._current_digest = incumbent_digest
        self._prev = incumbent
        self._version = 0
        self._m_publishes = _names.metric(_names.REFIT_PUBLISHES)
        self._m_rollbacks = _names.metric(_names.REFIT_ROLLBACKS)

    def current_model(self):
        return self._current

    def serving_stats(self) -> Dict[str, Any]:
        return self.supervisor.stats()

    def apply_live(self, x: np.ndarray) -> np.ndarray:
        """Live predictions through the FLEET (real served traffic)."""
        futures = self.supervisor.submit_many(
            [row.tolist() for row in np.asarray(x, np.float32)],
            deadline_s=30.0,
        )
        return np.asarray([f.result(timeout=60.0) for f in futures])

    def _persist(self, candidate: Any, tag: str) -> str:
        from ..reliability.checkpoint import _value_token

        # Content-addressed like every other store entry: a digest built
        # from (name, round) alone would collide across daemon restarts —
        # a new run's round-1 candidate would OVERWRITE the entry the
        # previous ticket's rollback points at. The content token reads
        # tensors by their host bytes, whatever device holds them.
        content = hashlib.sha1(repr(_value_token(candidate)).encode()).hexdigest()
        digest = hashlib.sha1(f"refit-candidate:{self.name}:{tag}:{content}".encode()).hexdigest()
        if not self.store.save(None, candidate, digest=digest):
            raise RuntimeError(
                f"checkpoint store refused refit candidate {tag!r} "
                f"(unpicklable model of type {type(candidate).__name__})"
            )
        return digest

    def _swap_to(self, digest: str) -> Dict[str, Dict[str, Any]]:
        spec = {"checkpoint_dir": self.store.path, "digest": digest}
        acks = self.supervisor.swap(spec, name=self.name)
        swapped = [a for a in acks.values() if a.get("kind") == "swapped"]
        if acks and not swapped:
            raise RuntimeError(f"no worker acked the swap: {acks}")
        # Restarts must come up on what the fleet is serving NOW.
        self.supervisor.spec = spec
        return acks

    def publish(self, candidate: Any, round_index: int = 0) -> PublishTicket:
        probe("refit.publish")
        _verify_publish(candidate, self._current, None, None, None)
        digest = self._persist(candidate, f"round{round_index}")
        acks = self._swap_to(digest)
        self._version += 1
        ticket = PublishTicket(
            name=self.name,
            version=self._version,
            prev_version=self._version - 1,
            source=f"refit:round{round_index}",
            acks=acks,
            digest=digest,
            prev_digest=self._current_digest,
        )
        self._prev = self._current
        self._current = candidate
        self._current_digest = digest
        self._m_publishes.inc()
        get_recovery_log().record(
            "refit_publish",
            self.name,
            digest=digest[:12],
            round=round_index,
            acked=len([a for a in acks.values() if a.get("kind") == "swapped"]),
        )
        return ticket

    def rollback(self, ticket: PublishTicket, reason: str = "") -> Any:
        if ticket.prev_digest is None:
            raise RuntimeError("no previous digest retained — cannot roll the fleet back")
        acks = self._swap_to(ticket.prev_digest)
        self._current = self._prev
        self._current_digest = ticket.prev_digest
        self._m_rollbacks.inc()
        get_recovery_log().record(
            "refit_rollback",
            self.name,
            to_digest=ticket.prev_digest[:12],
            reason=reason,
            acked=len([a for a in acks.values() if a.get("kind") == "swapped"]),
        )
        return self._current


__all__ = ["InProcessPublisher", "PublishTicket", "SupervisorPublisher"]
