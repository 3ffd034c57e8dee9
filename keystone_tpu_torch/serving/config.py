"""Serving-layer request/config types and error taxonomy.

A copy of ``keystone_tpu/serving/config.py`` (stdlib only).

Error messages reuse the grpc-style status prefixes that
``reliability.errors.classify_error`` keys on: a shed is ``UNAVAILABLE``
(a client MAY retry against another replica), a deadline expiry is
``DEADLINE_EXCEEDED`` (retrying the same request is pointless — the
client's budget is gone).
"""

from __future__ import annotations

import itertools
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


class ServingError(RuntimeError):
    """Base class for request-level serving failures."""


class RequestShed(ServingError):
    """Admission control refused the request (queue at capacity across
    every shed-policy rung). The request was never enqueued."""

    def __init__(self, detail: str):
        super().__init__(f"UNAVAILABLE: request shed by admission control ({detail})")


class RequestTimeout(ServingError):
    """The request's deadline expired before (or during) batch assembly."""

    def __init__(self, detail: str):
        super().__init__(f"DEADLINE_EXCEEDED: request deadline expired ({detail})")


class ServerClosed(ServingError):
    """submit() after stop(): the server is no longer accepting work."""

    def __init__(self):
        super().__init__("server is stopped: no new requests accepted")


class UnknownModel(ServingError):
    """The named model has no published version in the registry."""

    def __init__(self, name: str, known):
        super().__init__(f"no model {name!r} in registry (known: {sorted(known)})")


def parse_stdin_request(
    obj: Any, default_deadline_s: Optional[float] = None
) -> Tuple[Any, Any, Optional[float], Optional[str], Optional[str]]:
    """One decoded stdin/JSON request line (dict or bare array) →
    ``(request_id, x, deadline_s, key, model)`` — the JAX package's
    parser for its serve doors, so the line contract is the same.
    ``deadline_ms`` is ``is not None``-checked, never truthiness: 0 is an
    exhausted budget that must time out, not fall through to the default.
    Raises ValueError on a malformed ``deadline_ms``."""
    if not isinstance(obj, dict):
        return None, obj, default_deadline_s, None, None
    raw_deadline = obj.get("deadline_ms")
    if raw_deadline is None:
        deadline_s = default_deadline_s
    else:
        try:
            deadline_s = float(raw_deadline) / 1e3
        except (TypeError, ValueError):
            raise ValueError(
                f"deadline_ms must be a number, got {raw_deadline!r}"
            ) from None
    key = str(obj["key"]) if "key" in obj else None
    return obj.get("id"), obj.get("x"), deadline_s, key, obj.get("model")


def settle_result(future: Future, value: Any) -> None:
    """set_result tolerating an already-settled future (a request can be
    raced by shutdown settling — exactly one outcome wins, never a crash
    in the worker)."""
    try:
        future.set_result(value)
    except Exception:
        pass


def settle_exception(future: Future, exc: Exception) -> None:
    try:
        future.set_exception(exc)
    except Exception:
        pass


def default_bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and including) ``max_batch``: the static batch
    shapes the apply path runs at. A partial batch pads up to the next
    bucket, so after warming len(buckets) shapes no request size meets a
    cold shape (on the card: no new cuFFT plan)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket that holds ``n`` rows (buckets must be sorted)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


@dataclass(frozen=True)
class ServingConfig:
    """Knobs for one :class:`~keystone_tpu_torch.serving.server.PipelineServer`.

    max_batch       — largest micro-batch assembled (also the top bucket).
    max_wait_ms     — how long an incomplete batch waits for more requests
                      before dispatching (measured from the moment the
                      batch's first request is seen by the assembler).
    queue_depth     — bounded request queue; admission control sheds above
                      it (never unbounded queueing).
    bucket_sizes    — static batch shapes to pad to; default powers of two
                      up to max_batch.
    default_deadline_s — per-request deadline when submit() passes none
                      (None = requests never expire in queue).
    telemetry_window — latency samples kept for percentile snapshots.
    log_interval_s  — minimum seconds between periodic telemetry log lines.
    """

    max_batch: int = 8
    max_wait_ms: float = 2.0
    queue_depth: int = 64
    bucket_sizes: Optional[Tuple[int, ...]] = None
    default_deadline_s: Optional[float] = None
    telemetry_window: int = 2048
    log_interval_s: float = 30.0
    retry_policy: Optional[Any] = None  # reliability.RetryPolicy (or None)

    def buckets(self) -> Tuple[int, ...]:
        out = self.bucket_sizes or default_bucket_sizes(self.max_batch)
        out = tuple(sorted(set(int(b) for b in out)))
        if out[-1] < self.max_batch:
            out = out + (self.max_batch,)
        return out


_request_ids = itertools.count(1)


@dataclass
class Request:
    """One in-flight inference request."""

    payload: Any
    model: str
    future: Future = field(default_factory=Future)
    deadline: Optional[Any] = None  # reliability.Deadline
    enqueued_at: float = field(default_factory=time.monotonic)
    request_id: int = field(default_factory=lambda: next(_request_ids))
    # Trace handoff (obs.spans): set at submit time only when a span
    # session is active, so the worker thread can parent this request's
    # spans under the submitter's trace. (trace_id, span_id) + the
    # perf_counter submit timestamp.
    trace_ctx: Optional[Any] = None
    trace_start_s: Optional[float] = None

    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired()
