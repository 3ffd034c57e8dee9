"""Retry engine: classified retries, exponential backoff with deterministic
jitter, and per-call execution deadlines. A copy of
``keystone_tpu/reliability/retry.py``.

The replacement for Spark's task-level retry (``spark.task.maxFailures``)
that the reference leaned on: here the unit of retry is one graph-node
forcing (or any callable), the decision to retry comes from
``errors.classify_error``, and hung work — which Spark's scheduler would
have speculatively re-launched — is bounded by a deadline watchdog.

Jitter is drawn from a ``random.Random`` seeded per ``call`` (policy
``seed``), so a backoff schedule is reproducible in tests and two policies
with different seeds decorrelate their retry storms in production.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, List, Optional, Tuple

from .errors import DeadlineExceeded, ErrorClass, classify_error
from .recovery import get_recovery_log


class Deadline:
    """A fixed point in (monotonic) time work must finish by."""

    def __init__(self, seconds: float, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._expires = clock() + seconds

    @classmethod
    def after(cls, seconds: float, **kw) -> "Deadline":
        return cls(seconds, **kw)

    def remaining(self) -> float:
        return self._expires - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


def run_with_deadline(fn: Callable[[], Any], seconds: float, label: str = "work") -> Any:
    """Run ``fn()`` in a watchdog-joined worker thread; raise
    :class:`DeadlineExceeded` if it runs past ``seconds``.

    Python can't kill a thread, so on timeout the worker is abandoned
    (daemon) — same contract as a hung device dispatch: the caller moves on,
    the stuck work dies with the process. Use only around units of work
    whose results are idempotent to recompute (graph-node forcings are).
    """
    box: List[Any] = []
    error: List[BaseException] = []

    def worker():
        try:
            box.append(fn())
        except BaseException as e:  # propagated below, incl. KeyboardInterrupt
            error.append(e)

    t = threading.Thread(target=worker, daemon=True, name=f"deadline-{label}")
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise DeadlineExceeded(
            f"{label}: execution deadline of {seconds:g}s exceeded (worker abandoned)"
        )
    if error:
        raise error[0]
    return box[0]


def wait_until(
    predicate: Callable[[], Any],
    deadline: Deadline,
    interval: float = 0.1,
    label: str = "condition",
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Poll ``predicate`` until it returns truthy; :class:`DeadlineExceeded`
    if the deadline passes first — the generic poll-with-deadline
    primitive for launch scripts and external-resource waits."""
    while True:
        value = predicate()
        if value:
            return value
        left = deadline.remaining()
        if left <= 0:
            raise DeadlineExceeded(f"{label}: not satisfied within deadline")
        sleep(min(interval, max(left, 0.0)))


@dataclass(frozen=True)
class RetryPolicy:
    """Classified retry with exponential backoff.

    ``retry_on`` defaults to transient + deadline failures only: retrying an
    OOM at the same shape re-OOMs (that's ``DegradationLadder``'s job), and
    permanent errors must propagate on the first attempt.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.25  # ± fraction of the computed delay
    seed: Optional[int] = 0  # None → nondeterministic jitter
    retry_on: Tuple[ErrorClass, ...] = (ErrorClass.TRANSIENT, ErrorClass.DEADLINE)
    deadline_s: Optional[float] = None  # per-attempt execution deadline
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def with_(self, **kw) -> "RetryPolicy":
        return replace(self, **kw)

    def backoff_schedule(self, attempts: Optional[int] = None) -> List[float]:
        """The delays ``call`` would sleep between attempts — deterministic
        for a given seed, so tests can assert it and operators can read it."""
        rng = random.Random(self.seed)
        n = (attempts if attempts is not None else self.max_attempts) - 1
        return [self._delay(i, rng) for i in range(max(n, 0))]

    def _delay(self, retry_index: int, rng: random.Random) -> float:
        delay = min(self.base_delay_s * (self.multiplier**retry_index), self.max_delay_s)
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(delay, 0.0)

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        label: str = None,
        deadline: Optional[Deadline] = None,
        **kwargs: Any,
    ) -> Any:
        """Invoke ``fn(*args, **kwargs)`` under this policy.

        Each attempt runs under ``deadline_s`` (when set). A failure is
        classified; classes outside ``retry_on`` — and the final attempt —
        re-raise unchanged. Retries are recorded in the recovery log.

        ``deadline`` bounds the WHOLE retry loop by the caller's budget:
        once backing off + retrying cannot finish inside what remains of
        the deadline, the last error re-raises instead of retrying past
        it (a serving request's retry clock must never outlive the
        request). The retry budget and the per-attempt
        ``deadline_s`` watchdog compose: one bounds attempts, the other
        bounds the loop.
        """
        label = label or getattr(fn, "__name__", "call")
        rng = random.Random(self.seed)
        for attempt in range(1, self.max_attempts + 1):
            try:
                if self.deadline_s is not None:
                    return run_with_deadline(
                        lambda: fn(*args, **kwargs), self.deadline_s, label=label
                    )
                return fn(*args, **kwargs)
            except BaseException as exc:
                error_class = classify_error(exc)
                if error_class not in self.retry_on or attempt >= self.max_attempts:
                    raise
                delay = self._delay(attempt - 1, rng)
                if deadline is not None and deadline.remaining() <= delay:
                    get_recovery_log().record(
                        "retry_abandoned",
                        label,
                        attempt=attempt,
                        error_class=error_class.value,
                        remaining_s=round(max(deadline.remaining(), 0.0), 4),
                        delay_s=round(delay, 4),
                    )
                    raise
                get_recovery_log().record(
                    "retry",
                    label,
                    attempt=attempt,
                    error_class=error_class.value,
                    error=f"{type(exc).__name__}: {exc}"[:200],
                    delay_s=round(delay, 4),
                )
                self.sleep(delay)
