"""Adaptive micro-batcher: bounded queue + deadline-aware batch assembly.

A copy of ``keystone_tpu/serving/batcher.py``. The serving replacement
for the batch executor's whole-dataset pulls: requests arrive one datum
at a time, and latency comes from three places —
queue wait, assembly wait (holding an incomplete batch open for more
arrivals), and apply. Assembly policy:

- dispatch IMMEDIATELY when ``max_batch`` requests are waiting;
- otherwise hold the batch open at most ``max_wait_s`` measured from the
  first request in the batch;
- never hold past the earliest deadline of a queued request — a batch
  closes early rather than expiring its own members;
- requests whose deadline has already expired are failed with
  :class:`RequestTimeout` at assembly time (they never reach the device).

The queue is strictly bounded (``capacity``); ``offer`` refuses above it.
Deciding WHEN to refuse earlier than hard-full is admission control's job
(:mod:`keystone_tpu_torch.serving.admission`), not the batcher's.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

from .config import (
    Request,
    RequestTimeout,
    settle_exception as _settle_exception,
)


class MicroBatcher:
    """Bounded FIFO of :class:`Request` with batch assembly."""

    def __init__(
        self,
        capacity: int,
        clock: Callable[[], float] = time.monotonic,
        on_expired: Optional[Callable[[Request], None]] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._on_expired = on_expired
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.enqueued = 0
        self.refused = 0
        self.expired = 0

    # ---------------------------------------------------------------- enqueue
    def offer(self, request: Request) -> bool:
        """Enqueue; False when the queue is at capacity (caller sheds)."""
        with self._not_empty:
            if len(self._items) >= self.capacity:
                self.refused += 1
                return False
            self._items.append(request)
            self.enqueued += 1
            self._not_empty.notify()
            return True

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    # --------------------------------------------------------------- assembly
    def _fail_expired_locked(self) -> None:
        """Drop queued requests whose deadline already passed (queue-order
        scan; caller holds the lock)."""
        kept: deque = deque()
        while self._items:
            req = self._items.popleft()
            if req.expired():
                self.expired += 1
                # settle-once helper: tolerate futures already settled by
                # shutdown races.
                _settle_exception(
                    req.future,
                    RequestTimeout(f"expired in queue (request {req.request_id})"),
                )
                if self._on_expired is not None:
                    self._on_expired(req)
            else:
                kept.append(req)
        self._items = kept

    def _min_deadline_remaining_locked(self) -> Optional[float]:
        remaining = [
            r.deadline.remaining() for r in self._items if r.deadline is not None
        ]
        return min(remaining) if remaining else None

    def next_batch(
        self,
        max_batch: int,
        max_wait_s: float,
        stop: Optional[threading.Event] = None,
        poll_s: float = 0.05,
        deadline_margin_s: float = 0.02,
    ) -> List[Request]:
        """Assemble the next micro-batch (empty list only when ``stop`` is
        set and the queue is drained). A queued member's deadline closes
        the batch ``deadline_margin_s`` EARLY — dispatching just under the
        wire would lose the race between assembly and expiry."""
        # Phase 1: wait for the first request.
        with self._not_empty:
            while True:
                self._fail_expired_locked()
                if self._items:
                    break
                if stop is not None and stop.is_set():
                    return []
                self._not_empty.wait(poll_s)
            first_seen = self._clock()

        # Phase 2: hold the batch open for more arrivals.
        while True:
            with self._not_empty:
                self._fail_expired_locked()
                if len(self._items) >= max_batch:
                    break
                if stop is not None and stop.is_set():
                    break  # draining: ship whatever is here
                wait_left = max_wait_s - (self._clock() - first_seen)
                if wait_left <= 0:
                    break
                min_deadline = self._min_deadline_remaining_locked()
                if min_deadline is not None:
                    if min_deadline <= deadline_margin_s:
                        break  # ship now: holding longer expires a member
                    wait_left = min(wait_left, min_deadline - deadline_margin_s)
                self._not_empty.wait(min(wait_left, poll_s))

        with self._not_empty:
            self._fail_expired_locked()
            batch = [self._items.popleft() for _ in range(min(max_batch, len(self._items)))]
        return batch

    # ------------------------------------------------------------------ drain
    def fail_all(self, exc: Exception) -> int:
        """Fail every queued request (server shutdown without drain)."""
        with self._not_empty:
            n = len(self._items)
            while self._items:
                _settle_exception(self._items.popleft().future, exc)
        return n
