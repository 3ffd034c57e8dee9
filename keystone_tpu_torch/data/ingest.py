"""Host ingest: the bounded, ordered, multi-worker prefetch pipeline.

Port of ``PrefetchQueue`` from ``keystone_tpu/data/ingest.py``, the host
side of the streaming execution engine (``workflow/streaming.py``).
``build_jpeg_tar_fixture`` and ``measure_ingest`` wait for the image
ingest pipelines.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

from ..obs import names as _names


class PrefetchQueue:
    """Bounded, ordered, multi-worker host prefetch pipeline.

    ``workers`` threads pull raw items from ``source`` (under a lock —
    iterators aren't thread-safe), run ``prepare`` (decode, stack, copy
    into pinned memory: the work that releases the interpreter lock)
    concurrently, and publish results IN SOURCE ORDER into a depth-limited
    buffer. ``depth`` bounds the number of prepared-or-in-flight items,
    which is what keeps host memory O(chunk) instead of O(dataset): a
    fast producer blocks instead of ballooning.

    An exception from ``source`` or ``prepare`` is re-raised at the
    consumer in order, and ``close()`` (idempotent, called on ANY consumer
    exit, including a mid-stream estimator failure) unblocks and joins
    every worker, so no thread outlives the stream.
    """

    def __init__(
        self,
        source: Iterable[Any],
        prepare: Optional[Callable[[Any], Any]] = None,
        depth: int = 1,
        workers: Optional[int] = None,
        size_of: Optional[Callable[[Any], int]] = None,
        name: str = "stream",
    ):
        self._source = iter(source)
        self._prepare = prepare or (lambda x: x)
        self._depth = max(1, int(depth))
        self._size_of = size_of
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._buffer: Dict[int, tuple] = {}
        self._next_pull = 0
        self._next_emit = 0
        self._exhausted_at: Optional[int] = None
        self._closed = False
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.stall_s = 0.0
        self._sem = threading.Semaphore(self._depth)
        nworkers = max(1, workers if workers is not None else 1)
        self._threads = [
            threading.Thread(
                target=self._run, name=f"keystone-{name}-prefetch-{i}", daemon=True
            )
            for i in range(nworkers)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- workers
    def _run(self) -> None:
        depth_gauge = _names.metric(_names.STREAM_PREFETCH_DEPTH)
        while True:
            self._sem.acquire()
            with self._lock:
                if self._closed or self._exhausted_at is not None:
                    self._sem.release()
                    return
                seq = self._next_pull
                try:
                    item = next(self._source)
                except StopIteration:
                    self._exhausted_at = seq
                    self._cond.notify_all()
                    self._sem.release()
                    return
                except Exception as e:  # source error: surfaced in order
                    self._buffer[seq] = ("err", e, 0)
                    self._next_pull += 1
                    self._cond.notify_all()
                    continue
                self._next_pull += 1
            try:
                value = self._prepare(item)
                nbytes = int(self._size_of(value)) if self._size_of is not None else 0
                entry = ("ok", value, nbytes)
            except Exception as e:  # surfaced at the consumer, in order
                entry = ("err", e, 0)
            with self._lock:
                if self._closed:
                    return
                self._buffer[seq] = entry
                self.live_bytes += entry[2]
                self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
                depth_gauge.set(len(self._buffer))
                self._cond.notify_all()

    # ------------------------------------------------------------ consumer
    def __iter__(self):
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        depth_gauge = _names.metric(_names.STREAM_PREFETCH_DEPTH)
        with self._cond:
            while True:
                if self._closed:
                    raise RuntimeError("prefetch queue closed")
                if self._next_emit in self._buffer:
                    kind, value, nbytes = self._buffer.pop(self._next_emit)
                    self._next_emit += 1
                    self.live_bytes -= nbytes
                    depth_gauge.set(len(self._buffer))
                    waited = time.perf_counter() - t0
                    self.stall_s += waited
                    _names.metric(_names.STREAM_STALL_SECONDS).inc(waited)
                    self._sem.release()
                    if kind == "err":
                        raise value
                    return value
                if (
                    self._exhausted_at is not None
                    and self._next_emit >= self._exhausted_at
                ):
                    raise StopIteration
                self._cond.wait(0.05)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        for _ in self._threads:
            self._sem.release()  # unblock workers parked on the bound
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self) -> "PrefetchQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["PrefetchQueue"]
