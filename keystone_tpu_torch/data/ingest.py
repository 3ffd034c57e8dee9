"""Host ingest: the bounded, ordered, multi-worker prefetch pipeline, and
the JPEG-tar fixture and ingest measurement of the image pipelines.

Port of ``keystone_tpu/data/ingest.py``: ``PrefetchQueue`` is the host
side of the streaming execution engine (``workflow/streaming.py``);
``build_jpeg_tar_fixture`` writes a tar of synthetic JPEGs in ImageNet's
``synset/image`` layout and ``measure_ingest`` streams a tar through the
native libjpeg decode.
"""

from __future__ import annotations

import io
import os
import tarfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from ..obs import names as _names
from ..obs import spans as _spans


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


def build_jpeg_tar_fixture(
    path: str,
    num_images: int,
    size: int = 256,
    quality: int = 87,
    seed: int = 0,
    deadline_left_fn: Optional[Callable[[], Optional[float]]] = None,
    deadline_margin_s: float = 60.0,
) -> str:
    """Write a tar of ``num_images`` synthetic JPEGs (block-textured so
    file sizes land near real photo entropy, ~20-40 KB at 256²), entries
    ``synset{i % 16:04d}/img_{i:06d}.JPEG``. Cached: an existing file at
    ``path`` with the right entry count is reused.

    ``deadline_left_fn`` makes the build time-budgeted: when fewer than
    ``deadline_margin_s`` seconds remain, the tar is finalized with the
    images written so far.
    """
    from PIL import Image

    if os.path.exists(path):
        try:
            with tarfile.open(path) as t:
                if sum(1 for m in t if m.isfile()) == num_images:
                    return path
        except tarfile.ReadError:
            pass
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.default_rng(seed)
    tmp = path + ".tmp"
    with tarfile.open(tmp, "w") as tar:
        for i in range(num_images):
            if deadline_left_fn is not None and i and i % 128 == 0:
                left = deadline_left_fn()
                if left is not None and left <= deadline_margin_s:
                    break  # finalize a partial (still valid) fixture
            # Low-res random field upsampled ×8 + noise: JPEG-compressible
            # structure, photo-like size on disk.
            low = rng.integers(0, 256, (size // 8, size // 8, 3), dtype=np.uint8)
            img = np.repeat(np.repeat(low, 8, axis=0), 8, axis=1)
            img = np.clip(
                img.astype(np.int16) + rng.integers(-12, 13, img.shape), 0, 255
            ).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=quality)
            data = buf.getvalue()
            info = tarfile.TarInfo(name=f"synset{i % 16:04d}/img_{i:06d}.JPEG")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    os.replace(tmp, path)
    return path


def measure_ingest(
    tar_path: str,
    resize: tuple = (256, 256),
    batch: int = 256,
    threads: Optional[int] = None,
    featurize: Optional[Callable[[np.ndarray], object]] = None,
    max_images: Optional[int] = None,
) -> Dict[str, float]:
    """Stream ``tar_path`` through the native decode kernel; returns
    images/s plus byte counts. With ``featurize`` given, decode of batch
    i+1 overlaps ``featurize(batch_i)`` (device work) through a one-slot
    pipeline, and the overlapped rate is reported separately. Builds the
    native decode library at first use; raises if it cannot."""
    from .. import native
    from .loaders.archive import iter_tar_entries, native_decode_batch

    lib = native.load("decode")
    if threads:
        lib.ks_set_threads(int(threads))

    t0 = time.perf_counter()
    done = 0
    corrupt = 0  # undecodable entries: quarantined, never abort the stream
    raw_bytes = 0
    pending = None  # in-flight featurize result to force
    decode_s = 0.0
    feat_wait_s = 0.0

    with _spans.span("ingest:read", source=tar_path):
        chunks: list = []
        chunk: list = []
        for _name, raw in iter_tar_entries(tar_path):
            chunk.append(raw)
            raw_bytes += len(raw)
            if len(chunk) == batch:
                chunks.append(chunk)
                chunk = []
                if max_images and len(chunks) * batch >= max_images:
                    break
        if chunk:
            chunks.append(chunk)

    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool, _spans.span(
        "ingest:decode", batches=len(chunks), overlapped=featurize is not None
    ):
        for c in chunks:
            td = time.perf_counter()
            images, ok = native_decode_batch(c, resize)
            decode_s += time.perf_counter() - td
            done += int(ok.sum())
            corrupt += len(c) - int(ok.sum())
            if featurize is not None:
                tw = time.perf_counter()
                if pending is not None:
                    pending.result()  # force the previous device batch
                feat_wait_s += time.perf_counter() - tw
                pending = pool.submit(featurize, images)
        if pending is not None:
            pending.result()
    total_s = time.perf_counter() - t0

    _names.metric(_names.INGEST_IMAGES).inc(done)
    _names.metric(_names.INGEST_BYTES).inc(raw_bytes)
    _names.metric(_names.INGEST_DECODE_SECONDS).inc(decode_s)
    if corrupt:
        from ..reliability.recovery import get_recovery_log

        _names.metric(_names.INGEST_CORRUPT).inc(corrupt)
        get_recovery_log().record("quarantine", "measure_ingest", count=corrupt, source=tar_path)
    out = {
        "images": done,
        "corrupt_skipped": corrupt,
        "tar_read_s": read_s,
        "decode_s": decode_s,
        "images_per_sec_decode": done / max(decode_s, 1e-9),
        "mb_per_sec_jpeg": raw_bytes / 1e6 / max(decode_s + read_s, 1e-9),
    }
    if featurize is not None:
        out["images_per_sec_overlapped"] = done / max(total_s, 1e-9)
        out["featurize_wait_s"] = feat_wait_s
    return out
