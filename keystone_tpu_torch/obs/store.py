"""Persistent profile store: measurements that survive the process.

A copy of ``keystone_tpu/obs/store.py``. A JSON-lines store of
per-subsystem observations, keyed so an observation is only ever reused
where it is valid:

    (key, shape_class, backend)

- ``key`` — what was measured, a namespaced string
  (``solver:block_ls:bs<b>:prec<mode>``, ``blocksparse:threshold``).
- ``shape_class`` — the input scale bucket (:func:`shape_class`): row
  count bucketed to the next power of two plus exact trailing dims and
  dtype, so a measurement taken at n=100k is not applied to n=10.
- ``backend`` — ``cuda`` or ``cpu``: device economics differ.

Every entry additionally carries an **environment fingerprint** (torch
version, backend, device kind — :func:`environment_fingerprint`). A
fingerprint mismatch at lookup time invalidates the entry, counted in
``keystone_profile_store_invalidations_total``; an entry written by the
JAX package (its ``jax`` field, a TPU or CPU backend) is one.

Durability/concurrency contract:

- Appends are single JSON lines under an exclusive ``flock`` on a
  sidecar lock file, so two processes recording the same key
  interleave whole lines, never torn ones; readers additionally skip
  unparseable lines, so even a torn write (crash mid-append) degrades to
  a missed observation, not a corrupt store.
- **Merge-on-write compaction**: when the file outgrows its bound, the
  whole file is re-read under the lock (picking up other processes'
  appends), merged newest-wins per key, evicted LRU-by-write down to
  ``max_entries``, and atomically replaced (tmp + rename).

Consumers in the port: ``ops/cuda/blocksparse.density_threshold`` reads
the tuned ``blocksparse:threshold`` per rows bucket, and the block
solver records ``solver:block_ls…`` observations after each fit. (The
JAX package's other consumers — the auto-cache planner, the measured-knob
rule and bench-diff — are not ported yet.)

Env knobs:
  KEYSTONE_PROFILE_STORE        off|0|disabled → disabled entirely;
                                a path → store file location; unset →
                                ~/.cache/keystone_tpu_torch/profile-store.jsonl
  KEYSTONE_PROFILE_STORE_MAX    max entries kept at compaction (4096)

Stdlib-only at import; torch is imported for the environment
fingerprint only.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..envknobs import env_disabled, env_int, env_str
from . import names as _names

logger = logging.getLogger(__name__)

_DEFAULT_MAX_ENTRIES = 4096
# Compact (merge + evict + rewrite) once this many lines have been
# appended beyond the loaded snapshot — bounds file growth at roughly
# loaded + slack without paying a rewrite per observation.
_COMPACT_SLACK = 256

#: Provenance prefix written onto an entry whose predictions stopped
#: matching reality (the JAX package's cost-observatory drift sentinel
#: writes it; :meth:`ProfileStore.mark_stale`). A ``stale:`` entry is
#: skipped by ``lookup``/``entries`` (counted as a miss) so consumers
#: re-measure instead of replaying it; the fresh measurement's
#: ``record()`` overwrites the mark.
STALE_PREFIX = "stale:"


def is_stale(measurements: Dict[str, Any]) -> bool:
    return str(measurements.get("source", "")).startswith(STALE_PREFIX)


# ------------------------------------------------------------- shape classes


def shape_class(rows: int, dims: Tuple[int, ...] = (), dtype: Any = None) -> str:
    """Canonical shape-class string: row count bucketed to the next power
    of two (measurements transfer within a ~2× scale band), trailing dims
    exact, dtype name. ``shape_class(100_000, (768,), 'float32')`` →
    ``'n2^17|768|float32'``."""
    rows = max(1, int(rows))
    bucket = 1 << max(0, math.ceil(math.log2(rows)))
    parts = [f"n2^{bucket.bit_length() - 1}"]
    if dims:
        parts.append("x".join(str(int(d)) for d in dims))
    if dtype is not None:
        parts.append(str(getattr(dtype, "name", dtype)))
    return "|".join(parts)


def rows_bucket(shape: str) -> str:
    """The row-bucket component of a :func:`shape_class` string — the
    coarse match key when trailing dims are unknowable at plan time."""
    return shape.split("|", 1)[0]


def dataset_shape_class(dataset: Any) -> str:
    """Shape class of a Dataset's raw records: row count plus the first
    record's dims/dtype at TRANSFER width (what streaming uploads)."""
    import numpy as np

    try:
        rows = len(dataset)
    except Exception:
        return "n?"
    dims: Tuple[int, ...] = ()
    dtype = None
    try:
        from ..data.dataset import ArrayDataset, transfer_dtype
        from ..utils.tree import tree_leaves

        if isinstance(dataset, ArrayDataset):
            leaf = tree_leaves(dataset.data)[0]
            dims = tuple(leaf.shape[1:])
            dtype = transfer_dtype(np.dtype(str(leaf.dtype).replace("torch.", "")))
        else:
            first = np.asarray(dataset.take(1)[0])
            dims, dtype = tuple(first.shape), transfer_dtype(first.dtype)
    except Exception:
        pass
    return shape_class(rows, dims, dtype)


# -------------------------------------------------------------- fingerprint

_fp_cache: Optional[Dict[str, str]] = None
_fp_lock = threading.Lock()


def environment_fingerprint() -> Dict[str, str]:
    """What must match for a stored measurement to still be believable:
    the torch version, the backend (``cuda`` when a card is present, else
    ``cpu``) and the device kind (the card's name). Cached after first
    computation. An entry the JAX package wrote carries a ``jax`` field
    and a TPU or CPU backend, so it never matches: a TPU measurement says
    nothing about this card."""
    global _fp_cache
    if _fp_cache is not None:
        return _fp_cache
    with _fp_lock:
        if _fp_cache is not None:
            return _fp_cache
        import torch

        fp = {"torch": str(torch.__version__), "backend": "cpu", "device_kind": "cpu"}
        if torch.cuda.is_available():
            fp["backend"] = "cuda"
            fp["device_kind"] = str(torch.cuda.get_device_name())
        _fp_cache = fp
        return fp


def _reset_fingerprint_cache() -> None:  # testing hook
    global _fp_cache
    with _fp_lock:
        _fp_cache = None


# --------------------------------------------------------------------- store


def _counter(name: str):
    return _names.metric(name)


class ProfileStore:
    """One JSON-lines profile store file with merge-on-write semantics.

    In-memory state is a dict keyed ``(key, shape, backend)`` holding the
    newest observation per key; the file may transiently hold multiple
    lines per key between compactions (newest ``seq`` wins on load).
    """

    def __init__(
        self,
        path: str,
        max_entries: Optional[int] = None,
        fingerprint: Optional[Dict[str, str]] = None,
    ):
        self.path = path
        self.max_entries = max_entries or env_int(
            "KEYSTONE_PROFILE_STORE_MAX", _DEFAULT_MAX_ENTRIES
        )
        self._fingerprint = fingerprint
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        self._seq = 0
        self._appended_since_load = 0
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.invalidations = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._load()

    # ------------------------------------------------------------- plumbing
    def fingerprint(self) -> Dict[str, str]:
        return self._fingerprint or environment_fingerprint()

    @property
    def _lock_path(self) -> str:
        return self.path + ".lock"

    def _flock(self):
        """Exclusive advisory lock context over the sidecar lock file —
        the cross-process serialization point for appends/compactions."""
        import contextlib

        @contextlib.contextmanager
        def locked():
            try:
                import fcntl

                fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o644)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                    yield
                finally:
                    fcntl.flock(fd, fcntl.LOCK_UN)
                    os.close(fd)
            except ImportError:  # non-POSIX: single-process best effort
                yield

        return locked()

    @staticmethod
    def _parse_line(line: str) -> Optional[Dict[str, Any]]:
        line = line.strip()
        if not line:
            return None
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return None  # torn write: a missed observation, not an error
        if not isinstance(rec, dict) or "k" not in rec or "s" not in rec:
            return None
        return rec

    def _load(self) -> None:
        """(Re)build the in-memory map from the file, newest-seq wins."""
        entries: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        max_seq = 0
        try:
            with open(self.path, "r") as f:
                for line in f:
                    rec = self._parse_line(line)
                    if rec is None:
                        continue
                    seq = int(rec.get("seq", 0))
                    max_seq = max(max_seq, seq)
                    ident = (rec["k"], rec["s"], str(rec.get("b", "")))
                    prev = entries.get(ident)
                    if prev is None or int(prev.get("seq", 0)) <= seq:
                        if prev is not None:
                            rec = dict(rec)
                            rec["obs"] = int(prev.get("obs", 1)) + 1
                        entries[ident] = rec
        except OSError:
            pass
        with self._lock:
            self._entries = entries
            self._seq = max_seq
            self._appended_since_load = 0
        _names.metric(_names.PROFILE_STORE_ENTRIES).set(len(entries))

    # --------------------------------------------------------------- writes
    def record(
        self,
        key: str,
        shape: str,
        backend: Optional[str] = None,
        **measurements: Any,
    ) -> None:
        """Append one observation (merge-on-write: the newest observation
        per (key, shape, backend) wins at read time; the per-key ``obs``
        count survives merges). Never raises — a broken store must not
        break a fit.

        Every entry carries a ``source`` provenance field in its
        measurements: ``"observed"`` (default — recorded passively by a
        fit that happened to run) vs ``"tune"`` (written by an active
        search, such as a tuned ``blocksparse:threshold``). Replayed and
        searched decisions stay distinguishable post-hoc."""
        backend = backend or self.fingerprint()["backend"]
        try:
            fields = {k: v for k, v in measurements.items() if v is not None}
            fields.setdefault("source", "observed")
            with self._lock:
                self._seq += 1
                rec = {
                    "k": key,
                    "s": shape,
                    "b": backend,
                    "m": fields,
                    "fp": self.fingerprint(),
                    "seq": self._seq,
                    "obs": 1,
                }
                prev = self._entries.get((key, shape, backend))
                if prev is not None:
                    rec["obs"] = int(prev.get("obs", 1)) + 1
                self._entries[(key, shape, backend)] = rec
                line = json.dumps(rec, sort_keys=True)
                self._appended_since_load += 1
                need_compact = (
                    len(self._entries) > self.max_entries
                    or self._appended_since_load >= _COMPACT_SLACK
                )
            with self._flock():
                with open(self.path, "a") as f:
                    f.write(line + "\n")
            with self._lock:
                # Stat counters share the state lock: record()/lookup()
                # run from serving and streaming threads concurrently,
                # and an unlocked += drops counts.
                self.writes += 1
            _counter(_names.PROFILE_STORE_WRITES).inc()
            _names.metric(_names.PROFILE_STORE_ENTRIES).set(len(self._entries))
            if need_compact:
                self.compact()
        except Exception as e:
            logger.warning("profile store write failed (%s)", e)

    def compact(self) -> None:
        """Merge the on-disk file (including other processes' appends)
        with this process's view, evict LRU-by-write past ``max_entries``,
        and atomically rewrite. Safe to call anytime."""
        try:
            with self._flock():
                # Re-read under the lock so concurrent appenders' lines
                # are merged, not clobbered. The snapshot of our own view
                # takes the thread lock: record() mutates _entries under
                # it, and an unlocked dict() copy can die mid-iteration.
                # No deadlock risk — record() never holds _lock while
                # taking the file lock.
                with self._lock:
                    ours = dict(self._entries)
                self._load()
                with self._lock:
                    for ident, rec in ours.items():
                        cur = self._entries.get(ident)
                        if cur is None or int(cur.get("seq", 0)) < int(
                            rec.get("seq", 0)
                        ):
                            self._entries[ident] = rec
                    ranked = sorted(
                        self._entries.items(),
                        key=lambda kv: int(kv[1].get("seq", 0)),
                    )
                    evicted = len(ranked) - self.max_entries
                    if evicted > 0:
                        for ident, _ in ranked[:evicted]:
                            del self._entries[ident]
                        _counter(_names.PROFILE_STORE_EVICTIONS).inc(evicted)
                    snapshot = [
                        self._entries[ident]
                        for ident, _ in ranked[max(evicted, 0):]
                    ]
                    self._seq = max(
                        [int(r.get("seq", 0)) for r in snapshot], default=0
                    )
                    self._appended_since_load = 0
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    for rec in snapshot:
                        f.write(json.dumps(rec, sort_keys=True) + "\n")
                os.replace(tmp, self.path)
            _names.metric(_names.PROFILE_STORE_ENTRIES).set(len(self._entries))
        except Exception as e:
            logger.warning("profile store compaction failed (%s)", e)

    # --------------------------------------------------------------- staleness
    def mark_stale(
        self,
        key: str,
        shape: str,
        backend: Optional[str] = None,
        reason: str = "cost_drift",
    ) -> bool:
        """Stamp ``stale:`` provenance onto an entry caught
        mis-predicting: the measurements survive for post-hoc inspection
        (``include_stale``), but ``lookup``/``entries`` stop serving
        them, so consumers re-measure. Returns True when an entry was
        newly marked."""
        backend = backend or self.fingerprint()["backend"]
        with self._lock:
            rec = self._entries.get((key, shape, backend))
        if rec is None:
            return False
        m = dict(rec.get("m", {}))
        if is_stale(m):
            return False  # already marked; one drift = one mark
        m["source"] = STALE_PREFIX + str(m.get("source", "observed"))
        m["stale_reason"] = reason
        self.record(key, shape, backend, **m)
        return True

    # ---------------------------------------------------------------- reads
    def lookup(
        self,
        key: str,
        shape: str,
        backend: Optional[str] = None,
        include_stale: bool = False,
    ) -> Optional[Dict[str, Any]]:
        """The newest valid measurements dict for (key, shape, backend),
        or None. Entries whose environment fingerprint no longer matches
        are invalidated (counted), never returned; ``stale:``-marked
        entries read as misses (the drift sentinel's contract: consumers
        must re-measure, not replay) unless ``include_stale``."""
        backend = backend or self.fingerprint()["backend"]
        fingerprint = self.fingerprint()
        # One critical section covers the fetch AND its stat counter:
        # record()/lookup() run from serving and streaming threads
        # concurrently, and an unlocked += drops counts; splitting fetch
        # from count would let a stats() snapshot see them inconsistent.
        with self._lock:
            rec = self._entries.get((key, shape, backend))
            if rec is None:
                self.misses += 1
                outcome = "miss"
            elif rec.get("fp") != fingerprint:
                self.invalidations += 1
                self.misses += 1
                outcome = "invalidated"
            elif not include_stale and is_stale(rec.get("m", {})):
                self.misses += 1
                outcome = "miss"
            else:
                self.hits += 1
                outcome = "hit"
                measurements = dict(rec.get("m", {}))
        if outcome == "miss":
            _counter(_names.PROFILE_STORE_MISSES).inc()
            return None
        if outcome == "invalidated":
            _counter(_names.PROFILE_STORE_INVALIDATIONS).inc()
            _counter(_names.PROFILE_STORE_MISSES).inc()
            return None
        _counter(_names.PROFILE_STORE_HITS).inc()
        return measurements

    def entries(
        self,
        key_prefix: str = "",
        shape: Optional[str] = None,
        rows: Optional[str] = None,
        backend: Optional[str] = None,
        any_env: bool = False,
        include_stale: bool = False,
    ) -> Iterator[Tuple[str, str, Dict[str, Any]]]:
        """Iterate valid (key, shape, measurements) tuples filtered by key
        prefix, exact shape class, or coarse rows bucket — the dispatch
        thresholds' query surface. Fingerprint-stale entries are skipped silently
        (invalidation is counted at lookup, the authoritative read), and
        drift-marked ``stale:`` entries are skipped unless
        ``include_stale`` (provenance reporting wants them; replay never
        does). ``any_env=True`` skips the fingerprint/backend filter —
        for provenance REPORTING only (a report must still see what
        another environment wrote), never for replay."""
        if not any_env:
            backend = backend or self.fingerprint()["backend"]
            fp = self.fingerprint()
        with self._lock:
            snapshot: List[Dict[str, Any]] = list(self._entries.values())
        for rec in snapshot:
            if not any_env and (
                str(rec.get("b", "")) != backend or rec.get("fp") != fp
            ):
                continue
            if not include_stale and is_stale(rec.get("m", {})):
                continue
            if key_prefix and not rec["k"].startswith(key_prefix):
                continue
            if shape is not None and rec["s"] != shape:
                continue
            if rows is not None and rows_bucket(rec["s"]) != rows:
                continue
            yield rec["k"], rec["s"], dict(rec.get("m", {}))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def by_source(self) -> Dict[str, int]:
        """Live entry counts per provenance source (``observed`` vs
        ``tune``): which decisions were searched vs merely replayed."""
        counts: Dict[str, int] = {}
        with self._lock:
            for rec in self._entries.values():
                src = str(rec.get("m", {}).get("source", "observed"))
                counts[src] = counts.get(src, 0) + 1
        return counts

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "path": self.path,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "writes": self.writes,
                "invalidations": self.invalidations,
            }


# ---------------------------------------------------------- process singleton

_store: Optional[ProfileStore] = None
_store_target: Optional[str] = None
_store_lock = threading.Lock()


def store_enabled() -> bool:
    return not env_disabled("KEYSTONE_PROFILE_STORE")


def default_store_path() -> str:
    """The store file location: ``KEYSTONE_PROFILE_STORE`` when it names
    a path, else ``~/.cache/keystone_tpu_torch/profile-store.jsonl``."""
    env = env_str("KEYSTONE_PROFILE_STORE")
    if env and env.lower() not in ("on", "1", "true"):
        return env
    root = os.path.join(os.path.expanduser("~"), ".cache", "keystone_tpu_torch")
    return os.path.join(root, "profile-store.jsonl")


def get_store() -> Optional[ProfileStore]:
    """The process-wide :class:`ProfileStore`, or None when disabled.
    Re-resolves when ``KEYSTONE_PROFILE_STORE`` changes (tests point it at
    per-test temp files)."""
    global _store, _store_target
    if not store_enabled():
        return None
    target = default_store_path()
    with _store_lock:
        if _store is None or _store_target != target:
            try:
                _store = ProfileStore(target)
                _store_target = target
            except Exception as e:
                logger.warning("profile store unavailable (%s)", e)
                return None
        return _store


def set_store(store: Optional[ProfileStore]) -> None:
    """Install a specific store instance (tests); None drops the
    singleton so the next :func:`get_store` re-resolves from env."""
    global _store, _store_target
    with _store_lock:
        _store = store
        _store_target = store.path if store is not None else None
