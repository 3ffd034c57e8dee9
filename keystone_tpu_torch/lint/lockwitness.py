"""Lock witness: runtime cross-check of the static lock-order graph.

Port of ``keystone_tpu/lint/lockwitness.py``. The static model
(:mod:`.lockmodel`) claims to know every
acquired-while-holding edge the runtime can take. This module is the
counter-party that keeps it honest: an opt-in instrumented-lock wrapper
(``KEYSTONE_LOCK_WITNESS=1`` at test time) records the acquisition
orders threads ACTUALLY take, names each lock by matching its allocation
site against the static model's table, and fails the run when an
observed edge between two model-known locks is absent from the static
graph — so the model and the runtime cannot silently drift apart. The
committed baseline (``lint/lockorder_baseline.json``) records the edges
the port's threaded tests actually exercise;
``tests/test_torch_lockwitness.py`` pins baseline ⊆ static graph and arms
the witness over the port's threaded serving tests.

Mechanics: :func:`lock_witness` patches ``threading.Lock``/``RLock``
(and, through them, default-lock ``Condition``\\ s) with wrappers around
the real primitives. Before each acquisition the wrapper records one
edge per lock currently held by the thread; a reentrant re-acquisition
records nothing (that is what RLocks are for). ``Condition`` wrapping a
witnessed lock delegates acquire/release to the wrapper, so condition
entry/exit and post-``wait`` re-acquisition are all witnessed. Locks
created before installation (module-level registries) are not wrapped —
the witness covers what the test constructs, which is exactly what the
threaded suites exercise.

This module is excluded from the concurrency *model*
(``lockmodel.EXCLUDED_SUFFIXES``): it is the instrument, and modeling
its own wrapper plumbing would only report on itself.
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..envknobs import env_str

_THIS_FILE = os.path.abspath(__file__)


def witness_enabled() -> bool:
    """``KEYSTONE_LOCK_WITNESS``: any truthy value enables the test
    fixture (``record`` records without asserting; anything else truthy
    — ``1``/``check`` — records AND asserts)."""
    return witness_mode() != "off"


def witness_mode() -> str:
    raw = env_str("KEYSTONE_LOCK_WITNESS", "").lower()
    if raw in ("", "0", "off", "false", "none"):
        return "off"
    return "record" if raw == "record" else "check"


def default_site_names() -> Dict[Tuple[str, int], str]:
    """The installed package's allocation-site → lock-name table, from
    the static model (the same table ``check --concurrency`` builds)."""
    from .lockmodel import build_model

    package_root = os.path.dirname(os.path.dirname(_THIS_FILE))
    return build_model([package_root]).alloc_sites()


class _WitnessLock:
    """One wrapped lock. Delegates everything it doesn't instrument to
    the real primitive (``Condition`` probes ``_is_owned`` etc.)."""

    def __init__(self, witness: "LockWitness", inner, name: str, known: bool):
        self._witness = witness
        self._inner = inner
        self.name = name
        self.known = known

    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._witness._before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness._held().append(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        held = self._witness._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessLock {self.name}>"


class LockWitness:
    """Collector: per-thread held stacks + the observed edge multiset."""

    def __init__(self, site_names: Optional[Dict[Tuple[str, int], str]] = None):
        self.site_names = dict(site_names or {})
        self._tls = threading.local()
        self._mutex = threading.Lock()  # allocated pre-patch: a real lock
        self._edges: Dict[Tuple[str, str], int] = {}
        self.created = 0  # instrumentation-is-live signal for tests

    # ------------------------------------------------------------- plumbing
    def _held(self) -> List[_WitnessLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def _before_acquire(self, lock: _WitnessLock) -> None:
        held = self._held()
        if any(h is lock for h in held):
            return  # reentrant re-acquisition: no ordering information
        for holder in held:
            if holder is lock:
                continue
            key = (holder.name, lock.name)
            with self._mutex:
                self._edges[key] = self._edges.get(key, 0) + 1

    def _creation_site(self) -> Tuple[str, int]:
        frame = sys._getframe(2)
        while frame is not None:
            filename = frame.f_code.co_filename
            if (
                os.path.abspath(filename) != _THIS_FILE
                and "threading" != os.path.splitext(os.path.basename(filename))[0]
            ):
                return filename, frame.f_lineno
            frame = frame.f_back
        return "<unknown>", 0

    def _name_for(self, filename: str, line: int) -> Tuple[str, bool]:
        normalized = filename.replace(os.sep, "/")
        marker = "keystone_tpu_torch/"
        idx = normalized.rfind(marker)
        if idx >= 0:
            rel = normalized[idx + len(marker):].replace("/", os.sep)
            name = self.site_names.get((rel, line))
            if name is not None:
                return name, True
        tail = "/".join(normalized.split("/")[-2:])
        return f"{tail}:{line}", False

    def _make(self, factory, kind: str) -> _WitnessLock:
        filename, line = self._creation_site()
        name, known = self._name_for(filename, line)
        with self._mutex:
            self.created += 1
        return _WitnessLock(self, factory(), name, known)

    # -------------------------------------------------------------- results
    def observed_edges(self) -> Dict[Tuple[str, str], int]:
        with self._mutex:
            return dict(self._edges)

    def unknown_edges(
        self, static_edges: Set[Tuple[str, str]]
    ) -> List[Tuple[str, str]]:
        """Observed edges between two MODEL-KNOWN locks that the static
        graph does not contain — the drift the witness exists to catch.
        Edges touching locks the model has no name for (test fixtures,
        third-party code) are recorded but never fail the check, and a
        holder the model marked open-world (``holder → <callback>``: it
        is held across a stored callable the model cannot see inside)
        anticipates every outgoing edge."""
        from .lockmodel import CALLBACK

        known_names = {name for _site, name in self.site_names.items()}
        open_world = {a for (a, b) in static_edges if b == CALLBACK}
        out = []
        for (a, b) in sorted(self.observed_edges()):
            if a in open_world:
                continue
            if a in known_names and b in known_names and (a, b) not in static_edges:
                out.append((a, b))
        return out


@contextmanager
def lock_witness(
    site_names: Optional[Dict[Tuple[str, int], str]] = None,
) -> Iterator[LockWitness]:
    """Install the witness: locks created inside the block are wrapped
    and their acquisition orders recorded. ``site_names`` defaults to the
    installed package's static table (:func:`default_site_names`)."""
    witness = LockWitness(
        site_names if site_names is not None else default_site_names()
    )
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    threading.Lock = lambda: witness._make(orig_lock, "lock")  # type: ignore[misc]
    threading.RLock = lambda: witness._make(orig_rlock, "rlock")  # type: ignore[misc]
    try:
        yield witness
    finally:
        threading.Lock = orig_lock  # type: ignore[misc]
        threading.RLock = orig_rlock  # type: ignore[misc]


_test_model = None


def _witness_static():
    """The port's static lock model, built once per process."""
    global _test_model
    if _test_model is None:
        from .lockmodel import build_model

        _test_model = build_model([os.path.dirname(os.path.dirname(_THIS_FILE))])
    return _test_model


@contextmanager
def armed_for_test(test_id: str) -> Iterator[Optional[LockWitness]]:
    """One test under the witness when ``KEYSTONE_LOCK_WITNESS`` is on
    (a no-op otherwise) — what the port's threaded test files wrap every
    test in. ``record`` only records; ``check`` (any other truthy value)
    also fails the test on an observed edge between two model-known
    locks that the static graph lacks. ``KEYSTONE_LOCK_WITNESS_OUT``
    appends each test's observed edges as one JSON line, the input of a
    baseline regeneration."""
    if not witness_enabled():
        yield None
        return
    import json

    model = _witness_static()
    with lock_witness(site_names=model.alloc_sites()) as witness:
        yield witness
    observed = witness.observed_edges()
    out_path = env_str("KEYSTONE_LOCK_WITNESS_OUT")
    if out_path and observed:
        with open(out_path, "a") as fh:
            fh.write(json.dumps({"test": test_id, "edges": sorted(list(e) for e in observed)}) + "\n")
    unknown = witness.unknown_edges(model.edge_pairs()) if witness_mode() == "check" else []
    if unknown:
        raise AssertionError(
            "lock witness observed acquisition edges missing from the static lock-order graph: "
            f"{unknown} — extend the model (lint/lockmodel.py) or fix the locking"
        )
