"""Model registry: versioned fitted pipelines with atomic hot-swap.

Port of ``keystone_tpu/serving/registry.py``. Models come in through two
doors —

- :meth:`ModelRegistry.publish` — an in-process fitted pipeline object;
- :meth:`ModelRegistry.load_fitted` — a ``FittedPipeline.save`` artifact,
  with every tensor placed on the serving device.

Left out for now: ``load_checkpoint`` (the JAX package's
``CheckpointStore`` entries; the port has no checkpoint store yet), the
plan-time verifier ``load_fitted`` runs in the JAX package
(``verify_and_enforce``), and the serving partition it attaches for
multi-device serving (``attach_serving_partition``).

Hot-swap contract: ``resolve`` returns an immutable :class:`ModelEntry`;
the worker holds that entry for the whole batch it is applying, so a
concurrent ``publish`` of a newer version never drops or retypes
in-flight work — requests already assembled finish on the version they
resolved, later batches resolve the new current version.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..device import DeviceLike
from .config import UnknownModel


@dataclass(frozen=True)
class ModelEntry:
    """One published (name, version) — immutable; safe to hold across a
    batch while the registry is concurrently swapped."""

    name: str
    version: int
    model: Any
    source: str = "publish"
    published_at: float = field(default_factory=time.time)

    def batch_apply(self, dataset: Any) -> Any:
        """Apply the model to an ArrayDataset, normalizing over the three
        shapes a model arrives in: a FittedPipeline (compiled_apply — the
        graph-bound fast path), a Transformer (apply_batch), or a bare
        fitted TransformerOperator (batch_transform)."""
        compiled = getattr(self.model, "compiled_apply", None)
        if compiled is not None:
            return compiled()(dataset)
        apply_batch = getattr(self.model, "apply_batch", None)
        if apply_batch is not None:
            return apply_batch(dataset)
        batch_transform = getattr(self.model, "batch_transform", None)
        if batch_transform is not None:
            return batch_transform([dataset])
        raise TypeError(
            f"model {self.name}@v{self.version} ({type(self.model).__name__}) "
            "has no apply path (expected compiled_apply / apply_batch / "
            "batch_transform)"
        )


class ModelRegistry:
    """Thread-safe name → version list with an atomically swappable
    'current' pointer per name.

    History is BOUNDED: ``history_limit`` previous versions are retained
    in memory alongside the current one, so rollback after a bad publish
    is an O(1) pointer swap — no artifact re-load from disk — while a
    server that publishes a new version again and again cannot grow its
    resident model set without bound. Older entries are evicted at publish time; the current entry
    is never evicted, even when a rollback has pinned it outside the
    retention window."""

    def __init__(self, history_limit: int = 4):
        self._lock = threading.Lock()
        self._versions: Dict[str, List[ModelEntry]] = {}
        self._current: Dict[str, ModelEntry] = {}
        # Floor of 1: with zero retained previous versions a bad publish
        # could never be rolled back — the incumbent would already be
        # evicted.
        self.history_limit = max(1, int(history_limit))
        self.swaps = 0
        self.evicted = 0
        self._last_rollback: Dict[str, Dict[str, Any]] = {}

    # ---------------------------------------------------------------- publish
    def publish(self, name: str, model: Any, source: str = "publish") -> ModelEntry:
        """Register ``model`` as the next version of ``name`` and make it
        current. Returns the new entry. Evicts history beyond
        ``history_limit`` previous versions (the current entry is always
        retained)."""
        with self._lock:
            history = self._versions.setdefault(name, [])
            entry = ModelEntry(
                name=name,
                version=history[-1].version + 1 if history else 1,
                model=model,
                source=source,
            )
            history.append(entry)
            if name in self._current:
                self.swaps += 1
            self._current[name] = entry
            self._evict_locked(name)
            return entry

    def _evict_locked(self, name: str) -> None:
        history = self._versions.get(name, [])
        keep = self.history_limit + 1  # previous N + the one just published
        if len(history) <= keep:
            return
        current = self._current.get(name)
        tail, evicted = history[-keep:], history[:-keep]
        # A rollback can pin 'current' outside the retention window; the
        # live version is never evicted out from under in-flight holders.
        tail = [e for e in evicted if e is current] + tail
        self.evicted += len(history) - len(tail)
        self._versions[name] = tail

    def load_fitted(self, name: str, path: str, device: DeviceLike = None) -> ModelEntry:
        """Publish a ``FittedPipeline.save`` artifact with every tensor on
        ``device`` (default CUDA; ``"cpu"`` on a machine without a card),
        re-fused: an artifact saved unfused (or before fusion existed)
        serves the fused plan that ``Pipeline.fit`` makes."""
        from ..workflow.pipeline import FittedPipeline

        fitted = FittedPipeline.load(path, device=device).fused()
        return self.publish(name, fitted, source=f"fitted:{path}")

    # ---------------------------------------------------------------- resolve
    def resolve(self, name: str, version: Optional[int] = None) -> ModelEntry:
        with self._lock:
            if name not in self._current:
                raise UnknownModel(name, self._current.keys())
            if version is None:
                return self._current[name]
            for entry in self._versions[name]:
                if entry.version == version:
                    return entry
            raise UnknownModel(f"{name}@v{version}", self._current.keys())

    def rollback(self, name: str, version: Optional[int] = None) -> ModelEntry:
        """Point 'current' back at a retained older version — an O(1)
        in-memory pointer swap, never a disk re-load (the bounded history
        exists exactly for this). ``version=None`` rolls back to the
        retained version just below the current one (the auto-rollback
        path's default). Records rollback provenance for ``describe``."""
        with self._lock:
            if name not in self._current:
                raise UnknownModel(name, self._current.keys())
            current = self._current[name]
            if version is None:
                older = [
                    e for e in self._versions[name]
                    if e.version < current.version
                ]
                if not older:
                    raise UnknownModel(
                        f"{name}@<no retained previous version>",
                        self._current.keys(),
                    )
                entry = older[-1]
            else:
                entry = next(
                    (
                        e for e in self._versions[name]
                        if e.version == version
                    ),
                    None,
                )
                if entry is None:
                    raise UnknownModel(
                        f"{name}@v{version}", self._current.keys()
                    )
            self._current[name] = entry
            self.swaps += 1
            self._last_rollback[name] = {
                "from_version": current.version,
                "to_version": entry.version,
                "at": time.time(),
            }
        return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._current)

    def versions(self, name: str) -> List[int]:
        """RETAINED versions (eviction trims this list; the full publish
        count is the current version number)."""
        with self._lock:
            return [e.version for e in self._versions.get(name, [])]

    def describe(self) -> Dict[str, Any]:
        """Snapshot for telemetry and the serve CLI stats line: active
        version + publish provenance per name."""
        with self._lock:
            return {
                name: {
                    "current": self._current[name].version,
                    "versions": [e.version for e in self._versions[name]],
                    "source": self._current[name].source,
                    "published_at": self._current[name].published_at,
                    "last_rollback": (
                        dict(self._last_rollback[name])
                        if name in self._last_rollback
                        else None
                    ),
                }
                for name in sorted(self._current)
            }
