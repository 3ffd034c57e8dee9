"""Model registry: versioned fitted pipelines with atomic hot-swap.

Port of ``keystone_tpu/serving/registry.py``. Models come in through
three doors —

- :meth:`ModelRegistry.publish` — an in-process fitted pipeline object;
- :meth:`ModelRegistry.load_fitted` — a ``FittedPipeline.save`` artifact,
  with every tensor placed on the serving device, verified at plan time
  first (``workflow/verify.py``);
- :meth:`ModelRegistry.load_checkpoint` — a fitted value out of a
  reliability ``CheckpointStore`` directory, by digest prefix, onto the
  serving device.

With ``buckets`` given, ``load_fitted`` also attaches the serving
partition (``parallel.partitioner.attach_serving_partition``), as the
JAX package's does.

Hot-swap contract: ``resolve`` returns an immutable :class:`ModelEntry`;
the worker holds that entry for the whole batch it is applying, so a
concurrent ``publish`` of a newer version never drops or retypes
in-flight work — requests already assembled finish on the version they
resolved, later batches resolve the new current version.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from .config import UnknownModel

if TYPE_CHECKING:
    from ..device import DeviceLike


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

    def load_fitted(
        self,
        name: str,
        path: str,
        device: DeviceLike = None,
        example: Any = None,
        buckets: Optional[List[int]] = None,
        warmed_buckets: Optional[List[int]] = None,
    ) -> ModelEntry:
        """Publish a ``FittedPipeline.save`` artifact with every tensor on
        ``device`` (default CUDA; ``"cpu"`` on a machine without a card),
        re-fused: an artifact saved unfused (or before fusion existed)
        serves the fused plan that ``Pipeline.fit`` makes.

        Before publishing, the artifact goes through the plan-time
        verifier (``workflow/verify.py``): cycles and internal shape/dtype
        inconsistencies are diagnosed from specs alone, plus — when
        ``example`` (one request payload) is given — the whole apply path
        at one row, and — when ``buckets``/``warmed_buckets`` are given —
        the serving-bucket/warm-set agreement (KV301). Warn by default;
        ``KEYSTONE_VERIFY=strict`` raises ``VerificationError`` instead of
        publishing a model that cannot serve."""
        from ..workflow.pipeline import FittedPipeline
        from ..workflow.verify import spec_leaf, verify_and_enforce

        fitted = FittedPipeline.load(path, device=device).fused()
        source_specs = None
        if example is not None:
            import numpy as np

            from ..utils.tree import tree_map

            def leaf_spec(a):
                # Metadata first: np.asarray on a card tensor would copy
                # it to the host just to read its dtype. The fallback
                # only runs for host-native payloads (JSON lists).
                dtype = getattr(a, "dtype", None)
                shape = getattr(a, "shape", None)
                if dtype is None or shape is None:
                    arr = np.asarray(a)
                    dtype, shape = arr.dtype, arr.shape
                return spec_leaf((1,) + tuple(shape), dtype)

            try:
                source_specs = {fitted.source: tree_map(leaf_spec, example)}
            except Exception:
                # An unconvertible example must not block publication —
                # verify the graph without a bound request spec instead
                # (the warn contract: only verified findings interfere).
                source_specs = None
        verify_and_enforce(
            fitted.graph,
            context=f"load_fitted:{name}",
            source_specs=source_specs,
            buckets=buckets,
            warmed_buckets=warmed_buckets,
        )
        if buckets:
            # Decide (and record) the serving row sharding at the door the
            # bucket contract enters: warmup re-attaches the same decision,
            # so the published and the warmed layouts cannot drift.
            from ..parallel.partitioner import attach_serving_partition

            attach_serving_partition(fitted, buckets, name=name)
        return self.publish(name, fitted, source=f"fitted:{path}")

    def load_checkpoint(
        self, name: str, store_path: str, digest: str, device: DeviceLike = None
    ) -> ModelEntry:
        """Publish a fitted value out of a reliability checkpoint store,
        with every tensor on ``device`` (default CUDA).

        ``digest`` may be a unique prefix of the full structural digest
        (the recovery log prints 12-hex prefixes); no match raises
        ``FileNotFoundError``, several raise ``ValueError``."""
        import torch

        from ..device import resolve_device

        matches = [
            f for f in sorted(os.listdir(store_path))
            if f.endswith(".pkl") and f.startswith(digest)
        ]
        if not matches:
            raise FileNotFoundError(f"no checkpoint entry matching digest {digest!r} in {store_path}")
        if len(matches) > 1:
            raise ValueError(f"digest prefix {digest!r} is ambiguous in {store_path}: {matches}")
        model = torch.load(
            os.path.join(store_path, matches[0]), map_location=resolve_device(device), weights_only=False
        )
        fused = getattr(model, "fused", None)
        if callable(fused):
            # Same re-fusion as load_fitted for a checkpointed pipeline.
            model = fused()
        return self.publish(name, model, source=f"checkpoint:{store_path}/{matches[0]}")

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
