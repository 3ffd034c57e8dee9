"""The solver-agnostic stream-state contract, in memory.

Port of the in-memory half of ``keystone_tpu/refit/state.py``.
``fit_stream`` estimators accumulate *mergeable* state: for the Gram
family the ``(AᵀA, AᵀY, Σx, Σy)`` carry of ``parallel/linalg.py``, for
the sketch tier the ``(SA, SY, s1, Σx, Σy)`` carry of ``sketch/core.py``.
Both are additive over row chunks and sufficient to finish a fit with
no data pass. This module freezes that property into a portable
envelope: the statistics captured at fit time can be merged with later
traffic and finished into a NEW fitted transformer without refitting
from scratch.

An envelope names its accumulation ``kind`` and carries a tuple of host
numpy arrays plus the example count. ``merge_stream_states`` applies the
kind's merge rule (``additive`` for both kinds).

Estimator surface (``LinearMapEstimator``, ``BlockLeastSquaresEstimator``,
``SketchedLeastSquaresEstimator`` and the ``LeastSquaresEstimator``
meta-solver):

- ``fit_stream(stream, state=None)`` — ``state`` seeds the fold carry
  with previously captured statistics, so new chunks EXTEND the old fit;
- ``export_stream_state()`` — the envelope captured by this instance's
  most recent ``fit_stream`` (host numpy), or ``None``;
- ``merge_stream_state(a, b)`` — combine two envelopes (disjoint data);
- ``finish_from_state(state)`` — a fitted transformer from statistics
  alone, on the estimator's ``device``.

Persistence: ``save_stream_state`` / ``load_stream_state`` keep an
envelope in a reliability ``CheckpointStore`` under
``stream_state_key(name)`` — a sha1 of a namespaced string, byte-equal
to the JAX package's key for the same name. The envelope is written
with ``torch.save`` (host numpy carries), so a file written by one
package is never loaded by the other: their classes differ.

``finish_from_state`` opts into the co-scheduler when one is installed
(``sched/scheduler.py::maybe_lease``): admitted into an idle gap, the
finish solve is priced and spanned; under pressure the deferral is
ledgered but the solve still runs, since its callers need the model.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import spans as _spans

#: Envelope format — bump when the layout changes; loads refuse unknown
#: versions loudly rather than mis-merging silently.
FORMAT_VERSION = 1

#: kind → merge rule. "additive" is leafwise sum of carries and sum of
#: example counts. The sketch carry is additive by construction — every
#: row's contribution is a deterministic function of its absolute index.
MERGE_RULES: Dict[str, str] = {"gram": "additive", "sketch": "additive"}

#: Per-kind meta keys that must AGREE for two envelopes to combine
#: (lenient when either side never recorded them). Adding sketches drawn
#: from different (variant, seed) maps is algebra on unrelated
#: projections and must fail loudly.
MERGE_META_KEYS: Dict[str, Tuple[str, ...]] = {
    "sketch": ("sketch_variant", "sketch_seed"),
}


class StateMismatch(ValueError):
    """Two envelopes (or an envelope and a stream) that can never be
    combined: different kinds, shapes, maps or format versions. Raised
    BEFORE any accumulation happens."""


@dataclass
class StreamState:
    """One estimator's exported sufficient statistics.

    ``carry`` is a tuple of host numpy arrays (the estimator's fold
    carry, copied from the device), ``num_examples`` the rows it has
    absorbed, ``meta`` whatever the estimator needs to finish.
    """

    kind: str
    estimator: str
    num_examples: int
    carry: Tuple[np.ndarray, ...]
    meta: Dict[str, Any] = field(default_factory=dict)
    format_version: int = FORMAT_VERSION

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.carry))

    def scaled(self, decay: float) -> "StreamState":
        """Exponential forgetting for additive kinds: every statistic
        (and the effective example count) scaled by ``decay`` ∈ (0, 1].
        ``decay=1`` is a no-op; the algebra stays exact because the
        centring identity uses the same effective count the sums were
        scaled by."""
        if not 0.0 < decay <= 1.0:
            raise StateMismatch(f"decay must be in (0, 1], got {decay}")
        if decay == 1.0:
            return self
        return StreamState(
            kind=self.kind,
            estimator=self.estimator,
            num_examples=max(int(round(self.num_examples * decay)), 1),
            carry=tuple(np.asarray(a) * decay for a in self.carry),
            meta=dict(self.meta),
            format_version=self.format_version,
        )

    def describe(self) -> Dict[str, Any]:
        """Telemetry view — shapes and counts, never payloads."""
        return {
            "kind": self.kind,
            "estimator": self.estimator,
            "num_examples": int(self.num_examples),
            "carry_shapes": [tuple(a.shape) for a in self.carry],
            "nbytes": self.nbytes(),
            "format_version": self.format_version,
        }


def _check_compatible(a: StreamState, b: StreamState) -> None:
    if a.format_version != b.format_version:
        raise StateMismatch(f"format versions differ: {a.format_version} vs {b.format_version}")
    if a.kind != b.kind:
        raise StateMismatch(f"state kinds differ: {a.kind!r} vs {b.kind!r}")
    shapes_a = [tuple(x.shape) for x in a.carry]
    shapes_b = [tuple(x.shape) for x in b.carry]
    if shapes_a != shapes_b:
        raise StateMismatch(
            f"carry shapes differ: {shapes_a} vs {shapes_b} — these "
            "statistics were captured over different feature spaces"
        )
    for key in MERGE_META_KEYS.get(a.kind, ()):
        va, vb = a.meta.get(key), b.meta.get(key)
        if va is not None and vb is not None and va != vb:
            raise StateMismatch(
                f"{a.kind!r} states disagree on {key}: {va!r} vs {vb!r} — "
                "carries under different sketch maps cannot be summed"
            )


def merge_stream_states(a: StreamState, b: StreamState) -> StreamState:
    """Combine two envelopes captured over DISJOINT data. For additive
    kinds the merged statistics are what one pass over the union would
    have produced."""
    _check_compatible(a, b)
    rule = MERGE_RULES.get(a.kind)
    if rule != "additive":
        raise StateMismatch(f"no merge rule for state kind {a.kind!r} (known: {sorted(MERGE_RULES)})")
    return StreamState(
        kind=a.kind,
        estimator=a.estimator,
        num_examples=int(a.num_examples) + int(b.num_examples),
        carry=tuple(np.asarray(x) + np.asarray(y) for x, y in zip(a.carry, b.carry)),
        meta=dict(a.meta),
        format_version=a.format_version,
    )


# --------------------------------------------------------------- persistence


def stream_state_key(name: str) -> str:
    """Stable checkpoint-store digest for a named refit state. Namespaced
    so refit states can never collide with prefix-digest fit entries in
    a shared store directory."""
    return hashlib.sha1(f"keystone-refit-state:{name}".encode()).hexdigest()


def save_stream_state(store: Any, name: str, state: StreamState) -> bool:
    """Persist ``state`` under ``name`` in a reliability
    :class:`~keystone_tpu_torch.reliability.checkpoint.CheckpointStore`
    (atomic tmp+rename write). Returns False when the store refused."""
    return store.save(None, state, digest=stream_state_key(name))


def load_stream_state(store: Any, name: str) -> Optional[StreamState]:
    """The persisted state for ``name``, or None (missing/torn entries
    and unknown format versions are misses)."""
    from ..reliability.checkpoint import _MISS

    value = store.lookup(None, digest=stream_state_key(name))
    if value is _MISS or not isinstance(value, StreamState):
        return None
    if value.format_version != FORMAT_VERSION:
        return None  # refuse to extend a layout this build doesn't speak
    return value


def _device_carry(state: StreamState, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The envelope's carry as fresh float32 tensors on ``device``: a
    copy, because the fold steps update their carry in place."""
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=device) for a in state.carry)


# ------------------------------------------------------------ the Gram mixin


class GramStreamStateMixin:
    """State-contract plumbing shared by the Gram-family estimators.

    Concrete estimators implement ``_finish_from_stats(carry, n)`` —
    a fitted transformer from the (device) carry and total row count —
    and get ``export_stream_state`` / ``merge_stream_state`` /
    ``finish_from_state`` plus the fold-side helpers. The captured
    envelope lands on ``self._stream_state``.
    """

    stream_state_kind = "gram"

    def export_stream_state(self) -> Optional[StreamState]:
        return getattr(self, "_stream_state", None)

    def merge_stream_state(self, a: StreamState, b: StreamState) -> StreamState:
        return merge_stream_states(a, b)

    def finish_from_state(self, state: StreamState):
        """A fitted transformer from statistics alone (no data pass), on
        the estimator's ``device`` (default CUDA), under a ``finish``
        lease when a scheduler is installed (module docstring)."""
        from ..sched.scheduler import maybe_lease

        self._check_state_kind(state)
        carry = _device_carry(state, resolve_device(getattr(self, "device", None)))
        width, classes = (
            (int(carry[1].shape[0]), int(carry[1].shape[-1]))
            if len(carry) > 1 and getattr(carry[1], "ndim", 0) >= 1
            else (0, 0)
        )
        with maybe_lease(
            f"{type(self).__name__}:finish", "finish",
            rows=int(state.num_examples), width=width, classes=classes,
        ):
            return self._finish_from_stats(carry, int(state.num_examples))

    # ------------------------------------------------------- fold-side hooks
    def _check_state_kind(self, state: StreamState) -> None:
        if state.format_version != FORMAT_VERSION:
            raise StateMismatch(f"state format v{state.format_version} != v{FORMAT_VERSION}")
        if state.kind != self.stream_state_kind:
            raise StateMismatch(
                f"{type(self).__name__} accumulates {self.stream_state_kind!r} "
                f"state, got {state.kind!r}"
            )

    def _seed_carry(self, state: Optional[StreamState], d: int, k: int, device: torch.device):
        """The fold's initial carry on ``device``: fresh zeros, or
        ``state``'s statistics (shape-checked against the stream's
        featurized width) so new chunks extend the old fit."""
        from ..parallel import linalg

        if state is None:
            return linalg.gram_stream_init(d, k, device)
        self._check_state_kind(state)
        want = [(d, d), (d, k), (d,), (k,)]
        got = [tuple(a.shape) for a in state.carry]
        if got != want:
            raise StateMismatch(
                f"resume state shaped {got} cannot seed a (d={d}, k={k}) stream (want {want})"
            )
        return _device_carry(state, device)

    def _capture_state(self, carry, n_total: int, **meta: Any) -> StreamState:
        """Copy the post-fold carry to the host into a portable envelope
        and remember it on the instance for ``export_stream_state``."""
        with _spans.span("stream_state:capture", kind=self.stream_state_kind) as span:
            host = tuple(a.detach().to("cpu", copy=True).numpy() for a in carry)
            span.set_attribute("nbytes", int(sum(a.nbytes for a in host)))
        state = StreamState(
            kind=self.stream_state_kind,
            estimator=f"{type(self).__module__}.{type(self).__qualname__}",
            num_examples=int(n_total),
            carry=host,
            meta=dict(meta),
        )
        self._stream_state = state
        return state


# ---------------------------------------------------------- the sketch mixin


class SketchStreamStateMixin(GramStreamStateMixin):
    """State-contract plumbing for the sketch tier (``sketch/``).

    The Gram mixin's protocol — the carry is additive, so export, merge,
    ``scaled()`` and resume are inherited — with a different kind tag, a
    5-leaf ``(SA, SY, s1, Σx, Σy)`` carry whose leading dimension is the
    sketch size s, and a meta check: a resumed fold must keep
    accumulating under the SAME (variant, seed) sketch map.
    """

    stream_state_kind = "sketch"

    def _check_state_kind(self, state: StreamState) -> None:
        super()._check_state_kind(state)
        mine = getattr(self, "stream_state_meta", {}) or {}
        for key in MERGE_META_KEYS["sketch"]:
            va, vb = state.meta.get(key), mine.get(key)
            if va is not None and vb is not None and va != vb:
                raise StateMismatch(
                    f"resume state's {key}={va!r} != estimator's {vb!r} — "
                    "a fold cannot extend a sketch drawn from a different map"
                )

    def _seed_carry(self, state: Optional[StreamState], s: int, d: int, k: int, device: torch.device):
        """Fresh zeros, or ``state``'s sketch on ``device`` —
        shape-checked so a fold never extends statistics captured over a
        different (s, d, k) geometry."""
        if state is None:
            from ..sketch.core import sketch_stream_init

            return sketch_stream_init(s, d, k, device)
        self._check_state_kind(state)
        want = [(s, d), (s, k), (s,), (d,), (k,)]
        got = [tuple(a.shape) for a in state.carry]
        if got != want:
            raise StateMismatch(
                f"resume state shaped {got} cannot seed a (s={s}, d={d}, "
                f"k={k}) sketch stream (want {want})"
            )
        return _device_carry(state, device)


__all__ = [
    "FORMAT_VERSION",
    "GramStreamStateMixin",
    "MERGE_META_KEYS",
    "MERGE_RULES",
    "SketchStreamStateMixin",
    "StateMismatch",
    "StreamState",
    "load_stream_state",
    "merge_stream_states",
    "save_stream_state",
    "stream_state_key",
]
