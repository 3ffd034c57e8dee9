"""Multi-device partitioning: the planned, explainable face of the mesh.

Port of ``keystone_tpu/parallel/partitioner.py``. :class:`Partitioner`
decides, per plan node, whether and how the example (row) dimension
shards over the mesh's row axes, and for operators with the blocked-carry
protocol whether the feature dimension also blocks over ``model``. Every
decision — eligible or not — is a :class:`PartitionDecision` carrying the
mesh shape, the rendered spec and a stable reason key, recorded into the
plan report and the ``keystone_partition_*`` metrics. The decisions are
plan functions: the same inputs give the same fields in both packages
(shards, model shards, spec, reason keys, rounded ``chunk_rows``).

The optimizer consults it as the LAST rule batch
(``workflow/optimize.py::PartitionPlanRule``): an eligible estimator fit
pins the decided mesh (:func:`fit_mesh`), an eligible
``StreamingFitOperator`` runs the sharded chunk plan (each row shard
featurizes its slice of every chunk into its own partial carry; the
statistics are reduced once, at finish). The port's default mesh has one
shard per visible card, so on one card every decision records
``single-shard-mesh`` and every plan keeps its single-device path.

Env knobs (``envknobs.PARTITION_KNOBS``, the JAX package's defaults):
``KEYSTONE_PARTITION=off`` disables planning; ``KEYSTONE_PARTITION_MIN_ROWS``
(minimum logical rows per row shard, 2); ``KEYSTONE_PARTITION_MODEL_SHARDS``
(feature-axis shards, 0 = the ambient mesh's ``model`` axis, >1 reshapes
the mesh into (devices/p, p)); ``KEYSTONE_PARTITION_MIN_WIDTH`` (minimum
featurized columns per model shard, 512).

Serving: :func:`attach_serving_partition` decides ONCE per served model
(first attach wins; decisions are counted, not attaches) and installs an
eligible decision on the model's ``CompiledApply`` handle, which then
splits each batch whose rows divide the row shards across them
(``shard_rows``) and applies the model shard by shard. The port keeps no
cache of layouts: a :class:`~keystone_tpu_torch.parallel.collectives.Sharded`
value is a list of row views, built per batch, and nothing compiles per
layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..envknobs import PARTITION_KNOBS, env_disabled, env_int
from .mesh import (
    MODEL_AXIS,
    REPLICA_AXIS,
    Mesh,
    get_mesh,
    model_axis_size,
    model_mesh,
    require_one_process,
    row_axes,
    row_shard_count,
)

# Stable reason keys (the verifier's KV203 diagnostics carry these
# verbatim; equal to the JAX package's).
SHARDED = "sharded"
R_DISABLED = "disabled"
R_SINGLE_SHARD = "single-shard-mesh"
R_UNKNOWN_ROWS = "unknown-rows"
R_BELOW_FLOOR = "below-rows-floor"
R_CHUNK_TOO_NARROW = "chunk-below-shard-count"
R_BUCKETS_INDIVISIBLE = "buckets-indivisible"
R_OPT_OUT = "operator-opt-out"
# Model-axis (feature-sharding) refusals: the decision may still shard
# rows — these land in ``PartitionDecision.model_fallback`` and the
# fallbacks metric, never in ``reason`` unless the whole decision is
# ineligible.
R_MODEL_INDIVISIBLE = "model-axis-indivisible"
R_BELOW_WIDTH_FLOOR = "below-width-floor"

#: Every reason key a decision (or its model axis) can carry.
ALL_REASON_KEYS = (
    SHARDED,
    R_DISABLED,
    R_SINGLE_SHARD,
    R_UNKNOWN_ROWS,
    R_BELOW_FLOOR,
    R_CHUNK_TOO_NARROW,
    R_BUCKETS_INDIVISIBLE,
    R_OPT_OUT,
    R_MODEL_INDIVISIBLE,
    R_BELOW_WIDTH_FLOOR,
)


# ------------------------------------------------------------------ enablement

_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def partition_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return not env_disabled("KEYSTONE_PARTITION")


def set_partition_enabled(value: Optional[bool]) -> None:
    """Force partitioning on/off process-wide; ``None`` restores the env
    default (the tri-state contract of fusion and streaming)."""
    global _enabled
    with _enabled_lock:
        _enabled = value


@contextlib.contextmanager
def partition_disabled():
    """Scoped off-switch — parity tests build the single-device reference
    here, as with ``streaming_disabled()``."""
    global _enabled
    with _enabled_lock:
        prev = _enabled
        _enabled = False
    try:
        yield
    finally:
        with _enabled_lock:
            _enabled = prev


def _knob(name: str) -> int:
    return env_int(name, PARTITION_KNOBS[name])


def partition_min_rows_per_shard() -> int:
    """Minimum logical rows each row shard must receive for a fit or
    stream plan to shard (``KEYSTONE_PARTITION_MIN_ROWS``, default 2)."""
    return max(1, _knob("KEYSTONE_PARTITION_MIN_ROWS"))


def partition_model_shards() -> int:
    """Requested feature-axis (``model``) shards
    (``KEYSTONE_PARTITION_MODEL_SHARDS``): 0 (the default) adopts the
    ambient mesh's ``model`` axis, > 1 asks for a (devices/p, p) mesh."""
    return max(0, _knob("KEYSTONE_PARTITION_MODEL_SHARDS"))


def partition_min_width_per_shard() -> int:
    """Minimum featurized columns per model shard
    (``KEYSTONE_PARTITION_MIN_WIDTH``, default 512): below it the decision
    records ``below-width-floor`` and keeps the row-only layout."""
    return max(1, _knob("KEYSTONE_PARTITION_MIN_WIDTH"))


# -------------------------------------------------------------------- decision


@dataclass
class PartitionDecision:
    """One node's partitioning outcome. ``eligible`` decisions carry the
    mesh they shard over; fallbacks carry the reason key. Never an error:
    an ineligible node runs its single-device path."""

    kind: str  # "fit" | "fit_stream" | "serve"
    node: str  # operator label
    eligible: bool
    reason: str  # SHARDED, or the fallback reason key
    shards: int = 1  # ROW shards (data × replica axes)
    model_shards: int = 1  # feature-axis shards (1 = row-only layout)
    mesh_axes: Tuple[str, ...] = ()  # row axes — the chunk/batch spec
    mesh_shape: Tuple[int, ...] = ()
    spec: str = ""  # rendered row (× feature) PartitionSpec
    detail: str = ""
    model_fallback: str = ""  # why the MODEL axis was refused/demoted
    chunk_rows: Optional[int] = None  # fit_stream: rounded to row shards
    mesh: Optional[Mesh] = field(default=None, repr=False)

    @property
    def carry_axes(self) -> Tuple[str, ...]:
        """Axes the per-shard streaming carries span: the row axes, plus
        ``model`` when the layout is 2-D (shards enumerate row-major)."""
        if self.model_shards > 1:
            return self.mesh_axes + (MODEL_AXIS,)
        return self.mesh_axes

    @property
    def total_shards(self) -> int:
        """Carry blocks of a streamed fit: row × feature shards."""
        return self.shards * self.model_shards

    def to_json(self) -> Dict[str, Any]:
        out = {
            "kind": self.kind,
            "node": self.node,
            "eligible": self.eligible,
            "reason": self.reason,
            "shards": self.shards,
            "model_shards": self.model_shards,
            "mesh_axes": list(self.mesh_axes),
            "mesh_shape": list(self.mesh_shape),
            "spec": self.spec,
        }
        if self.detail:
            out["detail"] = self.detail
        if self.model_fallback:
            out["model_fallback"] = self.model_fallback
        if self.chunk_rows is not None:
            out["chunk_rows"] = self.chunk_rows
        return out


# -------------------------------------------------------------------- report

_report_lock = threading.Lock()
_last_report: List[PartitionDecision] = []
_report_generation = 0


def reset_partition_report() -> None:
    """Start a fresh decision list (PartitionPlanRule calls this per
    optimizer run, so the report describes the LAST plan) and bump the
    generation, so an executor can tell whether ITS optimize ran a
    partition batch."""
    global _last_report, _report_generation
    with _report_lock:
        _last_report = []
        _report_generation += 1


def partition_report_generation() -> int:
    with _report_lock:
        return _report_generation


def record_decision(decision: PartitionDecision, to_report: bool = True) -> PartitionDecision:
    """Publish the metric family and (by default) append to the plan
    report."""
    if to_report:
        with _report_lock:
            _last_report.append(decision)
    from ..obs import names as _names

    _names.metric(_names.PARTITION_DECISIONS).inc(
        kind=decision.kind, eligible="1" if decision.eligible else "0"
    )
    if decision.eligible:
        _names.metric(_names.PARTITION_SHARDS).set(decision.shards, kind=decision.kind, axis="data")
        if decision.model_shards > 1:
            _names.metric(_names.PARTITION_SHARDS).set(
                decision.model_shards, kind=decision.kind, axis="model"
            )
    else:
        _names.metric(_names.PARTITION_FALLBACKS).inc(reason=decision.reason)
    if decision.model_fallback and decision.model_fallback != decision.reason:
        # A row-sharded decision whose MODEL axis was refused still counts
        # a fallback under the model reason.
        _names.metric(_names.PARTITION_FALLBACKS).inc(reason=decision.model_fallback)
    return decision


def last_partition_report() -> List[PartitionDecision]:
    """Decisions of the most recent partition-planned optimizer run."""
    with _report_lock:
        return list(_last_report)


def record_collective_bytes(nbytes: int, axis: str = "data") -> None:
    """Account payload bytes entering a partitioner-managed reduction
    (the finish-time reductions of streamed statistics), by mesh axis:
    per-shard payload × (axis shards − 1), the bytes that must cross a
    shard boundary in any reduction order. A pure function of the plan."""
    if nbytes <= 0:
        return
    from ..obs import names as _names

    _names.metric(_names.PARTITION_COLLECTIVE_BYTES).inc(int(nbytes), axis=axis)


def record_imbalance(kind: str, logical_rows: int, padded_rows: int) -> None:
    """The fraction of sharded rows that are pad."""
    if padded_rows <= 0:
        return
    from ..obs import names as _names

    frac = max(0.0, 1.0 - logical_rows / padded_rows)
    _names.metric(_names.PARTITION_IMBALANCE).set(frac, kind=kind)


# ----------------------------------------------------------------- partitioner


class Partitioner:
    """Decides row sharding over the active mesh for fit, fit_stream and
    serving plans. All decisions go through :func:`record_decision` unless
    ``record=False`` (the verifier's re-derivation)."""

    def __init__(
        self,
        mesh: Optional[Mesh] = None,
        min_rows_per_shard: Optional[int] = None,
        model_shards: Optional[int] = None,
    ):
        self.mesh = require_one_process(mesh if mesh is not None else get_mesh(), "the partitioner")
        self.min_rows = (
            min_rows_per_shard if min_rows_per_shard is not None else partition_min_rows_per_shard()
        )
        self.axes = row_axes(self.mesh)
        self.shards = row_shard_count(self.mesh)
        req = model_shards if model_shards is not None else partition_model_shards()
        if req == 0:  # auto: adopt the ambient mesh's model axis
            req = model_axis_size(self.mesh)
        self.requested_model = max(1, int(req))
        self.min_width = partition_min_width_per_shard()

    # ------------------------------------------------------------- rendering
    def spec_str(self, axes: Tuple[str, ...], model_shards: int = 1) -> str:
        row = f"P(({', '.join(repr(a) for a in axes)},), …)"
        if model_shards > 1:
            return row + f" × P(…, ({MODEL_AXIS!r},))"
        return row

    def _base(
        self,
        kind: str,
        node: str,
        eligible: bool,
        reason: str,
        mesh: Optional[Mesh] = None,
        axes: Optional[Tuple[str, ...]] = None,
        shards: Optional[int] = None,
        model_shards: int = 1,
        **kw,
    ) -> PartitionDecision:
        mesh = mesh if mesh is not None else self.mesh
        axes = axes if axes is not None else self.axes
        shards = shards if shards is not None else self.shards
        return PartitionDecision(
            kind=kind,
            node=node,
            eligible=eligible,
            reason=reason,
            shards=shards if eligible else 1,
            model_shards=model_shards if eligible else 1,
            mesh_axes=axes if eligible else (),
            mesh_shape=tuple(mesh.shape[a] for a in mesh.shape) if eligible else (),
            spec=self.spec_str(axes, model_shards) if eligible else "",
            mesh=mesh if eligible else None,
            **kw,
        )

    def _gate(self, kind: str, node: str) -> Optional[PartitionDecision]:
        if not partition_enabled():
            return self._base(kind, node, False, R_DISABLED)
        if self.shards <= 1:
            return self._base(kind, node, False, R_SINGLE_SHARD, detail=f"mesh has {self.shards} row shard")
        return None

    # ------------------------------------------------------------ model axis
    def _model_plan(self, width: Optional[int], model_ok: bool, optimistic: bool) -> Tuple[int, str, str]:
        """``(model_shards, fallback_reason, detail)`` for a node.
        ``optimistic`` (streams) grants the request on an unknown width;
        the fold re-validates against the real featurized width."""
        req = self.requested_model
        if req <= 1 or not model_ok:
            return 1, "", ""
        total = int(self.mesh.size)
        if req > total or total % req != 0:
            return 1, R_MODEL_INDIVISIBLE, f"{req} model shards do not divide {total} devices"
        if REPLICA_AXIS in self.mesh.shape and model_axis_size(self.mesh) != req:
            return 1, R_MODEL_INDIVISIBLE, "hybrid (replica) mesh carries no model axis to reshape"
        if width is None or width < 0:
            if optimistic:
                return req, "", ""
            return 1, R_BELOW_WIDTH_FLOOR, "featurized width unknown at plan time"
        if width % req != 0:
            return 1, R_MODEL_INDIVISIBLE, f"width {width} not divisible by {req} model shards"
        if width < req * self.min_width:
            return 1, R_BELOW_WIDTH_FLOOR, f"width {width} < {req} shards × {self.min_width} min cols/shard"
        return req, "", ""

    def _layout(self, width: Optional[int], model_ok: bool, optimistic: bool):
        """``(mesh, row_axes, row_shards, model_shards, model_fallback,
        model_detail)``. A granted model plan reshapes the devices into the
        cached ``(data, model)`` mesh."""
        p_m, mfall, mdetail = self._model_plan(width, model_ok, optimistic)
        if p_m > 1:
            mesh = self.mesh if model_axis_size(self.mesh) == p_m else model_mesh(self.mesh, p_m)
            return mesh, row_axes(mesh), row_shard_count(mesh), p_m, mfall, mdetail
        return self.mesh, self.axes, self.shards, 1, mfall, mdetail

    @staticmethod
    def _emit(record: bool, decision: PartitionDecision) -> PartitionDecision:
        return record_decision(decision) if record else decision

    # -------------------------------------------------------------- decisions
    def decide_fit(
        self,
        node: str,
        rows: Optional[int],
        record: bool = True,
        opt_out: bool = False,
        width: Optional[int] = None,
        model_ok: bool = False,
    ) -> PartitionDecision:
        """In-core estimator fit: rows shard over the row axes (per-shard
        Gram partials summed across shards); with ``model_ok`` and a
        ``width`` above the floor the features also block over ``model``
        (``linalg.block_coordinate_descent_2d``). Needs a known row count
        with at least ``min_rows`` logical rows per row shard."""
        if not partition_enabled():
            return self._emit(record, self._base("fit", node, False, R_DISABLED))
        if opt_out:
            return self._emit(record, self._base("fit", node, False, R_OPT_OUT))
        mesh, axes, p_d, p_m, mfall, mdetail = self._layout(width, model_ok, optimistic=False)
        if p_d <= 1 and p_m <= 1:
            return self._emit(record, self._base(
                "fit", node, False, R_SINGLE_SHARD,
                detail=f"mesh has {self.shards} row shard", model_fallback=mfall,
            ))
        if rows is None or rows < 0:
            return self._emit(record, self._base("fit", node, False, R_UNKNOWN_ROWS, model_fallback=mfall))
        if rows < p_d * self.min_rows:
            return self._emit(record, self._base(
                "fit", node, False, R_BELOW_FLOOR,
                detail=f"{rows} rows < {p_d} shards × {self.min_rows} min rows/shard",
                model_fallback=mfall,
            ))
        return self._emit(record, self._base(
            "fit", node, True, SHARDED, mesh=mesh, axes=axes, shards=p_d, model_shards=p_m,
            model_fallback=mfall, detail=mdetail,
        ))

    def decide_stream(
        self,
        node: str,
        chunk_rows: int,
        rows: Optional[int] = None,
        record: bool = True,
        opt_out: bool = False,
        width: Optional[int] = None,
        model_ok: bool = False,
    ) -> PartitionDecision:
        """Streamed fit: every chunk splits across the row shards
        (``chunk_rows`` rounds UP to a row-shard multiple); per-shard
        carries hold partial statistics, reduced once at finish — rows
        summed across ``data``, feature blocks concatenated across
        ``model`` in a 2-D layout. An unknown width grants the model axis
        optimistically (:func:`demote_model_axis` at fold time)."""
        if not partition_enabled():
            return self._emit(record, self._base("fit_stream", node, False, R_DISABLED))
        if opt_out:
            return self._emit(record, self._base("fit_stream", node, False, R_OPT_OUT))
        mesh, axes, p_d, p_m, mfall, mdetail = self._layout(width, model_ok, optimistic=True)
        if p_d <= 1 and p_m <= 1:
            return self._emit(record, self._base(
                "fit_stream", node, False, R_SINGLE_SHARD,
                detail=f"mesh has {self.shards} row shard", model_fallback=mfall,
            ))
        if chunk_rows < p_d:
            return self._emit(record, self._base(
                "fit_stream", node, False, R_CHUNK_TOO_NARROW,
                detail=f"chunk_rows {chunk_rows} < {p_d} shards", model_fallback=mfall,
            ))
        if rows is not None and 0 <= rows < p_d * self.min_rows:
            return self._emit(record, self._base(
                "fit_stream", node, False, R_BELOW_FLOOR,
                detail=f"{rows} rows < {p_d} shards × {self.min_rows} min rows/shard",
                model_fallback=mfall,
            ))
        rounded = -(-chunk_rows // p_d) * p_d
        return self._emit(record, self._base(
            "fit_stream", node, True, SHARDED, chunk_rows=rounded, mesh=mesh, axes=axes,
            shards=p_d, model_shards=p_m, model_fallback=mfall, detail=mdetail,
        ))

    def decide_serve(self, node: str, buckets: Sequence[int], record: bool = True) -> PartitionDecision:
        """Bucketed serving: a batch padded to bucket b shards its rows
        when b divides evenly across the row shards; eligible when at
        least one bucket does (:func:`attach_serving_partition` acts on
        it)."""
        gated = self._gate("serve", node)
        if gated is not None:
            return self._emit(record, gated)
        divisible = sorted(
            {int(b) for b in buckets if int(b) >= self.shards and int(b) % self.shards == 0}
        )
        if not divisible:
            return self._emit(record, self._base(
                "serve", node, False, R_BUCKETS_INDIVISIBLE,
                detail=f"no bucket in {sorted(set(map(int, buckets)))} is a multiple of {self.shards} shards",
            ))
        return self._emit(record, self._base("serve", node, True, SHARDED, detail=f"sharded buckets: {divisible}"))


# ------------------------------------------------------------------ consumers


def attach_serving_partition(model: Any, buckets: Sequence[int], name: str = "serve") -> Optional[PartitionDecision]:
    """Decide and install the row sharding of a served model's bucketed
    ``compiled_apply`` path (the server's warmup and the registry's
    ``load_fitted`` both call this, so the warmed and the steady-state
    layouts are decided once and identically).

    Returns the decision; None when the model has no ``compiled_apply``
    handle. The FIRST installed decision wins: the handle is shared by
    every server over the pipeline, and a conflicting later decision
    (another bucket set, another mesh) is logged and ignored. A decision
    is recorded into the metrics only when it differs from the handle's
    last one — decisions are counted, not attaches."""
    compiled = getattr(model, "compiled_apply", None)
    if not callable(compiled):
        return None
    label = str(getattr(model, "label", name))
    decision = Partitioner().decide_serve(label, buckets, record=False)
    handle = compiled()
    installed = handle.partition
    previous = getattr(handle, "_serve_decision", None)
    if installed is not None and (installed.shards != decision.shards or installed.mesh is not decision.mesh):
        import logging

        logging.getLogger(__name__).warning(
            "serving partition for %s already installed (%s shards); "
            "keeping it over the conflicting new decision (%s, %s shards)",
            label, installed.shards, decision.reason, decision.shards,
        )
        return installed
    if (
        previous is None
        or previous.eligible != decision.eligible
        or previous.shards != decision.shards
        or previous.mesh is not decision.mesh
    ):
        record_decision(decision, to_report=False)
    handle._serve_decision = decision
    if decision.eligible:
        handle.partition = decision
    return decision


def demote_model_axis(decision: PartitionDecision, reason: str, detail: str = "") -> PartitionDecision:
    """Fold-time demotion of an optimistically granted model axis: keeps
    the 2-D mesh (rows then replicate over ``model``) with ``model_shards``
    1; a 1×N mesh turns the decision ineligible (single-device fold).
    Counted in the fallbacks metric under ``reason`` either way."""
    from ..obs import names as _names

    _names.metric(_names.PARTITION_FALLBACKS).inc(reason=reason)
    demoted = dataclasses.replace(
        decision,
        model_shards=1,
        model_fallback=reason,
        spec=f"P(({', '.join(repr(a) for a in decision.mesh_axes)},), …)",
        detail=detail or decision.detail,
    )
    if demoted.shards <= 1:
        demoted = dataclasses.replace(
            demoted, eligible=False, reason=reason, shards=1, mesh_axes=(), mesh_shape=(), spec="", mesh=None,
        )
    return demoted


def fit_mesh(op: Any) -> Mesh:
    """The mesh an estimator fit shards over: the partitioner's pinned
    decision when the plan carries an eligible one, else the ambient mesh
    (a direct ``est.fit()``, a fallback, ``KEYSTONE_PARTITION=off``).
    A mesh that spans processes raises ``ValueError``
    (:func:`~keystone_tpu_torch.parallel.mesh.require_one_process`)."""
    decision = getattr(op, "partition", None)
    if decision is not None and getattr(decision, "eligible", False) and decision.mesh is not None:
        return decision.mesh
    return require_one_process(get_mesh(), type(op).__name__)


def shard_rows(decision: Optional[PartitionDecision], tree: Any) -> Any:
    """Lay out every tensor leaf of ``tree`` by rows per the decision
    (a :class:`~keystone_tpu_torch.parallel.collectives.Sharded` each);
    leaves whose row count does not divide the row shards, and every leaf
    under an ineligible decision, come back untouched."""
    if decision is None or not decision.eligible or decision.mesh is None:
        return tree
    import numpy as np
    import torch

    from ..utils.tree import tree_map
    from .collectives import P, shard_tensor

    def place(a):
        if not isinstance(a, (torch.Tensor, np.ndarray)) or a.ndim == 0:
            return a
        rows = a.shape[0]
        if rows < decision.shards or rows % decision.shards != 0:
            return a
        return shard_tensor(torch.as_tensor(a), decision.mesh, P(tuple(decision.mesh_axes)))

    return tree_map(place, tree)


__all__ = [
    "ALL_REASON_KEYS",
    "PartitionDecision",
    "Partitioner",
    "R_BELOW_FLOOR",
    "R_BELOW_WIDTH_FLOOR",
    "R_BUCKETS_INDIVISIBLE",
    "R_CHUNK_TOO_NARROW",
    "R_DISABLED",
    "R_MODEL_INDIVISIBLE",
    "R_OPT_OUT",
    "R_SINGLE_SHARD",
    "R_UNKNOWN_ROWS",
    "SHARDED",
    "attach_serving_partition",
    "demote_model_axis",
    "fit_mesh",
    "last_partition_report",
    "partition_disabled",
    "partition_enabled",
    "partition_min_rows_per_shard",
    "partition_min_width_per_shard",
    "partition_model_shards",
    "partition_report_generation",
    "record_collective_bytes",
    "record_decision",
    "record_imbalance",
    "reset_partition_report",
    "set_partition_enabled",
    "shard_rows",
]
