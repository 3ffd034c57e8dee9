"""MeasuredKnobRule: plan knobs chosen from measured history, not env
defaults.

Port of ``keystone_tpu/workflow/knobs.py``. Chunk rows, solver block
size and solver precision default to env vars, and no single static
default suits every shape class on a card. Every streaming fit and
solver fit records what its knob settings achieved per shape class in
the profile store (``obs/store.py``; ``tune`` searches and records
more); this rule, running as the last optimizer batch (after streaming,
so the ``StreamingFitOperator`` nodes it tunes exist), overrides the
*defaults* from the best recorded observation:

- **stream chunk rows** — the best-throughput recorded ``chunk_rows``
  for this featurize chain + data shape class is pinned onto the
  ``StreamingFitOperator`` (an explicit ``KEYSTONE_STREAM_CHUNK_ROWS``
  always wins). Semantics-free: chunking is parity-tested at any size.
- **solver precision** — the fastest recorded precision mode for this
  shape class is pinned onto the estimator operator
  (``solver_precision``) and applied ONLY around that operator's fit via
  ``parallel.linalg.solver_mode_scope`` — never as process state, so
  unplanned solves and concurrent fits keep their own default (an
  explicit ``KEYSTONE_SOLVER_PRECISION`` always wins). On the card the
  mode names the binding's product kind (``highest`` IEEE fp32, ``high``
  TF32, ``default`` bf16).
- **solver block size** — estimators carrying a ``block_size`` are
  re-created with the best recorded block for the shape class; setting
  ``KEYSTONE_SOLVER_BLOCK`` (to any value — it is consumed only here)
  pins constructor-chosen block sizes against measured overrides.

Precision and block size change *numerics within solver tolerance*
(different Gauss-Seidel block order, different matmul precision), so
they are gated behind ``KEYSTONE_MEASURED_KNOBS=all``; the default
(``on``) applies only the semantics-free chunk-rows override, and
``off`` disables the rule entirely.

Every override is recorded as a span attribute on the
``optimize:measured-knobs`` span and counted in
``keystone_profile_store_knob_overrides_total{knob=...}``.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Optional, Tuple

from ..envknobs import env_raw, env_set, env_str
from ..obs import cost as _cost
from ..obs import names as _names
from ..obs import spans as _spans
from ..obs import store as _store
from .graph import Graph
from .operators import DatasetOperator, EstimatorOperator
from .rules import PrefixMap, Rule

logger = logging.getLogger(__name__)


def knob_mode() -> str:
    """``KEYSTONE_MEASURED_KNOBS``: ``on`` (default — semantics-free
    overrides only), ``all`` (also precision/block size), ``off``."""
    mode = env_str("KEYSTONE_MEASURED_KNOBS", "on").lower()
    if mode in ("off", "0", "disabled"):
        return "off"
    return "all" if mode == "all" else "on"


def _best_entry(
    store, key_prefix: str, measure: str, shape: Optional[str] = None,
    rows: Optional[str] = None, maximize: bool = True,
    require: Tuple[str, ...] = (),
) -> Optional[Tuple[str, Dict[str, Any]]]:
    """The (key, measurements) with the best ``measure`` among matching
    entries that also carry every ``require`` field — ties broken by key
    for determinism across runs."""
    best: Optional[Tuple[str, Dict[str, Any]]] = None
    best_v: Optional[float] = None
    for key, _shape, m in sorted(
        store.entries(key_prefix=key_prefix, shape=shape, rows=rows)
    ):
        if measure not in m or any(r not in m for r in require):
            continue
        v = float(m[measure])
        better = (
            best_v is None
            or (v > best_v if maximize else v < best_v)
        )
        if better:
            best, best_v = (key, m), v
    return best


def _unanimous_winner(
    store, key_prefix: str, rows: str, field: str,
    knob: Optional[str] = None, sp=None,
) -> Optional[Tuple[str, str, Dict[str, Any]]]:
    """Group matching entries by their FULL shape class (exact d, not
    just the rows bucket), take the best-wall entry per group, and return
    a winner only when every group agrees on ``field``. Absolute walls
    across different feature widths are incommensurable — a knob measured
    fast on a 64-wide problem must not win a 4096-wide one — but when
    every width in the scale band independently picked the same setting,
    the measurement transfers.

    A drop is never silent: disagreeing widths are counted in
    ``keystone_knob_rejected_total{knob,reason="non_unanimous"}`` and
    recorded as a span event naming the contenders, so a tuning gap
    (more measurements needed before the override can apply) is visible
    instead of an invisible no-op."""
    groups: Dict[str, Tuple[float, str, Dict[str, Any]]] = {}
    for key, shape, m in sorted(
        store.entries(key_prefix=key_prefix, rows=rows)
    ):
        if "wall_s" not in m or field not in m:
            continue
        wall = float(m["wall_s"])
        cur = groups.get(shape)
        if cur is None or wall < cur[0]:
            groups[shape] = (wall, key, m)
    if not groups:
        return None
    winners = {repr(m[field]) for _, _, m in groups.values()}
    if len(winners) != 1:
        _reject_knob(
            knob or field, "non_unanimous", sp=sp,
            contenders=sorted(winners), groups=len(groups), rows=rows,
        )
        return None  # the widths disagree: no defensible override
    shape, (_, key, m) = next(iter(groups.items()))
    return key, shape, m


def _reject_knob(knob: str, reason: str, sp=None, **detail: Any) -> None:
    """Count + trace a measured override that was dropped before it
    could apply: tuning gaps must be observable, not invisible no-ops."""
    _names.metric(_names.KNOB_REJECTED).inc(knob=knob, reason=reason)
    if sp is not None:
        sp.set_attribute(f"knob_rejected:{knob}", reason)
    _spans.add_span_event("measured_knob_rejected", knob=knob, reason=reason,
                          **{k: repr(v) for k, v in detail.items()})


class MeasuredKnobRule(Rule):
    """Override plan-knob defaults per shape class from the profile
    store's best recorded observations."""

    def __init__(self, profile_store="auto"):
        self.profile_store = profile_store

    def _store(self):
        if self.profile_store == "auto":
            return _store.get_store()
        return self.profile_store

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        mode = knob_mode()
        store = self._store()
        # This rule never installs thread/process precision state itself —
        # measured precision is pinned onto operators and scoped around
        # their fits (linalg.solver_mode_scope). The clear below is
        # defensive hygiene for MANUAL set_solver_mode_override() calls
        # left unscoped on this thread by embedding code: planning a new
        # pipeline is the natural boundary past which such a leftover
        # default must not silently persist (pinned by
        # test_stale_precision_override_cleared_by_next_plan).
        from ..parallel import linalg

        linalg.set_solver_mode_override(None)
        if mode == "off" or store is None:
            return graph, prefixes
        overrides = _names.metric(_names.PROFILE_STORE_KNOB_OVERRIDES)
        with _spans.span("optimize:measured-knobs", mode=mode) as sp:
            graph = self._tune_stream_chunks(graph, store, overrides, sp)
            if mode == "all":
                graph = self._tune_solver_block(graph, store, overrides, sp)
                graph = self._tune_solver_precision(graph, store, overrides, sp)
                graph = self._tune_sketch_size(graph, store, overrides, sp)
        return graph, prefixes

    # ------------------------------------------------------- chunk rows
    def _tune_stream_chunks(self, graph, store, overrides, sp):
        from .streaming import StreamingFitOperator, chain_class

        if env_set("KEYSTONE_STREAM_CHUNK_ROWS"):
            return graph  # explicit env knob always wins
        for node in sorted(graph.nodes):
            op = graph.operators.get(node)
            if not isinstance(op, StreamingFitOperator) or op.chunk_rows:
                continue
            deps = graph.get_dependencies(node)
            head = graph.operators.get(deps[0]) if deps else None
            if not isinstance(head, DatasetOperator):
                continue
            shape = _store.dataset_shape_class(head.dataset)
            best = _best_entry(
                store,
                f"stream:{chain_class(op.members)}:",
                "rows_per_s",
                shape=shape,
            )
            if best is None:
                continue
            rows = int(best[1].get("chunk_rows", 0))
            if rows <= 0:
                continue
            tuned = StreamingFitOperator(
                op.estimator, op.members,
                chunk_rows=rows, prefetch=op.prefetch,
            )
            # Cost-observatory join (obs/cost.py): the stored winner IS
            # this plan's throughput prediction — measured under the
            # exact (key, shape class) it will be compared at, so the
            # drift sentinel may score it (calibrated=True).
            tuned.predicted_cost = _cost.Prediction(
                model="measured_knob", key=best[0], shape=shape,
                rows_per_s=float(best[1]["rows_per_s"]), calibrated=True,
                source=str(best[1].get("source", "observed")),
            )
            graph = graph.set_operator(node, tuned)
            overrides.inc(knob="stream_chunk_rows")
            sp.set_attribute(f"stream_chunk_rows:{node}", rows)
            _spans.add_span_event(
                "measured_knob", knob="stream_chunk_rows",
                value=rows, shape=shape,
            )
        return graph

    # ------------------------------------------------------- block size
    def _tune_solver_block(self, graph, store, overrides, sp):
        from .streaming import StreamingFitOperator

        if env_set("KEYSTONE_SOLVER_BLOCK"):
            return graph
        for node in sorted(graph.nodes):
            op = graph.operators.get(node)
            target = op
            if isinstance(op, StreamingFitOperator):
                target = op.estimator
            if not isinstance(target, EstimatorOperator):
                continue
            block = getattr(target, "block_size", None)
            if not isinstance(block, int):
                continue
            rows = self._head_rows_bucket(graph, node)
            if rows is None:
                continue
            # Trailing colon: "solver:block_ls:" must NOT match
            # "solver:block_ls_stream:*", whose wall covers the whole
            # ingest+featurize+Gram fold — incommensurable with the
            # solver-only in-core walls this knob selects among. And the
            # winner must be unanimous across feature widths in the
            # bucket: absolute walls from different d never compete.
            best = _unanimous_winner(
                store, "solver:block_ls:", rows, "block_size",
                knob="solver_block_size", sp=sp,
            )
            if best is None:
                continue
            best_key, best_shape, best = best
            best_block = int(best.get("block_size", 0))
            if best_block <= 0 or best_block == block:
                continue
            tuned = copy.copy(target)
            tuned.block_size = best_block
            # Displayed in the ledger/explain, never drift-scored: the
            # winner's wall was measured at ITS feature width, and
            # absolute walls across widths are incommensurable (the
            # unanimity gate above is about the SETTING transferring,
            # not the wall).
            tuned.predicted_cost = _cost.Prediction(
                model="measured_knob", key=best_key, shape=best_shape,
                seconds=float(best["wall_s"]), calibrated=False,
                source=str(best.get("source", "observed")),
            )
            if isinstance(op, StreamingFitOperator):
                new_op = StreamingFitOperator(
                    tuned, op.members,
                    chunk_rows=op.chunk_rows, prefetch=op.prefetch,
                )
            else:
                new_op = tuned
            graph = graph.set_operator(node, new_op)
            overrides.inc(knob="solver_block_size")
            sp.set_attribute(f"solver_block_size:{node}", best_block)
            _spans.add_span_event(
                "measured_knob", knob="solver_block_size",
                value=best_block, was=block,
            )
        return graph

    # ------------------------------------------------------ sketch size
    def _tune_sketch_size(self, graph, store, overrides, sp):
        from ..sketch.solvers import SketchedLeastSquaresEstimator
        from .streaming import StreamingFitOperator

        if env_set("KEYSTONE_SKETCH_SIZE"):
            return graph  # explicit env knob always wins
        for node in sorted(graph.nodes):
            op = graph.operators.get(node)
            target = op.estimator if isinstance(op, StreamingFitOperator) else op
            if not isinstance(target, EstimatorOperator):
                continue
            # Eligible: the sketched rung itself, or a meta-solver whose
            # width dispatch may pick it (_tuned_sketch_size rides the
            # delegation either way; Gram rungs just never read it).
            sketched = isinstance(target, SketchedLeastSquaresEstimator)
            if not sketched and not callable(
                getattr(target, "_stream_solver", None)
            ):
                continue
            if getattr(target, "sketch_size", None):
                continue  # constructor pinned its own choice
            rows = self._head_rows_bucket(graph, node)
            if rows is None:
                continue
            # Same commensurability rules as block size: only sketch_ls
            # entries vote, and the winning s must be unanimous across
            # the bucket's feature widths.
            best = _unanimous_winner(
                store, "solver:sketch_ls:", rows, "sketch_size",
                knob="sketch_size", sp=sp,
            )
            if best is None:
                continue
            best_key, best_shape, best = best
            best_s = int(best.get("sketch_size", 0))
            if best_s <= 0 or best_s == getattr(
                target, "_tuned_sketch_size", None
            ):
                continue
            tuned = copy.copy(target)
            tuned._tuned_sketch_size = best_s
            tuned.predicted_cost = _cost.Prediction(
                model="measured_knob", key=best_key, shape=best_shape,
                seconds=float(best["wall_s"]), calibrated=False,
                source=str(best.get("source", "observed")),
            )
            if isinstance(op, StreamingFitOperator):
                new_op = StreamingFitOperator(
                    tuned, op.members,
                    chunk_rows=op.chunk_rows, prefetch=op.prefetch,
                )
            else:
                new_op = tuned
            graph = graph.set_operator(node, new_op)
            overrides.inc(knob="sketch_size")
            sp.set_attribute(f"sketch_size:{node}", best_s)
            _spans.add_span_event(
                "measured_knob", knob="sketch_size", value=best_s,
            )
        return graph

    # -------------------------------------------------------- precision
    def _tune_solver_precision(self, graph, store, overrides, sp):
        from ..parallel import linalg
        from .streaming import StreamingFitOperator

        if env_raw("KEYSTONE_SOLVER_PRECISION") is not None:
            return graph  # explicit env knob always wins
        for node in sorted(graph.nodes):
            op = graph.operators.get(node)
            target = op.estimator if isinstance(op, StreamingFitOperator) else op
            if not isinstance(target, EstimatorOperator):
                continue
            if getattr(target, "solver_precision", None):
                continue  # operator already pinned its own choice
            rows = self._head_rows_bucket(graph, node)
            if rows is None:
                continue
            # Only in-core block_ls entries participate (same solver
            # family → commensurable walls; streaming-fold walls and the
            # meta-solver's precision-less rung entries never vote), and
            # the winning precision must be unanimous across the bucket's
            # feature widths.
            best = _unanimous_winner(
                store, "solver:block_ls:", rows, "precision",
                knob="solver_precision", sp=sp,
            )
            if best is None:
                continue
            _best_key, _best_shape, best = best
            precision = best.get("precision")
            if not precision:
                continue
            try:
                linalg.precision_for_mode(str(precision))
            except ValueError:
                logger.warning(
                    "measured precision override rejected: unknown mode %r",
                    precision,
                )
                _reject_knob(
                    "solver_precision", "invalid_value", sp=sp,
                    value=precision,
                )
                continue
            # Scoped to THIS operator's fit (operators.py wraps
            # fit_datasets / streaming wraps fit_stream in
            # linalg.solver_mode_scope) — never process state, so solves
            # that were not planned under the measurement keep their own
            # default.
            tuned = copy.copy(target)
            tuned.solver_precision = str(precision)
            if isinstance(op, StreamingFitOperator):
                new_op = StreamingFitOperator(
                    tuned, op.members,
                    chunk_rows=op.chunk_rows, prefetch=op.prefetch,
                )
            else:
                new_op = tuned
            graph = graph.set_operator(node, new_op)
            overrides.inc(knob="solver_precision")
            sp.set_attribute(f"solver_precision:{node}", str(precision))
            _spans.add_span_event(
                "measured_knob", knob="solver_precision",
                value=str(precision),
            )
        return graph

    # ---------------------------------------------------------- helpers
    def _head_rows_bucket(self, graph, node) -> Optional[str]:
        """Rows bucket of the dataset feeding ``node``'s chain head — the
        coarse shape key when featurized width is unknowable at plan
        time (solver entries record exact d; the bucket still confines a
        measurement to its scale band)."""
        seen = set()
        cur = node
        while cur in graph.operators:
            op = graph.operators[cur]
            if isinstance(op, DatasetOperator):
                try:
                    return _store.rows_bucket(
                        _store.shape_class(len(op.dataset))
                    )
                except Exception:
                    return None
            deps = graph.get_dependencies(cur)
            if not deps or deps[0] in seen:
                return None
            seen.add(cur)
            cur = deps[0]
        return None
