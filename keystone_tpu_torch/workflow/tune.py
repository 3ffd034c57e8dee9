"""Offline autotuner: active search over the plan-knob space.

Port of ``keystone_tpu/workflow/tune.py``. The profile store remembers
what every knob setting achieved and ``MeasuredKnobRule`` replays the
best recorded observation, but nothing *explores*: chunk rows, solver
block sizes, precision modes and the block-sparse dispatch threshold
replay whatever defaults happened to run. ``python -m keystone_tpu_torch
tune`` measures candidate configurations per shape class on the card; a
learned cost model (ridge regression on log-scaled knob features,
warm-started from the store's own history) proposes which candidate to
measure next, and every measurement — winner included — is persisted to
the :class:`~keystone_tpu_torch.obs.store.ProfileStore` under the keys
``MeasuredKnobRule`` and the block-sparse dispatch already read, with
``source: "tune"`` provenance.

Search tasks:

- ``stream`` — chunk_rows × prefetch depth (× shard count on an ambient
  mesh with several row shards: ``[1, n]``) for the streaming engine,
  measured as real ``fit_stream`` runs on synthetic data at the target
  shape; keys ``stream:<chain>:cr<rows>:p<prefetch>:s<shards>``, by the
  chunk rows and shard count that actually ran (``chunk_rows_actual``,
  ``shards_actual``). The JAX package keys ``stream:<chain>:cr<rows>``
  alone, so candidates at one chunk size overwrite each other there and
  the entry left may be one that lost; here each candidate keeps its own
  entry, and the store's best one under ``stream:<chain>:`` is the
  winner.
- ``solver`` — block_size × precision mode for the in-core block
  least-squares solver, measured as whole estimator fits; keys
  ``solver:block_ls:bs<b>:prec<mode>``. On the card the modes name the
  binding's product kinds (``highest`` IEEE fp32, ``high`` TF32,
  ``default`` bf16, ``refine`` fp32 with refinement). The JAX package
  probes buffer donation on the winner; the port does not donate, so the
  outcome reports ``donation_probe: not_applicable`` with the reason.
- ``blocksparse`` — the block-density threshold below which fits
  dispatch onto the block-sparse Gram path: a density sweep measures the
  sparse-vs-dense fit crossover, its sparse legs through the ELL kernel
  (``ops/cuda/csrc/ell_matmul.cu``) on the card; key
  ``blocksparse:threshold``.

Budget knobs (all via ``envknobs``):

  KEYSTONE_TUNE_BUDGET     max measured candidates per task (default 12)
  KEYSTONE_TUNE_EXPLORE    random-exploration fraction of proposals (0.25)
  KEYSTONE_TUNE_SEED       exploration RNG seed (default 0)
  KEYSTONE_TUNE_TIME_S     wall-clock budget per task in seconds (120)

The search core (:class:`Tuner`, :class:`RidgeCostModel`,
:class:`TuneSpace`) is numpy-only; only the task measure functions touch
torch and the card. Each measurement is timed after a
``torch.cuda.synchronize`` on the task's device.
"""

from __future__ import annotations

import itertools
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..envknobs import env_float, env_int
from ..obs import names as _names
from ..obs import spans as _spans

logger = logging.getLogger(__name__)

#: Cap on the expanded candidate grid — a tune space is a short menu,
#: not an exhaustive sweep; the cost model interpolates the rest.
_MAX_GRID = 512


def tune_budget() -> int:
    """``KEYSTONE_TUNE_BUDGET``: max measured candidates per task."""
    return max(1, env_int("KEYSTONE_TUNE_BUDGET", 12))


def tune_explore() -> float:
    """``KEYSTONE_TUNE_EXPLORE``: fraction of model proposals replaced by
    random exploration (keeps the surrogate from tunnel-visioning)."""
    return min(1.0, max(0.0, env_float("KEYSTONE_TUNE_EXPLORE", 0.25)))


def tune_seed() -> int:
    """``KEYSTONE_TUNE_SEED``: exploration RNG seed."""
    return env_int("KEYSTONE_TUNE_SEED", 0)


def tune_time_budget_s() -> float:
    """``KEYSTONE_TUNE_TIME_S``: per-task wall-clock budget."""
    return env_float("KEYSTONE_TUNE_TIME_S", 120.0)


# ----------------------------------------------------------------- the space


@dataclass
class TuneSpace:
    """A named grid of knob axes. Numeric axes are encoded log2 for the
    cost model; categorical axes one-hot over their candidate values."""

    name: str
    axes: Dict[str, Sequence[Any]]

    def grid(self) -> List[Dict[str, Any]]:
        names = sorted(self.axes)
        combos = itertools.product(*(self.axes[n] for n in names))
        return [dict(zip(names, c)) for c in itertools.islice(combos, _MAX_GRID)]

    def encode(self, cand: Dict[str, Any]) -> List[float]:
        feats: List[float] = []
        for name in sorted(self.axes):
            values = list(self.axes[name])
            v = cand[name]
            if all(isinstance(x, (int, float)) and not isinstance(x, bool)
                   for x in values):
                # log2 + its square: a ridge fit becomes a log-space
                # parabola, the shape a knob sweep's basin actually has
                # (too-small chunks pay dispatch, too-large pay memory).
                lg = float(np.log2(1.0 + float(v)))
                feats.extend((lg, lg * lg))
            else:
                feats.extend(1.0 if v == x else 0.0 for x in values)
        return feats


# ------------------------------------------------------------ the cost model


class RidgeCostModel:
    """Closed-form ridge regression on encoded knob features → log cost.

    Small-sample-friendly on purpose: after 3-4 measurements on a smooth
    knob surface the log-linear fit already ranks unmeasured candidates
    well enough to steer the budget toward the optimum — the point is to
    spend measured runs near the winner, not to be a perfect model."""

    def __init__(self, l2: float = 1e-2):
        self.l2 = l2
        self.coef: Optional[np.ndarray] = None
        self._mu: Optional[np.ndarray] = None
        self._sigma: Optional[np.ndarray] = None

    def fit(self, features: Sequence[Sequence[float]], cost: Sequence[float]):
        x = np.asarray(features, dtype=np.float64)
        y = np.log(np.maximum(np.asarray(cost, dtype=np.float64), 1e-12))
        # Standardize: the quadratic log2 features are ~100× the one-hot
        # ones, and an un-scaled ridge penalty would crush exactly the
        # curvature term the basin fit needs.
        self._mu = x.mean(axis=0)
        self._sigma = np.where((s := x.std(axis=0)) > 1e-9, s, 1.0)
        xb = self._design(x)
        a = xb.T @ xb + self.l2 * np.eye(xb.shape[1])
        self.coef = np.linalg.solve(a, xb.T @ y)
        return self

    def _design(self, x: np.ndarray) -> np.ndarray:
        z = (x - self._mu) / self._sigma
        return np.hstack([z, np.ones((len(z), 1))])

    def predict(self, features: Sequence[Sequence[float]]) -> np.ndarray:
        if self.coef is None:
            raise RuntimeError("model not fitted")
        return self._design(np.asarray(features, dtype=np.float64)) @ self.coef


# ---------------------------------------------------------------- the search


@dataclass
class Measurement:
    knobs: Dict[str, Any]
    objective: float
    extra: Dict[str, Any] = field(default_factory=dict)
    proposed_by: str = "explore"


@dataclass
class TuneOutcome:
    task: str
    winner: Optional[Measurement]
    default: Optional[Measurement]
    measured: List[Measurement]
    maximize: bool
    seconds: float

    @property
    def improved(self) -> bool:
        """Winner strictly better than the env-default candidate ON THE
        SAME measurement runs — deterministic, no noise window: the
        default is always one of the measured candidates."""
        if self.winner is None or self.default is None:
            return False
        if self.maximize:
            return self.winner.objective > self.default.objective
        return self.winner.objective < self.default.objective

    def to_json(self) -> Dict[str, Any]:
        return {
            "task": self.task,
            "maximize": self.maximize,
            "winner": None if self.winner is None else self.winner.knobs,
            "winner_objective": None
            if self.winner is None else self.winner.objective,
            "default": None if self.default is None else self.default.knobs,
            "default_objective": None
            if self.default is None else self.default.objective,
            "improved": self.improved,
            "candidates_measured": len(self.measured),
            "seconds": round(self.seconds, 3),
            "measured": [
                {"knobs": m.knobs, "objective": m.objective,
                 "proposed_by": m.proposed_by, **m.extra}
                for m in self.measured
            ],
        }


class Tuner:
    """Budgeted model-guided search over a :class:`TuneSpace`.

    Loop: measure the env-default candidate first (the baseline any
    winner must beat), seed with one random candidate, then alternate —
    fit the ridge model on everything measured so far (plus warm-start
    rows from prior profile-store history), measure its best predicted
    unmeasured candidate, with an ``explore`` fraction of proposals
    replaced by uniform random picks. Stops at the candidate budget, the
    wall-clock budget, or grid exhaustion, whichever first."""

    def __init__(
        self,
        budget: Optional[int] = None,
        explore: Optional[float] = None,
        seed: Optional[int] = None,
        time_budget_s: Optional[float] = None,
        model: Optional[RidgeCostModel] = None,
    ):
        self.budget = budget if budget is not None else tune_budget()
        self.explore = explore if explore is not None else tune_explore()
        self.time_budget_s = (
            time_budget_s if time_budget_s is not None else tune_time_budget_s()
        )
        self.rng = np.random.RandomState(seed if seed is not None else tune_seed())
        self.model = model or RidgeCostModel()

    def search(
        self,
        space: TuneSpace,
        measure: Callable[[Dict[str, Any]], Any],
        default: Optional[Dict[str, Any]] = None,
        maximize: bool = False,
        warm: Sequence[Tuple[Dict[str, Any], float]] = (),
    ) -> TuneOutcome:
        """Run the budgeted search; ``measure(candidate)`` returns the
        objective (float) or ``(objective, extra_dict)``. ``warm`` rows
        — (knobs, objective) from prior store history — train the model
        without costing budget."""
        t0 = time.perf_counter()
        grid = space.grid()
        if default is not None and default not in grid:
            grid.insert(0, dict(default))
        measured: List[Measurement] = []
        seen: set = set()
        candidates_metric = _names.metric(_names.TUNE_CANDIDATES)

        def key(c: Dict[str, Any]) -> str:
            return json.dumps(c, sort_keys=True, default=repr)

        def run(cand: Dict[str, Any], proposed_by: str) -> Optional[Measurement]:
            seen.add(key(cand))
            try:
                # Each probe is card time taken from serving: under a
                # process scheduler it runs as a cost-tagged lease — a
                # pressured card defers the probe (skipping a candidate
                # costs accuracy of the tune, not correctness), an idle
                # one admits it.
                from ..sched.scheduler import LeaseRequest, get_scheduler

                scheduler = get_scheduler()
                if scheduler is None:
                    result = measure(cand)
                else:
                    with scheduler.lease(
                        LeaseRequest(
                            name=f"tune:{space.name}", kind="tune_probe"
                        )
                    ) as probe_lease:
                        if probe_lease is None:  # deferred: skip candidate
                            _spans.add_span_event(
                                "tune_candidate_deferred", task=space.name
                            )
                            return None
                        result = measure(cand)
            except Exception as e:
                logger.warning(
                    "tune[%s]: candidate %s failed (%s)", space.name, cand, e
                )
                _spans.add_span_event(
                    "tune_candidate_failed", task=space.name, error=str(e)[:200]
                )
                return None
            objective, extra = (
                result if isinstance(result, tuple) else (result, {})
            )
            m = Measurement(dict(cand), float(objective), dict(extra), proposed_by)
            measured.append(m)
            candidates_metric.inc(task=space.name)
            _spans.add_span_event(
                "tune_candidate", task=space.name,
                objective=float(objective), proposed_by=proposed_by,
                **{f"knob:{k}": repr(v) for k, v in cand.items()},
            )
            return m

        def out_of_budget() -> bool:
            return (
                len(measured) >= self.budget
                or time.perf_counter() - t0 > self.time_budget_s
            )

        with _spans.span("tune:search", task=space.name, budget=self.budget):
            default_m = run(default, "default") if default is not None else None
            remaining = [c for c in grid if key(c) not in seen]
            if remaining and not out_of_budget():
                pick = remaining[self.rng.randint(len(remaining))]
                run(pick, "explore")
            while not out_of_budget():
                remaining = [c for c in grid if key(c) not in seen]
                if not remaining:
                    break
                proposed_by = "explore"
                cand = remaining[self.rng.randint(len(remaining))]
                if measured and self.rng.random_sample() >= self.explore:
                    try:
                        rows = [
                            (space.encode(m.knobs), self._cost(m.objective, maximize))
                            for m in measured
                        ] + [
                            (space.encode(k), self._cost(o, maximize))
                            for k, o in warm
                        ]
                        self.model.fit([r[0] for r in rows], [r[1] for r in rows])
                        preds = self.model.predict(
                            [space.encode(c) for c in remaining]
                        )
                        cand = remaining[int(np.argmin(preds))]
                        proposed_by = "model"
                    except Exception as e:  # singular fits etc: explore
                        logger.debug("tune[%s]: model propose failed (%s)",
                                     space.name, e)
                run(cand, proposed_by)
        seconds = time.perf_counter() - t0
        _names.metric(_names.TUNE_SECONDS).observe(seconds, task=space.name)
        winner = None
        if measured:
            winner = (max if maximize else min)(
                measured, key=lambda m: m.objective
            )
        return TuneOutcome(
            task=space.name, winner=winner, default=default_m,
            measured=measured, maximize=maximize, seconds=seconds,
        )

    @staticmethod
    def _cost(objective: float, maximize: bool) -> float:
        """The model always minimizes a positive cost: walls directly,
        throughputs reciprocally."""
        return 1.0 / max(objective, 1e-12) if maximize else max(objective, 1e-12)


# ------------------------------------------------------------- measure tasks
#
# Real measured runs on synthetic data at the caller's target shape, on
# ``device``. Each task persists EVERY measured candidate to the profile
# store under the keys MeasuredKnobRule / the block-sparse dispatch
# already read, with source="tune" provenance — the rule's best-entry
# queries then naturally select the winner.


def _warm_from_store(
    store,
    key_prefix: str,
    shape: str,
    space: TuneSpace,
    field_map: Dict[str, str],
    objective_field: str,
    maximize: bool,
) -> List[Tuple[Dict[str, Any], float]]:
    """Warm-start rows for the cost model from the store's own measured
    history: entries under ``key_prefix`` at the exact shape class whose
    measurements carry EVERY space axis (via ``field_map``:
    axis → measurement field) and the objective."""
    if store is None:
        return []
    rows: List[Tuple[Dict[str, Any], float]] = []
    try:
        for _key, _shape, m in store.entries(key_prefix=key_prefix, shape=shape):
            if objective_field not in m:
                continue
            knobs: Dict[str, Any] = {}
            for axis, field_name in field_map.items():
                if field_name not in m:
                    knobs = {}
                    break
                knobs[axis] = m[field_name]
            if knobs:
                rows.append((knobs, float(m[objective_field])))
    except Exception:  # a broken store must never block tuning
        return []
    usable = []
    for knobs, objective in rows:
        try:
            space.encode(knobs)
        except Exception:
            continue
        if objective > 0 or not maximize:
            usable.append((knobs, objective))
    return usable


def _synthetic_problem(rows: int, dim: int, classes: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, dim).astype(np.float32)
    w = rng.randn(dim, classes).astype(np.float32)
    y = (x @ w + 0.01 * rng.randn(rows, classes)).astype(np.float32)
    return x, y


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tune_stream(
    tuner: Tuner,
    store,
    rows: int = 8192,
    dim: int = 256,
    classes: int = 4,
    device: Any = None,
) -> TuneOutcome:
    """Search chunk_rows × prefetch (× shards on an ambient mesh with
    several row shards) for the streaming engine at the target shape;
    measured as real ``fit_stream`` runs from host rows into the
    device (second of two, so first-shape costs such as cuBLAS handles
    stay out of the comparison). The objective is the fold's OWN rows/s —
    the number the engine records and ``MeasuredKnobRule`` maximizes.
    Entries land under the EMPTY featurize-chain class
    (``chain_class(())``, a dataset fed straight into the estimator)."""
    from ..data.dataset import ArrayDataset
    from ..device import resolve_device
    from ..obs.store import dataset_shape_class
    from ..ops.learning.block import BlockLeastSquaresEstimator
    from ..parallel.mesh import get_mesh, row_shard_count
    from ..parallel.partitioner import Partitioner
    from .streaming import (
        StreamingFitOperator,
        chain_class,
        last_stream_report,
        stream_chunk_rows,
    )

    device = resolve_device(device)
    x, y = _synthetic_problem(rows, dim, classes)
    data, labels = ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu")
    shape = dataset_shape_class(data)
    est = BlockLeastSquaresEstimator(min(128, dim), num_iter=1, reg=1e-3, device=device)
    chunk_cands = sorted(
        {c for c in (256, 512, 1024, 2048, 4096, 8192) if c <= max(rows // 2, 256)}
    )
    ndev = row_shard_count(get_mesh())
    axes: Dict[str, Sequence[Any]] = {
        "chunk_rows": chunk_cands,
        "prefetch": [1, 2],
        "shards": [1] if ndev == 1 else [1, ndev],
    }
    default = {"chunk_rows": min(stream_chunk_rows(), max(chunk_cands)), "prefetch": 1, "shards": 1}

    def measure(cand):
        wall = rows_per_s = None
        chunk_actual = int(cand["chunk_rows"])
        shards_actual = 1
        for _ in range(2):  # second run: first-shape costs excluded
            op = StreamingFitOperator(
                est, (), chunk_rows=int(cand["chunk_rows"]), prefetch=int(cand["prefetch"]),
            )
            if int(cand["shards"]) > 1:
                decision = Partitioner().decide_stream(op.label, int(cand["chunk_rows"]), rows=rows, record=False)
                if not decision.eligible:
                    # An unsharded run must not be scored (and persisted)
                    # as a shards=N configuration.
                    raise RuntimeError(
                        f"partition decision ineligible ({decision.reason}): "
                        f"shards={cand['shards']} candidate never ran sharded"
                    )
                op.partition = decision
                op.chunk_rows = decision.chunk_rows
                # What actually ran: the shard-rounded chunk and the
                # decided shard count.
                chunk_actual = int(decision.chunk_rows)
                shards_actual = int(decision.shards)
            before = last_stream_report()
            t0 = time.perf_counter()
            op.fit_datasets([data, labels])
            _sync(device)
            wall = time.perf_counter() - t0
            report = last_stream_report()
            # A materialized fallback publishes NO report: scoring it would
            # persist a lie the knob rule then replays into real plans.
            if report is None or report is before or not report.compute_done_t:
                raise RuntimeError(
                    "streamed fit fell back to the materialized path — "
                    "no fold throughput to score this candidate with"
                )
            rows_per_s = report.num_examples / max(report.compute_done_t[-1], 1e-9)
        return rows_per_s, {"wall_s": round(wall, 6), "chunk_rows_actual": chunk_actual, "shards_actual": shards_actual}

    space = TuneSpace("stream", axes)
    warm = _warm_from_store(
        store, f"stream:{chain_class(())}:", shape, space,
        {"chunk_rows": "chunk_rows", "prefetch": "prefetch_depth", "shards": "shards"},
        "rows_per_s", maximize=True,
    )
    outcome = tuner.search(space, measure, default=default, maximize=True, warm=warm)
    if store is not None:
        for m in outcome.measured:
            # Keyed and recorded by what actually ran (the partitioner may
            # shard-round chunk_rows), never the requested candidate.
            chunk = int(m.extra.get("chunk_rows_actual", m.knobs["chunk_rows"]))
            prefetch = int(m.knobs["prefetch"])
            shards = int(m.extra.get("shards_actual", 1))
            store.record(
                f"stream:{chain_class(())}:cr{chunk}:p{prefetch}:s{shards}",
                shape,
                chunk_rows=chunk,
                rows_per_s=m.objective,
                prefetch_depth=prefetch,
                shards=shards,
                wall_s=m.extra.get("wall_s"),
                source="tune",
            )
        if outcome.winner is not None:
            _names.metric(_names.TUNE_WINNERS).inc(task="stream")
    return outcome


def tune_solver(
    tuner: Tuner,
    store,
    rows: int = 8192,
    dim: int = 256,
    classes: int = 4,
    device: Any = None,
) -> TuneOutcome:
    """Search block_size × precision for the in-core block least-squares
    solver, measured as FULL estimator fits under ``solver_mode_scope``
    — the same whole-fit wall passive ``_record_solver_observation``
    entries carry, so tuned and observed measurements at a
    ``solver:block_ls:`` key stay commensurable."""
    from ..data.dataset import ArrayDataset
    from ..device import resolve_device
    from ..obs.store import shape_class
    from ..ops.learning.block import BlockLeastSquaresEstimator
    from ..parallel import linalg

    device = resolve_device(device)
    x, y = _synthetic_problem(rows, dim, classes)
    data, labels = ArrayDataset(x, device=device), ArrayDataset(y, device=device)
    # Tiny --dim still gets a non-empty grid: one block spanning the
    # whole feature width.
    blocks = sorted({b for b in (32, 64, 128, 256, 512) if b <= dim}) or [max(1, dim)]
    axes: Dict[str, Sequence[Any]] = {
        "block_size": blocks,
        "precision": ["default", "high", "highest"],
    }
    default = {"block_size": min(128, max(blocks)), "precision": linalg.solver_mode()}
    if default["precision"] not in axes["precision"]:
        axes["precision"] = list(axes["precision"]) + [default["precision"]]

    def measure(cand):
        est = BlockLeastSquaresEstimator(int(cand["block_size"]), num_iter=1, reg=1e-3, device=device)
        wall = None
        with linalg.solver_mode_scope(str(cand["precision"])):
            for _ in range(2):  # second run: first-shape costs excluded
                t0 = time.perf_counter()
                est.fit(data, labels)
                _sync(device)
                wall = time.perf_counter() - t0
        return wall

    space = TuneSpace("solver", axes)
    shape = shape_class(rows, (dim,), "float32")
    warm = _warm_from_store(
        store, "solver:block_ls:", shape, space,
        {"block_size": "block_size", "precision": "precision"},
        "wall_s", maximize=False,
    )
    outcome = tuner.search(space, measure, default=default, maximize=False, warm=warm)
    if store is not None:
        for m in outcome.measured:
            b = int(m.knobs["block_size"])
            p = str(m.knobs["precision"])
            store.record(
                f"solver:block_ls:bs{b}:prec{p}",
                shape,
                wall_s=round(m.objective, 6),
                block_size=b,
                precision=p,
                source="tune",
            )
        if outcome.winner is not None:
            _names.metric(_names.TUNE_WINNERS).inc(task="solver")
    if outcome.winner is not None:
        outcome.winner.extra["donation_probe"] = {
            "status": "not_applicable",
            "reason": "the port's solver does not donate its input buffers; "
                      "torch frees them by reference count",
        }
    return outcome


def tune_blocksparse(
    tuner: Tuner,
    store,
    rows: int = 4096,
    dim: int = 1024,
    classes: int = 4,
    device: Any = None,
) -> TuneOutcome:
    """Measure the block-sparse-vs-dense ESTIMATOR crossover: a density
    sweep where each candidate's objective is the ratio of the sparse
    Gram fit wall (the ELL kernel on the card) to the in-core fit wall
    (< 1 means dispatching sparse wins). The persisted ``threshold`` is
    the highest swept density at which sparse still wins with ≥10%
    margin — 0.0 (never dispatch at this shape) is a legitimate, recorded
    verdict. Each candidate reports the ELL launches its sparse legs made
    (``ell_launches``)."""
    from ..data.dataset import ArrayDataset
    from ..device import resolve_device
    from ..obs.store import shape_class
    from ..ops.cuda import blocksparse as _bs
    from ..ops.learning.block import BlockLeastSquaresEstimator
    from ..utils.sparse import BlockSparseMatrix

    device = resolve_device(device)
    rng = np.random.RandomState(tune_seed())
    # Fine enough a tile grid that low densities EXIST: ≥16 block columns
    # regardless of dim.
    bm = 8
    bn = max(8, min(_bs.default_block_shape(dim)[1], dim // 16))
    y = rng.randn(rows, classes).astype(np.float32)
    labels = ArrayDataset(y, device=device)
    densities = [0.01, 0.02, 0.05, 0.1, 0.2, 0.35]
    est = BlockLeastSquaresEstimator(min(128, dim), num_iter=1, reg=1e-3, device=device)

    def build(density: float) -> BlockSparseMatrix:
        nbr = max(1, rows // bm)
        nbc = max(1, dim // bn)
        keep = rng.rand(nbr, nbc) < density
        keep[0, 0] = True  # never fully empty
        vals = rng.randn(nbr, bm, nbc, bn).astype(np.float32)
        mask = keep[:, None, :, None]
        dense = (vals * mask).reshape(nbr * bm, nbc * bn)[:rows, :dim]
        return BlockSparseMatrix.from_dense(dense, (bm, bn))

    def measure(cand):
        import torch

        bsr = build(float(cand["density"]))
        dense = torch.from_numpy(bsr.to_dense()).to(device)
        features = ArrayDataset(dense)
        sparse_wall = dense_wall = None
        launches_before = _bs.ell_matmul.launches
        for _ in range(2):  # second run: first-shape costs excluded
            t0 = time.perf_counter()
            est._fit_blocksparse(bsr, labels, 1.0, a_dense=dense)
            _sync(device)
            sparse_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            est._fit_in_core(features, labels, est.block_size, device)
            _sync(device)
            dense_wall = time.perf_counter() - t0
        ratio = sparse_wall / max(dense_wall, 1e-9)
        return ratio, {
            "sparse_fit_wall_s": round(sparse_wall, 6),
            "dense_fit_wall_s": round(dense_wall, 6),
            "actual_density": round(bsr.density(), 4),
            "ell_launches": _bs.ell_matmul.launches - launches_before,
        }

    outcome = tuner.search(
        TuneSpace("blocksparse", {"density": densities}),
        measure,
        default={"density": _bs.DEFAULT_DENSITY_THRESHOLD},
        maximize=False,
    )
    if store is not None and outcome.measured:
        winning = [m for m in outcome.measured if m.objective < 1.0 / 1.1]
        threshold = max(float(m.knobs["density"]) for m in winning) if winning else 0.0
        best = min(outcome.measured, key=lambda m: m.objective)
        store.record(
            "blocksparse:threshold",
            shape_class(rows, (dim,), "float32"),
            threshold=threshold,
            speedup=round(1.0 / max(best.objective, 1e-9), 3),
            block_shape=f"{bm}x{bn}",
            source="tune",
        )
        _names.metric(_names.TUNE_WINNERS).inc(task="blocksparse")
    return outcome


TASKS: Dict[str, Callable[..., TuneOutcome]] = {
    "stream": tune_stream,
    "solver": tune_solver,
    "blocksparse": tune_blocksparse,
}


# ----------------------------------------------------------------------- CLI
# (Flag wiring lives in cli.py::add_tune_arguments: the CLI's help/list
# paths import no torch.)


def tune_from_args(args) -> int:
    from ..obs import store as _store

    store = _store.get_store()
    if store is None:
        print("tune: profile store disabled (KEYSTONE_PROFILE_STORE=off) — "
              "nowhere to persist winners")
        return 2
    tuner = Tuner(budget=args.budget, seed=args.seed, time_budget_s=args.time_budget_s)
    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    unknown = [t for t in tasks if t not in TASKS]
    if unknown:
        print(f"tune: unknown tasks {unknown} (expected {sorted(TASKS)})")
        return 2
    results: Dict[str, Any] = {}
    ok = True
    for task in tasks:
        outcome = TASKS[task](
            tuner, store, rows=args.rows, dim=args.dim, classes=args.classes,
            device=args.device,
        )
        results[task] = outcome.to_json()
        win = outcome.winner.knobs if outcome.winner else None
        print(
            f"tune[{task}]: {len(outcome.measured)} candidates in "
            f"{outcome.seconds:.1f}s; winner {win} "
            f"({'beats' if outcome.improved else 'matches'} default)"
        )
        ok = ok and outcome.winner is not None
    payload = {"store": store.stats(), "by_source": store.by_source(), "tasks": results}
    print("TUNE_JSON:" + json.dumps(payload))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return 0 if ok else 1
