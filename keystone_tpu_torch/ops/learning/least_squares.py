"""Optimizable least-squares meta-solver.

Port of ``keystone_tpu/ops/learning/least_squares.py`` (reference:
nodes/learning/LeastSquaresEstimator.scala:26-87) — a cost-model-driven
choice among the concrete least-squares solvers:

- dense L-BFGS          (few features, dense data)
- sparse L-BFGS         (sparse data, on the host)
- block solve           (many features, dense)
- exact normal equations (few features)
- sketched              (very wide; ``sketch/solvers.py``)

Statistics (n, d, k, sparsity) come from the node-level optimizer's
sample pass. The cost formulas are the JAX package's, verbatim; the
weights are ``cost.default_cost_weights(device)``: the card's data-sheet
peaks on CUDA, the reference's cluster constants on the CPU. The port
runs on one device, so ``num_machines=None`` resolves to 1.

The sketched rung (``sketch/solvers.py``, imported lazily as in the JAX
package) is priced at the sketch size the fit will run
(``SketchedLeastSquaresEstimator._resolve_sketch_size``: env knob >
constructor > measured winner > width default) and is eligible from
``KEYSTONE_SKETCH_MIN_WIDTH`` (default 8,192) on; the streamed fit's
width dispatch hands it every stream at least that wide.

The refit state contract (``refit/state.py``) is the delegate's: the
streamed fit exports the chosen rung's captured state, and
``finish_from_state`` finishes a "sketch" state on the sketched rung and
a "gram" state on the Gram rung its width picks.

One departure in the sample statistics: a scipy item may hold several
rows (a whole CSR matrix in one ``ObjectDataset`` item, as the JAX
sweep builds it), and its density is taken over all of its rows. The
JAX package reads such an item's nnz as one row's.

``fit`` without the optimizer is a ``DegradationLadder`` over
``dense_lbfgs`` → ``block`` with the JAX wiring: a
``probe("LeastSquaresEstimator.solve")`` at the head of each attempt, a
``rung_span`` per attempt inside one ``fit_span``, a
``solver:least_squares:rung_<rung>`` profile-store record, and a
``degradation`` record (with the block solver's own nested as
``inner``) on a model fitted below the first rung.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike
from ...workflow.optimize import DataStats, Optimizable
from ...workflow.pipeline import LabelEstimator, Transformer
from .block import BlockLeastSquaresEstimator
from .cost import DEFAULT_COST_WEIGHTS, CostModel, CostWeights, default_cost_weights
from .lbfgs import DenseLBFGSEstimator, SparseLBFGSEstimator
from .linear import LinearMapEstimator

class _DenseLBFGSCost(CostModel):
    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS):
        iters = 20
        flops = iters * n * d * k * max(sparsity, 1e-12) / num_machines
        bytes_scanned = iters * n * d * max(sparsity, 1e-12) / num_machines
        network = iters * d * k * np.log2(max(num_machines, 2))
        return max(w.cpu * flops, w.mem * bytes_scanned) + w.network * network


class _SparseLBFGSCost(_DenseLBFGSCost):
    pass


class _BlockSolveCost(CostModel):
    def __init__(self, block_size=1000, num_iter=3):
        self.block_size = block_size
        self.num_iter = num_iter

    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS):
        b = self.block_size
        iters = self.num_iter * max(d // b, 1)
        flops = iters * (n * b * (b + k)) / num_machines
        bytes_scanned = iters * n * b / num_machines
        network = iters * (b * b + b * k) * np.log2(max(num_machines, 2))
        return max(w.cpu * flops, w.mem * bytes_scanned) + w.network * network


class _ExactCost(CostModel):
    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS):
        flops = n * d * (d + k) / num_machines + d * d * d
        bytes_scanned = n * d / num_machines + d * d
        network = d * (d + k)
        return max(w.cpu * flops, w.mem * bytes_scanned) + w.network * network


class _SketchCost(CostModel):
    """The sketched rung: one data pass into an O(s·d) carry plus an s×s
    finish solve. Priced at infinity below ``sketch_min_width()``."""

    def __init__(self, sketch_size: int):
        self.sketch_size = sketch_size

    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS):
        from ...sketch.solvers import sketch_min_width

        if d < sketch_min_width():
            return np.inf
        s = self.sketch_size
        flops = n * (d + k) / num_machines + s * s * (d + k) + s * s * s
        bytes_scanned = n * d / num_machines + s * (d + k)
        network = s * (d + k)
        return max(w.cpu * flops, w.mem * bytes_scanned) + w.network * network


class LeastSquaresEstimator(LabelEstimator, Optimizable):
    """Meta-solver choosing the concrete least-squares implementation;
    every rung fits on ``device`` (default CUDA)."""

    #: Chunked-fit protocol (workflow/streaming.py). The streaming path
    #: always has the full Gram in hand after accumulation, so the
    #: meta-choice collapses: exact solve for narrow problems, Gram-BCD
    #: for wide ones (L-BFGS needs materialized data passes and is never
    #: the streaming pick).
    supports_fit_stream = True

    #: Refit state contract: the meta-solver's state is whatever its
    #: delegated rung accumulates — Gram for the exact/block rungs,
    #: "sketch" past ``sketch_min_width()``. The class attribute is the
    #: narrow default; ``stream_state_kind_for`` resolves it per stream.
    stream_state_kind = "gram"

    def __init__(
        self,
        reg: float = 0.0,
        num_machines: Optional[int] = None,
        weights: Optional[CostWeights] = None,
        sparse_threshold: float = 0.2,
        block_size: int = 1000,
        block_iters: int = 3,
        device: DeviceLike = None,
    ):
        self.reg = reg
        self.num_machines = num_machines
        # None → resolved per device at optimize() time (the card's
        # peaks on CUDA, the reference's constants on the CPU).
        self.weights = weights
        self.sparse_threshold = sparse_threshold
        self.block_size = block_size
        self.block_iters = block_iters
        self.device = device

    # ------------------------------------------------------------ streaming
    def fit_stream(self, stream, state=None):
        inner = self._stream_solver(_stream_width(stream, self.block_size))
        fitted = inner.fit_stream(stream, state=state)
        # The delegate's captured statistics are the meta-solver's export:
        # the caller never needs to know which rung the width picked.
        self._stream_state = inner.export_stream_state()
        return fitted

    def _stream_solver(self, width: int):
        """The concrete streaming rung for a featurized ``width``: exact
        (narrow) → Gram-BCD (wide) → sketched (very wide, where the O(d²)
        Gram itself is the memory problem)."""
        from ...sketch.solvers import SketchedLeastSquaresEstimator, sketch_min_width

        if width >= sketch_min_width():
            inner = SketchedLeastSquaresEstimator(reg=self.reg, device=self.device)
            tuned = getattr(self, "_tuned_sketch_size", None)
            if tuned:
                inner._tuned_sketch_size = int(tuned)
            return inner
        return self._gram_stream_solver(width)

    def _gram_stream_solver(self, width: int):
        """The Gram-family rung for ``width`` (also the finish path for
        captured Gram carries of any width)."""
        if width > self.block_size:
            return BlockLeastSquaresEstimator(
                self.block_size, num_iter=self.block_iters, reg=self.reg, device=self.device
            )
        # reg>0 is ridge, reg=0 plain least squares that fails loudly on
        # a singular Gram rather than degrading to NaN predictions.
        return LinearMapEstimator(reg=self.reg or None, device=self.device)

    def stream_state_kind_for(self, stream) -> str:
        """The kind of state a streamed fit of ``stream`` captures: the
        rung its width picks."""
        return self._stream_solver(_stream_width(stream, self.block_size)).stream_state_kind

    def stream_state_meta_for(self, stream) -> dict:
        """The chosen rung's envelope meta (the sketched rung's variant
        and seed; empty for the Gram family)."""
        inner = self._stream_solver(_stream_width(stream, self.block_size))
        return dict(getattr(inner, "stream_state_meta", {}) or {})

    # ------------------------------------------------ refit state contract
    def export_stream_state(self):
        return getattr(self, "_stream_state", None)

    def merge_stream_state(self, a, b):
        from ...refit.state import merge_stream_states

        return merge_stream_states(a, b)

    def finish_from_state(self, state):
        """Finish from statistics alone. A "sketch" state finishes on the
        sketched rung whatever its width, under the state's (variant,
        seed); a "gram" state on the Gram rung its (d, d) carry's width
        picks."""
        if state.kind == "sketch":
            from ...sketch.solvers import SketchedLeastSquaresEstimator

            inner = SketchedLeastSquaresEstimator(reg=self.reg, device=self.device)
            if state.meta.get("sketch_variant"):
                inner.variant = state.meta["sketch_variant"]
                inner.seed = int(state.meta.get("sketch_seed", inner.seed))
            return inner.finish_from_state(state)
        return self._gram_stream_solver(int(state.carry[0].shape[0])).finish_from_state(state)

    # --------------------------------------------------------------- fit
    def fit(self, data: Dataset, labels: Dataset) -> Transformer:
        """Default implementation when node-level optimization never ran:
        dense L-BFGS, falling back to the block solver on OOM (whose own
        ladder then shrinks its block); non-OOM failures propagate."""
        from ...obs import solver as solver_obs
        from ...reliability import DegradationLadder, probe

        ladder = DegradationLadder(
            [
                ("dense_lbfgs", self._default),
                (
                    "block",
                    lambda: BlockLeastSquaresEstimator(
                        self.block_size, num_iter=self.block_iters, reg=self.reg,
                        device=self.device,
                    ),
                ),
            ],
            label="LeastSquaresEstimator.fit",
        )

        attempts = iter(range(len(ladder.rungs)))

        def attempt(rung):
            name, factory = rung
            probe("LeastSquaresEstimator.solve")
            with solver_obs.rung_span("least_squares", name, next(attempts)):
                return factory().fit(data, labels)

        t_fit = time.perf_counter()
        with solver_obs.fit_span("least_squares", **solver_obs.predicted_attrs(self)):
            model = ladder.run(attempt)
        # The rung that finally held and what it cost, keyed per shape
        # class: the profile store's record of which concrete solver this
        # problem size wants. Best effort: a store never blocks a fit.
        try:
            from ...obs import store as obs_store

            store = obs_store.get_store()
            if store is not None:
                d_cols = 0
                if isinstance(data, ArrayDataset):
                    arr = data.data
                    d_cols = int(arr.shape[1]) if getattr(arr, "ndim", 1) > 1 else 1
                rung = "dense_lbfgs" if not ladder.reduced else ladder.record["rung"][0]
                store.record(
                    f"solver:least_squares:rung_{rung}",
                    obs_store.shape_class(len(data), (d_cols,), "float32"),
                    wall_s=round(time.perf_counter() - t_fit, 6),
                    solver_rung=rung,
                )
        except Exception:
            pass
        if ladder.reduced:
            record = dict(
                ladder.record, rung=ladder.record["rung"][0],
                first_rung=ladder.record["first_rung"][0],
            )
            # The fallback solver may have degraded internally too (block
            # halving) — nest its record, don't clobber it.
            inner = getattr(model, "degradation", None)
            if inner is not None:
                record["inner"] = inner
            model.degradation = record
        return model

    def _default(self) -> LabelEstimator:
        return DenseLBFGSEstimator(reg=self.reg, device=self.device)

    # ---------------------------------------------------------- optimize
    def candidates(self, n: int, d: int, k: int, sparsity: float) -> list:
        """``(name, cost_ms, estimator, ineligible_reason)`` for every
        rung, in the JAX package's order. Ineligible rungs price at inf
        but stay in the list, so every rung the argmin saw is reported."""
        from ...sketch.solvers import SketchedLeastSquaresEstimator, sketch_min_width

        machines = self.num_machines or 1
        weights = self.weights if self.weights is not None else default_cost_weights(self.device)
        sparse_ok = sparsity < self.sparse_threshold
        sketch_ok = d >= sketch_min_width()
        # Price the sketch size that will actually run: pricing the width
        # default when KEYSTONE_SKETCH_SIZE or a measured winner pins a
        # smaller s would mischarge the rung ~s².
        sketch_probe = SketchedLeastSquaresEstimator(reg=self.reg, device=self.device)
        tuned_s = getattr(self, "_tuned_sketch_size", None)
        if tuned_s:
            sketch_probe._tuned_sketch_size = int(tuned_s)
        sketch_s = sketch_probe._resolve_sketch_size(d)
        return [
            (
                "sparse_lbfgs",
                _SparseLBFGSCost().cost(n, d, k, sparsity, machines, weights)
                if sparse_ok
                else np.inf,
                SparseLBFGSEstimator(reg=self.reg, device=self.device),
                ""
                if sparse_ok
                else f"density {sparsity:.3f} ≥ sparse_threshold "
                f"{self.sparse_threshold}",
            ),
            (
                "dense_lbfgs",
                _DenseLBFGSCost().cost(n, d, k, 1.0, machines, weights),
                DenseLBFGSEstimator(reg=self.reg, device=self.device),
                "",
            ),
            (
                "block",
                _BlockSolveCost(self.block_size, self.block_iters).cost(
                    n, d, k, 1.0, machines, weights
                ),
                BlockLeastSquaresEstimator(
                    self.block_size, num_iter=self.block_iters, reg=self.reg, device=self.device
                ),
                "",
            ),
            (
                "exact",
                _ExactCost().cost(n, d, k, 1.0, machines, weights),
                LinearMapEstimator(reg=self.reg, device=self.device),
                "",
            ),
            (
                "sketched",
                _SketchCost(sketch_s).cost(n, d, k, 1.0, machines, weights),
                sketch_probe,
                ""
                if sketch_ok
                else f"width {d} < KEYSTONE_SKETCH_MIN_WIDTH "
                f"{sketch_min_width()}",
            ),
        ]

    def optimize(self, samples: List[Dataset], stats: DataStats):
        n = stats.n_total
        d, k, sparsity = _sample_shape_stats(samples[0], samples[1] if len(samples) > 1 else None)
        candidates = self.candidates(n, d, k, sparsity)
        cost_ms, chosen = min(((c, est) for _, c, est, _ in candidates), key=lambda c: c[0])
        # Provenance: the chosen rung's predicted cost with every
        # candidate's and the rejected rungs' reasons. The constants are
        # relative (only the argmin matters), so the prediction is
        # displayed but not calibrated.
        from ...obs.cost import Prediction

        provenance = []
        for name, c, est, why in candidates:
            if est is chosen:
                reason = "chosen"
            elif why:
                reason = why
            elif np.isfinite(c):
                reason = f"cost above chosen rung ({c / 1e3:.3g}s)"
            else:
                reason = "ineligible"
            provenance.append(
                (name, None if not np.isfinite(c) else float(c) / 1e3, reason)
            )
        chosen.predicted_cost = Prediction(
            model="solver_ladder",
            key=f"solver:ladder:{type(chosen).__name__}",
            shape=f"n{n}|{d}|k{k}",
            seconds=float(cost_ms) / 1e3,
            calibrated=False,
            candidates=tuple(provenance),
        )
        return chosen


def _stream_width(stream, default: int) -> int:
    """Featurized width of a ChunkStream (specs only, no data touched);
    ``default`` when the chain output is not a plain matrix — the
    downstream fold will fall back to the materialized path anyway."""
    from ...utils.tree import tree_leaves

    try:
        leaves = tree_leaves(stream.feature_aval())
    except Exception:
        return default
    if len(leaves) == 1 and len(leaves[0].shape) == 2:
        return int(leaves[0].shape[1])
    return default


def _sample_shape_stats(sample_x: Dataset, sample_y: Optional[Dataset]):
    """(d, k, density) of the optimizer's sample, read on the host. A
    scipy item may hold several rows; its density is over all of them."""
    if isinstance(sample_x, ArrayDataset):
        x = sample_x.data[: sample_x.num_examples].cpu().numpy()
        d = x.shape[1] if x.ndim > 1 else 1
        sparsity = float((x != 0).mean())
    else:
        items = sample_x.take(32)
        first = items[0]
        if hasattr(first, "nnz"):  # scipy sparse rows
            d = first.shape[1]
            nnz = sum(i.nnz for i in items)
            sparsity = nnz / (sum(i.shape[0] for i in items) * d)
        else:
            arr = np.stack([_host(i) for i in items])
            d = arr.shape[1]
            sparsity = float((arr != 0).mean())
    if sample_y is not None and isinstance(sample_y, ArrayDataset):
        ydata = sample_y.data
        k = ydata.shape[1] if ydata.ndim > 1 else 1
    elif sample_y is not None:
        items = sample_y.take(1)
        k = _host(items[0]).size if items else 1
    else:
        k = 1
    return d, k, sparsity


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


__all__ = ["LeastSquaresEstimator"]
