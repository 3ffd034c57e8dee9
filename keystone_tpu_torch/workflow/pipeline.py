"""Typed pipeline API: Transformer / Estimator / LabelEstimator / Pipeline.

Port of ``keystone_tpu/workflow/pipeline.py`` with the same chaining
surface: ``to_pipeline``, ``then``, ``then_estimator``,
``then_label_estimator``, ``>>``, ``pipeline(data).get()`` and
``Pipeline.fit()`` → :class:`FittedPipeline`.

A pipeline is a small immutable DAG of :class:`_Node` s between one
input placeholder (the source) and one output (the sink). Nothing runs
until ``.get()``; the executor is eager and memoised — within one
``get`` each node runs once, and an estimator bound to data fits once
per process (its fitted transformer is kept on its node). There is no
graph optimizer here: the JAX package's common-subexpression, autocache,
fusion, streaming and partitioning rules are later work.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..data.dataset import ArrayDataset, Dataset, ObjectDataset, as_dataset


# ------------------------------------------------------------------- graph


class _Source:
    """The unbound pipeline input."""


class _Data:
    """A bound dataset or datum."""

    def __init__(self, value: Any):
        self.value = value


class _Fit:
    """Fit ``estimator`` on its dependencies' outputs (once)."""

    def __init__(self, estimator: "Estimator | LabelEstimator"):
        self.estimator = estimator


class _Delegate:
    """Apply the transformer that dependency 0 produced to dependency 1."""


class _Node:
    """One vertex: ``op`` applied to the outputs of ``deps``."""

    __slots__ = ("op", "deps", "fitted")

    def __init__(self, op: Any, deps=()):
        self.op = op
        self.deps = tuple(deps)
        self.fitted = None  # a _Fit node's transformer, once fit


def _substitute(node: _Node, mapping: Dict[int, _Node], memo=None) -> _Node:
    """``node``'s DAG with the nodes in ``mapping`` (by id) replaced.
    Subgraphs that do not reach a replaced node are shared, so a bound
    estimator keeps its fitted state."""
    memo = {} if memo is None else memo
    key = id(node)
    if key in mapping:
        return mapping[key]
    if key not in memo:
        deps = tuple(_substitute(d, mapping, memo) for d in node.deps)
        if all(a is b for a, b in zip(deps, node.deps)):
            memo[key] = node
        else:
            memo[key] = _Node(node.op, deps)
    return memo[key]


def _run_transformer(t: "Transformer", value: Any) -> Any:
    return t.apply_batch(value) if isinstance(value, Dataset) else t.apply(value)


def _evaluate(node: _Node, memo: Dict[int, Any]) -> Any:
    key = id(node)
    if key in memo:
        return memo[key]
    op = node.op
    if isinstance(op, _Source):
        raise ValueError("pipeline input is unbound; apply the pipeline to data")
    if isinstance(op, _Data):
        out = op.value
    elif isinstance(op, _Fit):
        if node.fitted is None:
            node.fitted = op.estimator.fit_datasets(
                [_evaluate(d, memo) for d in node.deps]
            )
        out = node.fitted
    elif isinstance(op, _Delegate):
        fitted = _evaluate(node.deps[0], memo)
        out = _run_transformer(fitted, _evaluate(node.deps[1], memo))
    else:
        out = _run_transformer(op, _evaluate(node.deps[0], memo))
    memo[key] = out
    return out


# --------------------------------------------------------------------- results


class PipelineResult:
    """Lazy handle on a pipeline output."""

    def __init__(self, node: _Node):
        self.node = node

    def get(self) -> Any:
        return _evaluate(self.node, {})


class PipelineDataset(PipelineResult):
    """Lazy dataset result."""

    def collect(self) -> List[Any]:
        return self.get().collect()

    def __len__(self) -> int:
        return len(self.get())


class PipelineDatum(PipelineResult):
    pass


# -------------------------------------------------------------------- chaining


class Chainable:
    """Mixin providing ``then`` / ``>>`` composition."""

    def to_pipeline(self) -> "Pipeline":
        raise NotImplementedError

    def then(self, nxt: "Chainable") -> "Pipeline":
        """``self`` then ``nxt``."""
        this = self.to_pipeline()
        other = nxt.to_pipeline()
        sink = _substitute(other.sink, {id(other.source): this.sink})
        return Pipeline(this.source, sink)

    def then_estimator(self, est: "Estimator", data: Any) -> "Pipeline":
        """Fit ``est`` on this pipeline applied to ``data``; the result
        applies self then the fit transformer."""
        return self.then(est.with_data(self.to_pipeline().apply(data)))

    def then_label_estimator(
        self, est: "LabelEstimator", data: Any, labels: Any
    ) -> "Pipeline":
        return self.then(est.with_data(self.to_pipeline().apply(data), labels))

    def __rshift__(self, nxt: "Chainable") -> "Pipeline":
        return self.then(nxt)


# ----------------------------------------------------------------- transformer


class Transformer(Chainable):
    """Typed unary transformer. Subclasses implement ``apply`` (one
    datum) and optionally override ``apply_batch``."""

    def apply(self, datum: Any) -> Any:
        raise NotImplementedError

    def apply_batch(self, dataset: Dataset) -> Dataset:
        return dataset.map(self.apply)

    def to_pipeline(self) -> "Pipeline":
        source = _Node(_Source())
        return Pipeline(source, _Node(self, [source]))

    def __call__(self, data: Any) -> Any:
        if isinstance(data, (Dataset, PipelineDataset)):
            return self.to_pipeline().apply(data)
        return self.apply(data)


class BatchTransformer(Transformer):
    """Transformer whose native form is a whole-batch tensor function.

    Subclasses implement ``apply_arrays(tensor) -> tensor``, which must be
    row-independent. Batch application keeps rows past ``num_examples``
    exactly zero, so downstream sums over the example axis ignore padding.
    """

    def apply_arrays(self, data: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, datum: Any) -> Any:
        return self.apply_arrays(torch.as_tensor(datum)[None])[0]

    def apply_batch(self, dataset: Dataset) -> ArrayDataset:
        if isinstance(dataset, ObjectDataset):
            dataset = dataset.to_arrays()
        if not isinstance(dataset, ArrayDataset):
            raise TypeError(f"cannot batch-apply to {type(dataset).__name__}")
        out = dataset.map_batched(self.apply_arrays)
        if out.physical_rows > out.num_examples:
            # where (not multiply): log/div turn zero pad rows into NaN/Inf,
            # and 0*NaN is NaN — select restores exact 0.
            real = out.mask().bool().reshape((-1,) + (1,) * (out.data.ndim - 1))
            out = ArrayDataset(
                torch.where(real, out.data, torch.zeros((), dtype=out.data.dtype,
                                                        device=out.data.device)),
                out.num_examples,
            )
        return out


# ------------------------------------------------------------------ estimators


def _bound(data: Any) -> _Node:
    """A node producing ``data`` (a dataset or a lazy pipeline result)."""
    if isinstance(data, PipelineDataset):
        return data.node
    return _Node(_Data(as_dataset(data)))


class Estimator:
    """Unsupervised estimator."""

    def fit(self, data: Dataset) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, datasets: List[Dataset]) -> Transformer:
        return self.fit(datasets[0])

    def with_data(self, data: Any) -> "Pipeline":
        """Bind training data now; the pipeline applies the (lazily) fit
        transformer to its input."""
        fit = _Node(_Fit(self), [_bound(data)])
        source = _Node(_Source())
        return Pipeline(source, _Node(_Delegate(), [fit, source]))


class LabelEstimator:
    """Supervised estimator."""

    def fit(self, data: Dataset, labels: Dataset) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, datasets: List[Dataset]) -> Transformer:
        return self.fit(datasets[0], datasets[1])

    def with_data(self, data: Any, labels: Any) -> "Pipeline":
        fit = _Node(_Fit(self), [_bound(data), _bound(labels)])
        source = _Node(_Source())
        return Pipeline(source, _Node(_Delegate(), [fit, source]))


# -------------------------------------------------------------------- pipeline


def _is_dataset_like(data: Any) -> bool:
    return isinstance(data, (Dataset, list, tuple, np.ndarray, torch.Tensor))


class Pipeline(Chainable):
    """A single-input single-output dataflow with fit-on-demand semantics."""

    def __init__(self, source: _Node, sink: _Node):
        self.source = source
        self.sink = sink

    def to_pipeline(self) -> "Pipeline":
        return self

    def apply(self, data: Any) -> PipelineResult:
        if isinstance(data, PipelineDataset):
            return PipelineDataset(_substitute(self.sink, {id(self.source): data.node}))
        if _is_dataset_like(data):
            bound = _Node(_Data(as_dataset(data)))
            return PipelineDataset(_substitute(self.sink, {id(self.source): bound}))
        bound = _Node(_Data(data))
        return PipelineDatum(_substitute(self.sink, {id(self.source): bound}))

    def __call__(self, data: Any) -> PipelineResult:
        return self.apply(data)

    def fit(self) -> "FittedPipeline":
        """Fit every bound estimator and return a transformer-only
        pipeline: each delegating node becomes its fit transformer."""
        memo: Dict[int, _Node] = {}

        def splice(node: _Node) -> _Node:
            key = id(node)
            if key not in memo:
                if isinstance(node.op, _Delegate):
                    fitted = _evaluate(node.deps[0], {})
                    memo[key] = _Node(fitted, [splice(node.deps[1])])
                elif node.deps:
                    memo[key] = _Node(node.op, [splice(d) for d in node.deps])
                else:
                    memo[key] = node
            return memo[key]

        return FittedPipeline(self.source, splice(self.sink))


# ------------------------------------------------------------- fitted pipeline


class FittedPipeline(Transformer):
    """Transformer-only pipeline: no estimators, no re-fitting."""

    def __init__(self, source: _Node, sink: _Node):
        self.source = source
        self.sink = sink

    def _run(self, value: Any) -> Any:
        bound = _Node(_Data(value))
        return _evaluate(_substitute(self.sink, {id(self.source): bound}), {})

    def apply(self, datum: Any) -> Any:
        return self._run(datum)

    def apply_batch(self, dataset: Dataset) -> Dataset:
        return self._run(dataset)


__all__ = [
    "BatchTransformer",
    "Chainable",
    "Estimator",
    "FittedPipeline",
    "LabelEstimator",
    "Pipeline",
    "PipelineDataset",
    "PipelineDatum",
    "PipelineResult",
    "Transformer",
]
