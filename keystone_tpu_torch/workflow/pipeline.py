"""Typed pipeline API: Transformer / Estimator / LabelEstimator / Pipeline.

Port of ``keystone_tpu/workflow/pipeline.py``
(reference: workflow/Transformer.scala:18-70, workflow/Estimator.scala:10-62,
workflow/LabelEstimator.scala:13-100, workflow/Chainable.scala:13-126,
workflow/Pipeline.scala:22-155, workflow/FittedPipeline.scala:22-48).

- ``a >> b >> est.with_data(data)`` builds an immutable graph
  (``workflow/graph.py``); nothing runs until a result is forced.
- Applying a pipeline yields lazy ``PipelineDataset``/``PipelineDatum``
  handles; ``.get()`` runs the optimizer (``workflow/rules.py``: saved
  state, CSE, node-level optimization) once, then executes with
  memoization (``workflow/executor.py``).
- Estimators bound to data fit **once** per process even across repeated
  applications: results are memoized under structural prefixes in
  ``PipelineEnv.state``.
- ``Pipeline.fit()`` executes every estimator, splices the fit
  transformers in place, prunes fit-time-only branches, and returns a
  ``FittedPipeline`` holding only transformers, with its transformer
  chains fused (``workflow/fusion.py``), which ``save``/``load``
  round-trip.
- ``FittedPipeline.compiled_apply()`` is the serving loop's batch handle
  (``CompiledApply``): the graph bound once, only the dataset swapped
  per call.

Multi-device serving: ``CompiledApply.partition``, installed by
``parallel.partitioner.attach_serving_partition``, splits each batch
whose rows divide the row shards over the mesh and applies the graph
shard by shard.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.dataset import (
    ArrayDataset,
    BucketedDataset,
    Dataset,
    ObjectDataset,
    _as_tensor,
    as_dataset,
)
from ..device import DeviceLike, resolve_device
from ..obs import names as _names
from ..obs import spans as _spans
from ..utils.tree import tree_map
from .executor import GraphExecutor, PipelineEnv
from .graph import Graph, NodeOrSourceId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    TransformerOperator,
)
from .rules import UnusedBranchRemovalRule


# --------------------------------------------------------------------- results


class PipelineResult:
    """Lazy handle on a pipeline output
    (reference: workflow/PipelineResult.scala:13-20)."""

    def __init__(self, executor: GraphExecutor, sink: SinkId, graph: Graph):
        self._executor = executor
        self._sink = sink
        self.graph = graph  # unoptimized graph, for further composition

    def get(self) -> Any:
        return self._executor.execute(self._sink).get()


class PipelineDataset(PipelineResult):
    """Lazy dataset result; duck-types enough of Dataset for evaluators."""

    def collect(self) -> List[Any]:
        return self.get().collect()

    def __len__(self) -> int:
        return len(self.get())


class PipelineDatum(PipelineResult):
    pass


# -------------------------------------------------------------------- chaining


class Chainable:
    """Mixin providing ``then`` / ``>>`` composition
    (reference: workflow/Chainable.scala:13-126)."""

    def to_pipeline(self) -> "Pipeline":
        raise NotImplementedError

    def then(self, nxt: "Chainable") -> "Pipeline":
        """``self`` then ``nxt`` (reference ``andThen``)."""
        this = self.to_pipeline()
        other = nxt.to_pipeline()
        combined, _, sink_map = this.graph.connect_graph(other.graph, {other.source: this.sink})
        return Pipeline(combined, this.source, sink_map[other.sink])

    def then_estimator(self, est: "Estimator", data: Union[Dataset, PipelineDataset, Any]) -> "Pipeline":
        """Fit ``est`` on this pipeline applied to ``data``; the result
        applies self then the fit transformer."""
        return self.then(est.with_data(self.to_pipeline().apply(data)))

    def then_label_estimator(
        self,
        est: "LabelEstimator",
        data: Union[Dataset, PipelineDataset, Any],
        labels: Union[Dataset, PipelineDataset, Any],
    ) -> "Pipeline":
        return self.then(est.with_data(self.to_pipeline().apply(data), labels))

    def __rshift__(self, nxt: "Chainable") -> "Pipeline":
        return self.then(nxt)


# ----------------------------------------------------------------- transformer


class Transformer(TransformerOperator, Chainable):
    """Typed unary transformer (reference: workflow/Transformer.scala:18-70).

    Subclasses implement ``apply`` (one datum) and optionally override
    ``apply_batch`` with a whole-batch implementation.
    """

    def apply(self, datum: Any) -> Any:
        raise NotImplementedError

    def apply_batch(self, dataset: Dataset) -> Dataset:
        return dataset.map(self.apply)

    # Operator protocol -----------------------------------------------------
    def single_transform(self, datums: List[Any]) -> Any:
        return self.apply(datums[0])

    def batch_transform(self, datasets: List[Dataset]) -> Dataset:
        return self.apply_batch(datasets[0])

    # Chaining --------------------------------------------------------------
    def to_pipeline(self) -> "Pipeline":
        graph = Graph()
        graph, source = graph.add_source()
        graph, node = graph.add_node(self, [source])
        graph, sink = graph.add_sink(node)
        return Pipeline(graph, source, sink)

    def __call__(self, data: Any) -> Any:
        if isinstance(data, (Dataset, PipelineDataset)):
            return self.to_pipeline().apply(data)
        return self.apply(data)

    @staticmethod
    def from_fn(fn: Callable[[Any], Any], batch_fn: Optional[Callable] = None, name: str = "") -> "Transformer":
        return _FnTransformer(fn, batch_fn, name)


class _FnTransformer(Transformer):
    def __init__(self, fn, batch_fn=None, name=""):
        self.fn = fn
        self.batch_fn = batch_fn
        self.name = name or getattr(fn, "__name__", "fn")

    @property
    def label(self) -> str:
        return self.name

    def apply(self, datum):
        return self.fn(datum)

    def apply_batch(self, dataset):
        if self.batch_fn is not None and isinstance(dataset, ArrayDataset):
            return dataset.map_batched(self.batch_fn)
        return dataset.map(self.fn)


class Identity(Transformer):
    """reference: workflow/Identity.scala:11"""

    def apply(self, datum: Any) -> Any:
        return datum

    def apply_batch(self, dataset: Dataset) -> Dataset:
        return dataset


def _operator_device(op: Any) -> Optional[torch.device]:
    """The device of the first tensor an operator holds — or, for a fused
    chain, its first member holding one — or None."""
    for value in vars(op).values():
        if isinstance(value, torch.Tensor):
            return value.device
    for member in getattr(op, "members", ()):
        device = _operator_device(member)
        if device is not None:
            return device
    return None


class BatchTransformer(Transformer):
    """Transformer whose native form is a whole-batch tensor function.

    Subclasses implement ``apply_arrays(tree) -> tree`` over a tensor (or a
    tuple/list/dict of tensors), which must be row-independent. Batch
    application keeps rows past ``num_examples`` exactly zero, so
    downstream sums over the example axis ignore padding.

    Row independence is also the contract the fusion pass
    (``workflow/fusion.py``) relies on to compose consecutive
    transformers into one operator. Ops that manage their own dispatch
    set ``fusable = False`` to opt out.
    """

    #: Chain-fusion opt-out (see workflow/fusion.py).
    fusable: bool = True
    #: True only on FusedTransformerOperator (dispatch accounting label).
    _is_fused: bool = False

    def apply_arrays(self, data: Any) -> Any:
        raise NotImplementedError

    def apply(self, datum: Any) -> Any:
        # A tensor datum stays where it is; a host datum (numpy, a scalar,
        # a list) goes to the device of this operator's tensors, or to the
        # default CUDA device — never silently to the CPU.
        device = _operator_device(self)
        batched = tree_map(
            lambda a: (a if isinstance(a, torch.Tensor) else _as_tensor(a, device))[None],
            datum,
        )
        out = self.apply_arrays(batched)
        return tree_map(lambda a: a[0], out)

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, BucketedDataset):
            # One application per static-shape bucket.
            return dataset.map_datasets(self.apply_batch)
        # Dispatch accounting: one count per batch application; a fused
        # chain counts once (fused="1") where its members unfused count
        # once each — the direct evidence for the fusion pass.
        _names.metric(_names.FUSION_BATCH_DISPATCHES).inc(fused="1" if self._is_fused else "0")
        if isinstance(dataset, ObjectDataset):
            dataset = dataset.to_arrays(device=_operator_device(self))
        if not isinstance(dataset, ArrayDataset):
            raise TypeError(f"cannot batch-apply to {type(dataset).__name__}")
        out = dataset.map_batched(self.apply_arrays)
        if out.physical_rows > out.num_examples:
            real_row = out.mask().bool()

            def zero_pad_rows(a):
                # where (not multiply): log/div turn zero pad rows into
                # NaN/Inf, and 0*NaN is NaN — select restores exact 0.
                m = real_row.reshape((-1,) + (1,) * (a.ndim - 1))
                return torch.where(m, a, torch.zeros((), dtype=a.dtype, device=a.device))

            out = ArrayDataset(tree_map(zero_pad_rows, out.data), out.num_examples)
        return out


# ------------------------------------------------------------------ estimators


class Estimator(EstimatorOperator):
    """Unsupervised estimator (reference: workflow/Estimator.scala:10-62)."""

    def fit(self, data: Dataset) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, datasets: List[Dataset]) -> TransformerOperator:
        return self.fit(datasets[0])

    def with_data(self, data: Union[Dataset, PipelineDataset, Any]) -> "Pipeline":
        """Bind training data now; returns a pipeline applying the (lazily)
        fit transformer to its input (reference: Estimator.scala:29-46)."""
        graph = Graph()
        graph, data_dep = _attach_data(graph, data)
        graph, est_node = graph.add_node(self, [data_dep])
        graph, source = graph.add_source()
        graph, delegating = graph.add_node(DelegatingOperator(), [est_node, source])
        graph, sink = graph.add_sink(delegating)
        return Pipeline(graph, source, sink)


class LabelEstimator(EstimatorOperator):
    """Supervised estimator (reference: workflow/LabelEstimator.scala:13-100)."""

    def fit(self, data: Dataset, labels: Dataset) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, datasets: List[Dataset]) -> TransformerOperator:
        return self.fit(datasets[0], datasets[1])

    def with_data(
        self,
        data: Union[Dataset, PipelineDataset, Any],
        labels: Union[Dataset, PipelineDataset, Any],
    ) -> "Pipeline":
        graph = Graph()
        graph, data_dep = _attach_data(graph, data)
        graph, labels_dep = _attach_data(graph, labels)
        graph, est_node = graph.add_node(self, [data_dep, labels_dep])
        graph, source = graph.add_source()
        graph, delegating = graph.add_node(DelegatingOperator(), [est_node, source])
        graph, sink = graph.add_sink(delegating)
        return Pipeline(graph, source, sink)


def _attach_data(graph: Graph, data: Any):
    """Attach a dataset (or lazy pipeline result graph) to ``graph``."""
    if isinstance(data, PipelineDataset):
        combined, _, sink_map = graph.add_graph(data.graph)
        inner_sink = sink_map[data._sink]
        dep = combined.get_sink_dependency(inner_sink)
        return combined.remove_sink(inner_sink), dep
    dataset = as_dataset(data)
    graph, node = graph.add_node(DatasetOperator(dataset), [])
    return graph, node


# -------------------------------------------------------------------- pipeline


class Pipeline(Chainable):
    """A single-input single-output dataflow with fit-on-demand semantics."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        self.graph = graph
        self.source = source
        self.sink = sink

    def to_pipeline(self) -> "Pipeline":
        return self

    # ------------------------------------------------------------------ apply
    def apply(self, data: Any) -> PipelineResult:
        if isinstance(data, PipelineDataset):
            combined, source_map, sink_map = data.graph.add_graph(self.graph)
            new_source = source_map[self.source]
            inner_dep = combined.get_sink_dependency(data._sink)
            combined = combined.remove_sink(data._sink)
            combined = combined.replace_dependency(new_source, inner_dep)
            combined = combined.remove_source(new_source)
            sink = sink_map[self.sink]
            return PipelineDataset(GraphExecutor(combined), sink, combined)
        if isinstance(data, (Dataset, list, tuple, np.ndarray, torch.Tensor)):
            dataset = as_dataset(data)
            graph, node = self.graph.add_node(DatasetOperator(dataset), [])
            graph = graph.replace_dependency(self.source, node)
            graph = graph.remove_source(self.source)
            return PipelineDataset(GraphExecutor(graph), self.sink, graph)
        # single datum
        graph, node = self.graph.add_node(DatumOperator(data), [])
        graph = graph.replace_dependency(self.source, node)
        graph = graph.remove_source(self.source)
        return PipelineDatum(GraphExecutor(graph), self.sink, graph)

    def __call__(self, data: Any) -> PipelineResult:
        return self.apply(data)

    # -------------------------------------------------------------------- fit
    def fit(self) -> "FittedPipeline":
        """Execute all estimator fits and return a transformer-only pipeline
        (reference: Pipeline.scala:38-65).

        Before any fit executes, the OPTIMIZED graph goes through the
        plan-time verifier (``workflow/verify.py``): shape/dtype
        mismatches, float64 widening and infeasible streamed fits are
        diagnosed from specs alone, with nothing launched on the card —
        warn by default, ``KEYSTONE_VERIFY=strict`` raises
        ``VerificationError`` here instead of failing later inside a
        kernel. Optimizing and verifying are one ``plan`` span (attribute
        ``nodes``), the verifier a ``plan:verify`` span inside it."""
        from .verify import verify_and_enforce

        env = PipelineEnv.get_or_create()
        with _spans.span("plan", nodes=len(self.graph.nodes)):
            graph, prefixes = env.optimizer.execute(self.graph)
            with _spans.span("plan:verify"):
                verify_and_enforce(graph, context="fit")
        executor = GraphExecutor(graph, optimize=False)
        executor._prefixes = prefixes

        for node in sorted(graph.nodes):
            op = graph.operators.get(node)
            if not isinstance(op, DelegatingOperator):
                continue
            deps = graph.get_dependencies(node)
            transformer_dep, data_deps = deps[0], deps[1:]
            fit_transformer = executor.execute(transformer_dep).get()
            if not isinstance(fit_transformer, TransformerOperator):
                raise TypeError(
                    f"delegating node {node} resolved to {type(fit_transformer).__name__}"
                )
            graph = graph.set_operator(node, fit_transformer)
            graph = graph.set_dependencies(node, data_deps)
            # keep executor and graph views consistent for later delegating nodes
            executor._optimized = graph
            executor._memo.pop(node, None)

        graph, _ = UnusedBranchRemovalRule().apply(graph, {})
        # The spliced graph is transformer-only: newly adjacent chains
        # (a fit transformer next to its featurization) fuse for the
        # apply/serving path. The optimizer's own fusion batch cannot see
        # them: they exist only after the delegating nodes collapse.
        return FittedPipeline(graph, self.source, self.sink).fused()

    # ------------------------------------------------------------------ gather
    @staticmethod
    def gather(branches: Sequence[Chainable]) -> "Pipeline":
        """Merge parallel branches into one pipeline emitting, per input,
        the list of branch outputs (reference: Pipeline.scala:119-154)."""
        from ..ops.util.gather import GatherTransformer

        graph = Graph()
        graph, source = graph.add_source()
        ends: List[NodeOrSourceId] = []
        for branch in branches:
            bp = branch.to_pipeline()
            combined, source_map, sink_map = graph.add_graph(bp.graph)
            mapped_source = source_map[bp.source]
            combined = combined.replace_dependency(mapped_source, source)
            combined = combined.remove_source(mapped_source)
            mapped_sink = sink_map[bp.sink]
            ends.append(combined.get_sink_dependency(mapped_sink))
            graph = combined.remove_sink(mapped_sink)
        graph, gather_node = graph.add_node(GatherTransformer(), ends)
        graph, sink = graph.add_sink(gather_node)
        return Pipeline(graph, source, sink)

    def to_dot(self) -> str:
        return self.graph.to_dot()


# ------------------------------------------------------------- fitted pipeline


class FittedPipeline(Transformer):
    """Transformer-only pipeline: serializable, no estimators, no re-fitting
    (reference: workflow/FittedPipeline.scala:22-48)."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        self.graph = graph
        self.source = source
        self.sink = sink
        # The datum-bound graph is built once and reused; only the
        # DatumOperator's payload is swapped per call, under a lock, so
        # concurrent calls can't read each other's datum. Safe because
        # per-datum execution runs with optimize=False: a fresh executor
        # per call, no cross-call memo, no prefix write-back.
        self._datum_op: Optional[DatumOperator] = None
        self._datum_graph: Optional[Graph] = None
        self._datum_lock = threading.Lock()
        self._compiled: Optional["CompiledApply"] = None

    def __getstate__(self):
        # save() must not pickle the last served datum, the lock, or the
        # serving handle's bound graph and payload.
        state = self.__dict__.copy()
        state["_datum_op"] = None
        state["_datum_graph"] = None
        state["_datum_lock"] = None
        state["_compiled"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._datum_lock = threading.Lock()
        # Artifacts saved before the serving layer existed lack the slot.
        self._compiled = None

    def apply(self, datum: Any) -> Any:
        with self._datum_lock:
            if self._datum_graph is None:
                self._datum_op = DatumOperator(datum)
                graph, node = self.graph.add_node(self._datum_op, [])
                graph = graph.replace_dependency(self.source, node)
                self._datum_graph = graph.remove_source(self.source)
            else:
                self._datum_op.datum = datum
            executor = GraphExecutor(self._datum_graph, optimize=False)
            return executor.execute(self.sink).get()

    def apply_batch(self, dataset: Dataset) -> Dataset:
        graph, node = self.graph.add_node(DatasetOperator(dataset), [])
        graph = graph.replace_dependency(self.source, node)
        graph = graph.remove_source(self.source)
        executor = GraphExecutor(graph, optimize=False)
        return executor.execute(self.sink).get()

    def fused(self) -> "FittedPipeline":
        """This pipeline with transformer chains collapsed into single
        operators (``workflow/fusion.py``). Returns ``self`` when fusion is
        disabled or nothing fuses; otherwise a NEW pipeline (graph surgery
        never mutates in place). ``Pipeline.fit`` calls this, and the
        serving registry re-fuses artifacts saved unfused."""
        from .fusion import fuse_graph, fusion_enabled

        if not fusion_enabled():
            return self
        graph = fuse_graph(self.graph)
        if graph == self.graph:
            return self
        return FittedPipeline(graph, self.source, self.sink)

    def compiled_apply(self) -> "CompiledApply":
        """The serving-loop batch handle: graph bound once, only the
        dataset payload swapped per call (the batch analog of the datum
        path above). Cached on the pipeline — all servers applying this
        fitted pipeline share one handle."""
        if self._compiled is None:
            self._compiled = CompiledApply(self)
        return self._compiled

    # ---------------------------------------------------------- serialization
    def save(self, path: str) -> None:
        """Write the pipeline with ``torch.save`` (a pickle whose tensor
        storages ``load`` can place on another device)."""
        torch.save(self, path)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "FittedPipeline":
        """Read a pipeline written by :meth:`save`, with every tensor on
        ``device`` (default CUDA; pass ``device="cpu"`` on a machine
        without a card). ``weights_only=False`` because the file holds
        pipeline classes: load only files this program wrote."""
        out = torch.load(path, map_location=resolve_device(device), weights_only=False)
        if not isinstance(out, FittedPipeline):
            raise TypeError(f"{path} does not contain a FittedPipeline")
        return out


class CompiledApply:
    """Reusable batch-apply handle over a :class:`FittedPipeline`.

    ``apply_batch`` rebuilds the dataset-bound graph on every call; a
    serving loop calls apply thousands of times per second, so this
    handle binds the graph ONCE and swaps only the ``DatasetOperator``
    payload per call, under a lock (same contract as the datum path:
    per-call execution runs optimize=False with a fresh executor, so no
    cross-call memo or prefix write-back sees the mutation).

    Shape discipline is the caller's job: feeding batches whose padded
    physical shapes cycle through a small bucket set keeps the per-shape
    device state underneath (cuFFT plans on the card) to that set — see
    serving/batcher.py and utils/aot.warm_buckets.
    """

    def __init__(self, fitted: FittedPipeline):
        self._fitted = fitted
        self._op: Optional[DatasetOperator] = None
        self._graph: Optional[Graph] = None
        self._lock = threading.Lock()
        self.calls = 0
        #: PartitionDecision or None (parallel/partitioner.py).
        self.partition = None
        #: Batches applied shard by shard under ``partition``.
        self.sharded_calls = 0
        self._imbalance_gauge = None

    def __call__(self, dataset: Union[Dataset, Any]) -> Dataset:
        if not isinstance(dataset, Dataset):
            dataset = as_dataset(dataset)
        # One read: an attach may swap the decision concurrently, and the
        # placement and the accounting must see the same one.
        partition = self.partition
        if partition is not None and isinstance(dataset, ArrayDataset):
            physical = dataset.physical_rows
            if physical >= partition.shards and physical % partition.shards == 0:
                return self._apply_sharded(partition, dataset)
        return self._apply(dataset)

    def _apply_sharded(self, partition, dataset: ArrayDataset) -> Dataset:
        """The batch's rows split over the decision's row shards (views on
        the batch's device when the mesh names it), the graph applied to
        each shard's rows in shard order, the outputs concatenated. The
        placement is a pure function of the batch's physical rows, as in
        the JAX package: a bucket always shards or never does."""
        from ..parallel.collectives import axis_representatives
        from ..parallel.partitioner import shard_rows
        from ..utils.tree import tree_leaves

        laid = shard_rows(partition, dataset.data)
        outs = []
        for flat in axis_representatives(partition.mesh, tuple(partition.mesh_axes)):
            piece = tree_map(lambda sh: sh.shards[flat], laid)
            outs.append(self._apply(ArrayDataset(piece)).data)
        device = tree_leaves(outs[0])[0].device
        n = dataset.num_examples

        def merge(*parts):
            # Rows past the logical count read zero, as the unsharded
            # apply's output does.
            out = torch.cat([p.to(device) for p in parts])
            out[n:] = 0
            return out

        merged = tree_map(merge, *outs)
        self.sharded_calls += 1
        if self._imbalance_gauge is None:
            from ..obs import names as _names

            self._imbalance_gauge = _names.metric(_names.PARTITION_IMBALANCE)
        self._imbalance_gauge.set(1.0 - dataset.num_examples / dataset.physical_rows, kind="serve")
        return ArrayDataset(merged, num_examples=dataset.num_examples)

    def _apply(self, dataset: Dataset) -> Dataset:
        fitted = self._fitted
        with self._lock:
            if self._graph is None:
                self._op = DatasetOperator(dataset)
                graph, node = fitted.graph.add_node(self._op, [])
                graph = graph.replace_dependency(fitted.source, node)
                self._graph = graph.remove_source(fitted.source)
            else:
                self._op.dataset = dataset
            self.calls += 1
            executor = GraphExecutor(self._graph, optimize=False)
            return executor.execute(fitted.sink).get()


__all__ = [
    "BatchTransformer",
    "Chainable",
    "CompiledApply",
    "Estimator",
    "FittedPipeline",
    "Identity",
    "LabelEstimator",
    "Pipeline",
    "PipelineDataset",
    "PipelineDatum",
    "PipelineResult",
    "Transformer",
]
