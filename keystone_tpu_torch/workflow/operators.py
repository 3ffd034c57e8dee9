"""Untyped operator algebra + lazy expressions.

Port of ``keystone_tpu/workflow/operators.py``
(reference: workflow/Operator.scala:10-177, workflow/Expression.scala:8-44).

Operators are the graph IR's payloads; they dispatch between per-datum and
whole-dataset execution, and their outputs are call-by-name memoized
``Expression``s, so building a pipeline never launches device work until
someone forces ``.get``.

Equality: operators compare by identity (Python's default), except the two
constant operators, which compare by the identity of what they hold. No
operator defines an ``__eq__`` over tensors — the CSE and prefix rules key
dictionaries on operators, and a tensor-valued ``==`` would raise there.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence

from ..data.dataset import Dataset


_UNSET = object()


class Expression:
    """Call-by-name memoized result.

    ``get`` is thread-safe: the memo is guarded by a per-expression lock,
    so two threads forcing the same expression run the thunk exactly once
    and both observe the one memoized value.
    """

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk: Optional[Callable[[], Any]] = thunk
        self._value: Any = _UNSET
        self._lock = threading.Lock()

    def get(self) -> Any:
        # Double-checked: the unlocked fast path is safe because _value
        # is written exactly once, under the lock, after the thunk ran.
        if self._value is _UNSET:
            with self._lock:
                if self._value is _UNSET:
                    assert self._thunk is not None
                    self._value = self._thunk()
                    self._thunk = None
        return self._value

    def __getstate__(self):
        # Locks don't pickle; a forced expression (thunk already dropped)
        # must stay serializable — SavedStateLoadRule splices expressions
        # into graphs that FittedPipeline.save pickles.
        state = self.__dict__.copy()
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    @classmethod
    def of(cls, value: Any) -> "Expression":
        e = cls(lambda: value)
        e.get()
        return e


class DatasetExpression(Expression):
    """Lazily yields a :class:`~keystone_tpu_torch.data.dataset.Dataset`."""


class DatumExpression(Expression):
    """Lazily yields a single item."""


class TransformerExpression(Expression):
    """Lazily yields a fit :class:`TransformerOperator`."""


def wrap_expression(value: Any) -> "Expression":
    """Wrap an already-computed value, preserving dataset-ness so
    :meth:`TransformerOperator.execute` picks the batch path. Used by the
    sample interpreter in the optimizer layer."""
    if isinstance(value, Dataset):
        return DatasetExpression.of(value)
    return Expression.of(value)


class Operator:
    """Base execution unit stored at graph nodes."""

    @property
    def label(self) -> str:
        return type(self).__name__

    def execute(self, deps: Sequence[Expression]) -> Expression:
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.label


class DatasetOperator(Operator):
    """Zero-dependency constant dataset (a bound pipeline input)."""

    def __init__(self, dataset: Dataset):
        self.dataset = dataset

    @property
    def label(self) -> str:
        return f"Dataset[n={len(self.dataset)}]"

    def execute(self, deps: Sequence[Expression]) -> DatasetExpression:
        assert not deps
        return DatasetExpression.of(self.dataset)

    # Equal when they hold the same dataset object, so two applications
    # of a pipeline to the same data produce equal prefixes (the
    # fit-once-across-applications guarantee).
    def __eq__(self, other: object) -> bool:
        return isinstance(other, DatasetOperator) and other.dataset is self.dataset

    def __hash__(self) -> int:
        return hash((DatasetOperator, id(self.dataset)))


class DatumOperator(Operator):
    """Zero-dependency constant datum."""

    def __init__(self, datum: Any):
        self.datum = datum

    @property
    def label(self) -> str:
        return "Datum"

    def execute(self, deps: Sequence[Expression]) -> DatumExpression:
        assert not deps
        return DatumExpression.of(self.datum)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DatumOperator) and other.datum is self.datum

    def __hash__(self) -> int:
        return hash((DatumOperator, id(self.datum)))


class TransformerOperator(Operator):
    """An operator that maps inputs to outputs datum-by-datum or batchwise.

    Subclasses implement ``single_transform`` (one datum per dependency) and
    ``batch_transform`` (one Dataset per dependency). If any dependency is
    a dataset, the batch path runs (reference: workflow/Operator.scala:60-108).
    """

    def single_transform(self, datums: List[Any]) -> Any:
        raise NotImplementedError

    def batch_transform(self, datasets: List[Dataset]) -> Dataset:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if any(isinstance(d, DatasetExpression) for d in deps):

            def thunk() -> Dataset:
                materialized: List[Dataset] = []
                for d in deps:
                    value = d.get()
                    if not isinstance(value, Dataset):
                        raise TypeError(
                            f"{self.label}: mixed datum/dataset dependencies are not supported "
                            "in batch execution"
                        )
                    materialized.append(value)
                return self.batch_transform(materialized)

            return DatasetExpression(thunk)

        def datum_thunk() -> Any:
            return self.single_transform([d.get() for d in deps])

        return DatumExpression(datum_thunk)


class EstimatorOperator(Operator):
    """Fits datasets into a TransformerOperator (reference: Operator.scala:112-124).

    Estimators that can consume their training data INCREMENTALLY — via
    sufficient statistics (Gram accumulation) rather than a materialized
    feature matrix — advertise ``supports_fit_stream = True`` and
    implement :meth:`fit_stream`; the streaming planner
    (``workflow/streaming.py``) then rewrites eligible
    ``ingest → featurize → fit`` graphs into chunked plans where the full
    feature matrix never exists.
    """

    #: True when :meth:`fit_stream` is implemented (streaming planner gate).
    supports_fit_stream: bool = False

    def fit_datasets(self, datasets: List[Dataset]) -> TransformerOperator:
        raise NotImplementedError

    def fit_stream(self, stream) -> TransformerOperator:
        """Fit from a :class:`~keystone_tpu_torch.workflow.streaming.ChunkStream`
        (see its ``fold`` contract). Only called when
        ``supports_fit_stream`` is True."""
        raise NotImplementedError(f"{self.label} does not support fit_stream")

    def execute(self, deps: Sequence[Expression]) -> TransformerExpression:
        def thunk() -> TransformerOperator:
            datasets = []
            for d in deps:
                value = d.get()
                if not isinstance(value, Dataset):
                    raise TypeError(f"{self.label}: estimator dependencies must be datasets")
                datasets.append(value)
            # A precision pin on the operator (``solver_precision``)
            # applies around THIS fit only — thread-local and restored on
            # exit, so it never leaks into solves not planned under it.
            mode = getattr(self, "solver_precision", None)
            if mode is None:
                return self.fit_datasets(datasets)
            from ..parallel import linalg

            with linalg.solver_mode_scope(mode):
                return self.fit_datasets(datasets)

        return TransformerExpression(thunk)


class DelegatingOperator(Operator):
    """Applies a fit transformer: first dep is the TransformerExpression,
    the rest are its data (reference: Operator.scala:130-160)."""

    def execute(self, deps: Sequence[Expression]) -> Expression:
        transformer_dep, data_deps = deps[0], list(deps[1:])
        if any(isinstance(d, DatasetExpression) for d in data_deps):

            def thunk() -> Dataset:
                transformer: TransformerOperator = transformer_dep.get()
                datasets = [d.get() for d in data_deps]
                return transformer.batch_transform(datasets)

            return DatasetExpression(thunk)

        def datum_thunk() -> Any:
            transformer: TransformerOperator = transformer_dep.get()
            return transformer.single_transform([d.get() for d in data_deps])

        return DatumExpression(datum_thunk)


class ExpressionOperator(Operator):
    """Wraps an already-computed expression — how prefix-state reuse splices
    previous results into a new plan (reference: Operator.scala:166-177)."""

    def __init__(self, expression: Expression):
        self.expression = expression

    @property
    def label(self) -> str:
        return "Expr"

    def execute(self, deps: Sequence[Expression]) -> Expression:
        return self.expression
