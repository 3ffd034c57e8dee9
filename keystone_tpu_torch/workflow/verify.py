"""Plan-time static verification: shapes, dtypes and feasibility before
any data touches the card.

Port of ``keystone_tpu/workflow/verify.py``. An abstract interpreter
propagates specs through the (optimized) graph — a spec leaf is a tensor
on PyTorch's ``meta`` device, which carries a shape and a dtype and no
data, or a :class:`TensorSpec` record that turns into one — and emits
:class:`~keystone_tpu_torch.diagnostics.Diagnostic`\\ s with severities
for the failure classes that otherwise surface deep inside a kernel at
fit time, or as a cold shape in serving:

========  ========  ====================================================
code      severity  meaning
========  ========  ====================================================
KV101     error     shape/dtype mismatch at a node boundary
KV102     warning   silent float64 widening introduced by a node
KV201     info      fusion-ineligible node / chain cut, with the reason
KV202     info      streaming-ineligible estimator fit, with the reason
KV301     error     serving batch bucket not in the warmed bucket set
                    (the steady-state cold-shape hazard)
KV302     warning   estimated peak bytes exceed the device memory budget
KV303     warning   Gram/sufficient-stat state for a streamed fit does
                    not fit the device memory budget
KV305     error     a refit-published candidate's apply spec or bucket
                    set disagrees with the incumbent's warmed buckets
                    (:func:`verify_refit_publish`)
KV306     error     a persisted mid-stream resume entry's fingerprints
                    disagree with the re-planned pipeline
                    (:func:`verify_stream_resume`)
KV307     error     a serving boot image's fingerprints (format, torch
                    and CUDA versions, card and compute capability, the
                    kernel sources' hash, the weights digest) disagree
                    with the loading worker's (:func:`verify_boot_image`)
KV308     error     a streamed fit on the sketched tier is infeasible or
                    meaningless: its O(s·d) state exceeds the device
                    memory budget, or the sketch size is below the
                    conditioning floor
KV401     error     dependency cycle in the graph
KV402     info      node not statically analyzable (no ``out_spec``, or
                    its ``apply_arrays`` cannot run on ``meta``) —
                    propagation continues unknown
========  ========  ====================================================

KV203 (sharding-ineligible fit) and KV304 (sharded per-device residency)
come from the partitioner's own decisions (``parallel/partitioner.py``),
re-derived for every fit without touching the last plan's report; each
decision rides ``VerifyReport.partition`` (``check --pipeline --json``),
and with ``buckets`` the serving decision too. KV304 reads per-shard
residency as the JAX package does — the row slice (twice, for the
working copy) plus the statistics, blocked over ``model`` in a 2-D plan —
and multiplies it by the shards the plan maps onto one card (a mesh may
name one card several times) before comparing it with the card's
budget.

The ``out_spec`` protocol
-------------------------

Operators may define ``out_spec(in_specs)`` where ``in_specs`` is one
abstract value per graph dependency: a tree of spec leaves for data
edges, a :class:`TransformerSpec` for a fitted-transformer edge. An
estimator returns the :class:`TransformerSpec` of the transformer it will
fit. Raise :class:`SpecMismatch` for inputs the operator can never
accept; return :data:`UNKNOWN` where the answer is data-dependent.

Operators without ``out_spec`` still verify when they are fusable
``BatchTransformer``\\ s: the verifier runs their ``apply_arrays`` on
``meta`` tensors (:func:`_meta_apply`, in place of ``jax.eval_shape``),
with every tensor the operator holds replaced by its ``meta`` twin. The
torch ops they run are answered by the shape rules of
``workflow/shape_rules.py`` where one exists, so that a verification in
a fresh process does not pay the import of torch's Python ``meta``
kernels (sympy, the dynamo decorators: seconds per process). The
port's own wrappers (the cuBLAS binding in ``ops/cuda/gemm.py``, the ELL
kernel in ``ops/cuda/blocksparse.py``) take ``meta`` operands as a shape
rule: they check them as the card path does and launch nothing. Only a
shape or dtype rejection is KV101 — ``SpecMismatch``, a wrapper's
``ValueError`` or ``DtypeMismatch``, an ``IndexError``, or torch's own
size or dtype ``RuntimeError``. A step that cannot run on ``meta`` (an op
without a meta kernel, a data-dependent ``.item()`` or ``nonzero``, a
host numpy step) is KV402: the plan is not refused for what the verifier
cannot see.

Entry points: :func:`verify_graph` / :func:`verify_pipeline` (the
``check --pipeline`` engine) and :func:`verify_and_enforce` — called from
``Pipeline.fit()`` and ``ModelRegistry.load_fitted``, warn by default,
``KEYSTONE_VERIFY=strict`` to raise :class:`VerificationError`,
``KEYSTONE_VERIFY=off`` to skip. Verification reads tensors' metadata
only: it launches no kernel, calls no binding and allocates nothing on
the card.
"""

from __future__ import annotations

import copy
import logging
import re
import time
import types
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diagnostics import ERROR, INFO, WARNING, Diagnostic
from ..envknobs import env_int, env_str
from ..obs import names as _names
from ..utils.tree import tree_leaves, tree_map
from .analysis import GraphCycleError, linearize_whole
from .graph import Graph, NodeId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    Operator,
    TransformerOperator,
)

logger = logging.getLogger(__name__)

#: code → (default severity, short title), the JAX package's table.
CODES: Dict[str, Tuple[str, str]] = {
    "KV101": (ERROR, "shape/dtype mismatch at node boundary"),
    "KV102": (WARNING, "silent float64 widening"),
    "KV201": (INFO, "fusion-ineligible node"),
    "KV202": (INFO, "streaming-ineligible fit"),
    "KV203": (INFO, "sharding-ineligible fit"),
    "KV301": (ERROR, "serving bucket not warmed"),
    "KV302": (WARNING, "estimated peak memory exceeds budget"),
    "KV303": (WARNING, "streamed-fit Gram state exceeds memory budget"),
    "KV304": (ERROR, "sharded per-device residency exceeds memory budget"),
    "KV305": (ERROR, "refit candidate disagrees with incumbent warm state"),
    "KV306": (ERROR, "stale stream-resume entry refused"),
    "KV307": (ERROR, "stale boot image refused"),
    "KV308": (ERROR, "sketched-fit state infeasible or bound too weak"),
    "KV401": (ERROR, "dependency cycle"),
    "KV402": (INFO, "node not statically analyzable"),
}


class _Unknown:
    """Singleton abstract value: statically unknowable, propagates."""

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "UNKNOWN"


UNKNOWN = _Unknown()


class SpecMismatch(Exception):
    """Raised by ``out_spec``/``apply_spec`` when an input spec is one
    the operator can never accept (wrong rank, wrong width, row-count
    disagreement). Becomes a KV101 error diagnostic."""


@dataclass
class NodeAnnotation:
    """Per-node result of spec propagation: what the verifier believes
    flows out of this node, and roughly how many bytes it holds."""

    node: str
    label: str
    spec: str
    est_bytes: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        return {"node": self.node, "label": self.label, "spec": self.spec, "est_bytes": self.est_bytes}


@dataclass
class VerifyReport:
    diagnostics: List[Diagnostic] = field(default_factory=list)
    annotations: List[NodeAnnotation] = field(default_factory=list)
    seconds: float = 0.0
    context: str = ""
    #: The partitioner's per-fit decisions (mesh shape, row and model
    #: shards, spec, reason), as ``PartitionDecision.to_json``.
    partition: List[Dict[str, Any]] = field(default_factory=list)

    def diag(self, code: str, message: str, node: Any = None, **details: Any) -> None:
        severity, _title = CODES[code]
        self.diagnostics.append(
            Diagnostic(
                code=code,
                severity=severity,
                message=message,
                node=None if node is None else repr(node),
                details=details,
            )
        )

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def to_json(self) -> Dict[str, Any]:
        out = {
            "context": self.context,
            "ok": self.ok,
            "seconds": round(self.seconds, 4),
            "diagnostics": [d.to_json() for d in self.diagnostics],
            "nodes": [a.to_json() for a in self.annotations],
        }
        if self.partition:
            out["partition"] = self.partition
        return out

    def render(self) -> str:
        lines = [
            f"verify[{self.context}]: {len(self.annotations)} nodes, "
            f"{len(self.errors())} errors, {len(self.warnings())} warnings, "
            f"{len(self.diagnostics)} diagnostics, {self.seconds * 1e3:.1f} ms"
        ]
        lines += [d.render() for d in self.diagnostics]
        return "\n".join(lines)


class VerificationError(RuntimeError):
    """Strict-mode failure: verification found errors."""

    def __init__(self, report: VerifyReport):
        self.report = report
        errors = "; ".join(d.render() for d in report.errors())
        super().__init__(
            f"plan-time verification failed ({report.context}): {errors} "
            "— set KEYSTONE_VERIFY=warn to downgrade"
        )


# ------------------------------------------------------------ abstract values


@dataclass(frozen=True)
class TensorSpec:
    """A shape and a dtype: the record form of a spec leaf.
    :meth:`meta` turns it into the ``meta`` tensor the interpreter
    propagates; ``dtype`` may be a ``torch.dtype``, a numpy dtype or its
    name."""

    shape: Tuple[int, ...]
    dtype: Any = torch.float32

    def meta(self) -> torch.Tensor:
        return torch.empty(tuple(int(d) for d in self.shape), dtype=torch_dtype(self.dtype), device="meta")


def torch_dtype(dtype: Any) -> torch.dtype:
    """``dtype`` (a ``torch.dtype``, a numpy dtype or a name such as
    ``"float32"``) as a ``torch.dtype``; ``TypeError`` for one torch has
    no tensors of (strings, objects)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def dtype_name(dtype: Any) -> str:
    """A dtype's numpy name (``float32``, ``int32``, ``bool``), the
    rendering the JAX package's reports use."""
    return str(dtype).replace("torch.", "")


def spec_leaf(shape: Sequence[int], dtype: Any = torch.float32) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``: one spec leaf."""
    return TensorSpec(tuple(shape), dtype).meta()


def _is_leaf(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _as_meta(leaf: Any) -> Any:
    """A spec leaf as a ``meta`` tensor (metadata only: a tensor on any
    other device gives an empty twin, never a copy of its data)."""
    if isinstance(leaf, torch.Tensor):
        return leaf if leaf.device.type == "meta" else spec_leaf(tuple(leaf.shape), leaf.dtype)
    if isinstance(leaf, TensorSpec):
        return leaf.meta()
    if _is_leaf(leaf):
        return spec_leaf(tuple(leaf.shape), leaf.dtype)
    return leaf


def as_spec(tree: Any) -> Any:
    """Every leaf of ``tree`` that has a shape and a dtype as a ``meta``
    tensor (:class:`TensorSpec` records, tensors on any device, numpy
    arrays); other values are kept."""
    if tree is UNKNOWN or tree is None or isinstance(tree, TransformerSpec):
        return tree
    return tree_map(_as_meta, tree)


class TransformerSpec:
    """Abstract value of a fitted-transformer edge (an estimator node's
    output): maps apply-time input specs to output specs.

    ``fn(data_spec) -> out_spec`` may raise :class:`SpecMismatch`; pass
    ``fn=None`` for a fitted transformer whose apply shape is
    data-dependent (the verifier then propagates :data:`UNKNOWN`).
    """

    def __init__(self, fn: Optional[Callable[[Any], Any]] = None, label: str = ""):
        self._fn = fn
        self.label = label

    def apply_spec(self, data_spec: Any) -> Any:
        if self._fn is None:
            return UNKNOWN
        return self._fn(data_spec)

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return f"TransformerSpec[{self.label or 'unknown'}]"


def _leaves(spec: Any) -> List[Any]:
    """The shape-and-dtype leaves of an abstract value (empty for
    UNKNOWN / TransformerSpec)."""
    if spec is UNKNOWN or spec is None or isinstance(spec, TransformerSpec):
        return []
    return [leaf for leaf in tree_leaves(spec) if _is_leaf(leaf)]


def spec_bytes(spec: Any) -> Optional[int]:
    """Estimated bytes of an abstract value (None when unknown)."""
    leaves = _leaves(spec)
    if not leaves:
        return None
    total = 0
    for leaf in leaves:
        size = 1
        for dim in leaf.shape:
            size *= int(dim)
        total += size * torch_dtype(leaf.dtype).itemsize
    return total


def _render_spec(spec: Any) -> str:
    if spec is UNKNOWN:
        return "unknown"
    if isinstance(spec, TransformerSpec):
        return repr(spec)
    leaves = _leaves(spec)
    if not leaves:
        return "unknown"
    return ", ".join(f"{tuple(int(d) for d in leaf.shape)}:{dtype_name(leaf.dtype)}" for leaf in leaves)


def _single_matrix(spec: Any) -> Optional[Any]:
    """The single array leaf of a spec, or None when the spec is unknown
    or not a single array."""
    leaves = _leaves(spec)
    if len(leaves) != 1:
        return None
    return leaves[0]


def _rows(spec: Any) -> Optional[int]:
    leaf = _single_matrix(spec)
    if leaf is None or not leaf.shape:
        return None
    return int(leaf.shape[0])


def _width(spec: Any) -> Optional[int]:
    leaf = _single_matrix(spec)
    if leaf is None or len(leaf.shape) < 2:
        return None
    return int(leaf.shape[-1])


def _is_f64(dtype: Any) -> bool:
    try:
        return torch_dtype(dtype) == torch.float64
    except TypeError:
        return False


def _result_dtype(*specs: Any) -> torch.dtype:
    """float64 if any input leaf (or bare dtype argument) is float64,
    else float32 — the dtype discipline of the solver layer (everything
    is cast to f32 unless the caller explicitly trafficks in f64)."""
    for spec in specs:
        if isinstance(spec, (torch.dtype, np.dtype)):
            if _is_f64(spec):
                return torch.float64
            continue
        for leaf in _leaves(spec):
            if _is_f64(leaf.dtype):
                return torch.float64
    return torch.float32


# ------------------------------------------------- out_spec helpers (for ops)


def dense_fit_spec(
    in_specs: Sequence[Any],
    label: str,
    out_width: Optional[int] = None,
) -> TransformerSpec:
    """Shared ``out_spec`` for estimators that fit a row-matrix into a
    dense map ``(m, d) -> (m, k)``.

    ``in_specs[0]`` is the feature spec (n, d); ``in_specs[1]`` (when
    present) the labels. ``out_width`` fixes k (num_classes, dims);
    ``None`` takes k from the labels' width (1 for rank-1 labels).
    Validates what is statically knowable — feature rank, train-time row
    agreement between features and labels, apply-time width agreement —
    and leaves the rest unknown.
    """
    x = _single_matrix(in_specs[0]) if in_specs else None
    y_spec = in_specs[1] if len(in_specs) > 1 else None
    d = None
    dtype = _result_dtype(*in_specs)
    if x is not None:
        if len(x.shape) != 2:
            raise SpecMismatch(
                f"{label}: features must be a rank-2 (rows, features) "
                f"matrix, got shape {tuple(x.shape)}"
            )
        d = int(x.shape[1])
        n = int(x.shape[0])
        y = _single_matrix(y_spec) if y_spec is not None else None
        if y is not None and y.shape and int(y.shape[0]) != n:
            raise SpecMismatch(f"{label}: features have {n} rows but labels have {int(y.shape[0])} rows")
    k = out_width
    if k is None and y_spec is not None:
        y = _single_matrix(y_spec)
        if y is not None:
            k = int(y.shape[1]) if len(y.shape) >= 2 else 1

    def apply_fn(data_spec: Any) -> Any:
        leaf = _single_matrix(data_spec)
        if leaf is None:
            return UNKNOWN
        if len(leaf.shape) < 2:
            raise SpecMismatch(f"{label}: fitted map expects rank-2 input, got shape {tuple(leaf.shape)}")
        if d is not None and int(leaf.shape[-1]) != d:
            raise SpecMismatch(
                f"{label}: fitted on {d}-wide features but applied to {int(leaf.shape[-1])}-wide input"
            )
        if k is None:
            return UNKNOWN
        return spec_leaf(tuple(leaf.shape[:-1]) + (k,), _result_dtype(data_spec, dtype))

    return TransformerSpec(apply_fn, label=f"{label}(d={d},k={k})")


def projection_fit_spec(in_specs: Sequence[Any], label: str, dims: int) -> TransformerSpec:
    """``out_spec`` for projection estimators (PCA families): the fitted
    transformer replaces the LAST axis (descriptor width d) with
    ``dims``, preserving leading axes — covers both flat (m, d) rows and
    (m, cols, d) descriptor stacks."""
    x = _single_matrix(in_specs[0]) if in_specs else None
    d = int(x.shape[-1]) if x is not None and len(x.shape) >= 2 else None

    def apply_fn(data_spec: Any) -> Any:
        leaf = _single_matrix(data_spec)
        if leaf is None:
            return UNKNOWN
        if len(leaf.shape) < 2:
            raise SpecMismatch(f"{label}: projection expects rank>=2 input, got shape {tuple(leaf.shape)}")
        if d is not None and int(leaf.shape[-1]) != d:
            raise SpecMismatch(
                f"{label}: fitted on {d}-wide descriptors but applied to {int(leaf.shape[-1])}-wide input"
            )
        return spec_leaf(tuple(leaf.shape[:-1]) + (int(dims),), _result_dtype(data_spec))

    return TransformerSpec(apply_fn, label=f"{label}(d={d},dims={dims})")


def elementwise_fit_spec(in_specs: Sequence[Any], label: str) -> TransformerSpec:
    """``out_spec`` for estimators whose fitted transformer preserves the
    input spec exactly (scalers, whiteners): shape and dtype pass
    through, width checked against the training width when both are
    known."""
    x = _single_matrix(in_specs[0]) if in_specs else None
    d = int(x.shape[-1]) if x is not None and len(x.shape) >= 2 else None

    def apply_fn(data_spec: Any) -> Any:
        leaf = _single_matrix(data_spec)
        if leaf is None:
            return UNKNOWN
        if d is not None and len(leaf.shape) >= 2 and int(leaf.shape[-1]) != d:
            raise SpecMismatch(f"{label}: fitted on {d}-wide input but applied to {int(leaf.shape[-1])}-wide input")
        return data_spec

    return TransformerSpec(apply_fn, label=f"{label}(d={d})")


# ------------------------------------------------------------- the meta tracer


class NotAnalyzable(Exception):
    """A step the ``meta`` tracer cannot follow (its result left the
    ``meta`` device, or is not a tensor tree): KV402, never KV101."""


#: torch's own wording for a shape or dtype rejection. A message that
#: names the ``meta`` device is a step the tracer could not run (a
#: device mix, a data-dependent read), never a mismatch.
_SHAPE_ERROR = re.compile(
    r"size|shape|dimension|broadcast|reduction dim|mat[12]|dtype|scalar type|"
    r"rank|must match|same number|expected .* dims?",
    re.IGNORECASE,
)


def is_shape_error(exc: BaseException) -> bool:
    """True when ``exc`` is a shape or dtype rejection (KV101): a
    :class:`SpecMismatch`, a wrapper's ``ValueError`` or
    ``DtypeMismatch``, an ``IndexError`` (a dimension out of range), or
    torch's size or dtype ``RuntimeError``. Anything else that stops a
    ``meta`` trace — ``NotImplementedError`` for an op without a meta
    kernel, ``.item()`` / ``nonzero`` on data that is not there, a numpy
    or ctypes step — is KV402."""
    from ..ops.cuda._build import DtypeMismatch

    if isinstance(exc, SpecMismatch):
        return True
    if isinstance(exc, (NotImplementedError, NotAnalyzable)):
        return False
    message = str(exc)
    if "meta" in message:
        return False
    if isinstance(exc, (ValueError, IndexError, DtypeMismatch)):
        return True
    return isinstance(exc, RuntimeError) and bool(_SHAPE_ERROR.search(message))


def _meta_twin(obj: Any, memo: Dict[int, Any]) -> Any:
    """``obj`` with every tensor it holds — in attributes, lists, tuples
    and dicts, through the port's own objects — replaced by an empty
    ``meta`` tensor of the same shape, dtype and strides, and every
    ``torch.device`` by ``meta``. Objects that hold no tensor are shared,
    not copied; the original is never mutated."""
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, torch.Tensor):
        out = obj if obj.device.type == "meta" or obj.layout != torch.strided else _strided_meta(obj)
    elif isinstance(obj, torch.device):
        out = torch.device("meta")
    elif isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        memo[key] = obj
        items = [_meta_twin(x, memo) for x in obj]
        out = obj if all(a is b for a, b in zip(items, obj)) else type(obj)(items)
    elif isinstance(obj, dict):
        memo[key] = obj
        items = {k: _meta_twin(v, memo) for k, v in obj.items()}
        out = obj if all(items[k] is v for k, v in obj.items()) else type(obj)(items)
    elif _is_port_object(obj):
        twin = copy.copy(obj)
        memo[key] = twin
        changed = False
        for name, value in vars(obj).items():
            new = _meta_twin(value, memo)
            if new is not value:
                changed = True
                twin.__dict__[name] = new
        out = twin if changed else obj
    else:
        out = obj
    memo[key] = out
    return out


def _strided_meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()), dtype=t.dtype, device="meta")


def _is_port_object(obj: Any) -> bool:
    """An operator (the port's or a user's subclass), or an instance of
    one of the port's own classes (mappers, their helpers), with an
    instance ``__dict__`` — what the meta twin walks into. Modules,
    classes, functions and foreign objects (locks, generators, numpy
    arrays) are shared as they are."""
    if isinstance(obj, (type, types.ModuleType, types.FunctionType, types.MethodType)):
        return False
    if not hasattr(obj, "__dict__"):
        return False
    module = getattr(type(obj), "__module__", "") or ""
    return isinstance(obj, Operator) or module.startswith("keystone_tpu_torch")


def _check_meta_out(out: Any) -> Any:
    leaves = tree_leaves(out)
    if not leaves or not all(isinstance(a, torch.Tensor) and a.device.type == "meta" for a in leaves):
        raise NotAnalyzable(f"apply_arrays left the meta device ({type(out).__name__})")
    return out


def _meta_apply(op: Any, in_spec: Any) -> Any:
    """``op.apply_arrays`` run on ``meta`` leaves — the port's
    ``jax.eval_shape`` — honoring the masked-descriptor dict convention
    (``{"desc": ..., "valid": ...}``) the batch path uses. The operator
    runs as its meta twin (:func:`_meta_twin`); a fused chain runs member
    by member, so the chain's first-application counter
    (``keystone_fusion_compiles_total``) never sees a verification."""
    from .fusion import FusedTransformerOperator

    twin = _meta_twin(op, {})
    steps = twin.members if isinstance(twin, FusedTransformerOperator) else (twin,)

    def run(x):
        with torch.no_grad():
            for step in steps:
                x = step.apply_arrays(x)
        return _check_meta_out(x)

    spec = as_spec(in_spec)
    if isinstance(spec, dict) and "desc" in spec and "valid" in spec:
        return {"desc": run(spec["desc"]), "valid": spec["valid"]}
    return run(spec)


def _exc_text(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e)[:300]}"


# ------------------------------------------------------------ the interpreter


def _dataset_spec(dataset: Any, probe_objects: bool) -> Any:
    """Spec of a bound dataset — shapes and dtypes read off tensor
    metadata, never moving data. ObjectDatasets decode one item to learn
    the per-item shape only when ``probe_objects`` (the CLI path; the
    fit-hook path stays zero-cost)."""
    from ..data.dataset import ArrayDataset, ObjectDataset

    if isinstance(dataset, ArrayDataset):
        return as_spec(dataset.data)
    if isinstance(dataset, ObjectDataset) and probe_objects and len(dataset):
        first = dataset.take(1)[0]
        n = len(dataset)

        def leaf(item):
            if isinstance(item, torch.Tensor):
                return spec_leaf((n,) + tuple(item.shape), item.dtype)
            arr = np.asarray(item)
            return spec_leaf((n,) + arr.shape, arr.dtype)

        try:
            return tree_map(leaf, first)
        except TypeError:  # items torch has no dtype for (text, objects)
            return UNKNOWN
    return UNKNOWN


def _datum_spec(datum: Any) -> Any:
    if _is_leaf(datum):
        try:
            return _as_meta(datum)
        except TypeError:
            return UNKNOWN
    return UNKNOWN


class _Interpreter:
    def __init__(self, report: VerifyReport, probe_objects: bool):
        self.report = report
        self.probe_objects = probe_objects
        self.specs: Dict[Any, Any] = {}

    def diag(self, code: str, message: str, node=None, **details) -> None:
        self.report.diag(code, message, node=node, **details)

    # ---------------------------------------------------------------- nodes
    def node_out_spec(self, node: NodeId, op: Operator, in_specs: List[Any]) -> Any:
        from ..ops.util.misc import CacherOperator
        from .fusion import FusedTransformerOperator, is_fusable
        from .pipeline import Identity
        from .streaming import StreamingFitOperator

        label = str(getattr(op, "label", type(op).__name__))

        # Explicit protocol wins — it can see what tracing can't (what a
        # fit will produce).
        out_spec = getattr(op, "out_spec", None)
        if callable(out_spec):
            try:
                return as_spec(out_spec(in_specs))
            except SpecMismatch as e:
                self.diag("KV101", str(e), node=node, op=label)
                return UNKNOWN
            except Exception as e:  # a broken out_spec must not kill planning
                self.diag(
                    "KV402", f"{label}: out_spec failed ({type(e).__name__}: {e})", node=node, op=label
                )
                return UNKNOWN

        if isinstance(op, DatasetOperator):
            return _dataset_spec(op.dataset, self.probe_objects)
        if isinstance(op, DatumOperator):
            return _datum_spec(op.datum)
        if isinstance(op, ExpressionOperator):
            # A spliced already-computed expression: if it has been
            # forced, read the value's metadata; otherwise unknown.
            value = getattr(op.expression, "_value", None)
            if value is not None and hasattr(value, "data"):
                return _dataset_spec(value, self.probe_objects)
            return UNKNOWN
        if isinstance(op, (CacherOperator, Identity)):
            return in_specs[0] if in_specs else UNKNOWN

        if isinstance(op, DelegatingOperator):
            transformer = in_specs[0] if in_specs else UNKNOWN
            data = in_specs[1] if len(in_specs) > 1 else UNKNOWN
            if isinstance(transformer, TransformerSpec):
                try:
                    return as_spec(transformer.apply_spec(data))
                except SpecMismatch as e:
                    self.diag("KV101", str(e), node=node, op=label)
                    return UNKNOWN
            return UNKNOWN

        if isinstance(op, StreamingFitOperator):
            return self._streaming_fit_spec(node, op, in_specs)

        if isinstance(op, EstimatorOperator):
            self.diag(
                "KV402",
                f"{label}: estimator has no out_spec — fitted-transformer shape unknown at plan time",
                node=node,
                op=label,
            )
            return TransformerSpec(None, label=label)

        if isinstance(op, FusedTransformerOperator) or (isinstance(op, TransformerOperator) and is_fusable(op)):
            in_spec = in_specs[0] if in_specs else UNKNOWN
            if not _leaves(in_spec):
                return UNKNOWN
            try:
                return _meta_apply(op, in_spec)
            except Exception as e:
                if is_shape_error(e):
                    self.diag(
                        "KV101",
                        f"{label}: apply_arrays rejects input {_render_spec(in_spec)} ({_exc_text(e)})",
                        node=node,
                        op=label,
                    )
                else:
                    self.diag(
                        "KV402",
                        f"{label}: apply_arrays does not run on the meta device ({_exc_text(e)})",
                        node=node,
                        op=label,
                    )
                return UNKNOWN

        self.diag(
            "KV402",
            f"{label}: no out_spec and not a meta-traceable apply_arrays transformer",
            node=node,
            op=label,
        )
        return UNKNOWN

    def _streaming_fit_spec(self, node: NodeId, op: Any, in_specs: List[Any]) -> Any:
        """A StreamingFitOperator: featurized spec = chain over the raw
        data spec (cast to float first, like the real chunk step); the
        wrapped estimator's out_spec (when present) then gives the
        fitted-transformer edge. Also records the featurized width for
        the Gram-feasibility check."""
        from .streaming import _cast_tree

        label = str(getattr(op, "label", type(op).__name__))
        data_spec = in_specs[0] if in_specs else UNKNOWN
        feat_spec = data_spec
        if _leaves(data_spec) and op.members:
            try:
                x = _cast_tree(as_spec(data_spec))
                memo: Dict[int, Any] = {}
                with torch.no_grad():
                    for m in op.members:
                        x = _meta_twin(m, memo).apply_arrays(x)
                feat_spec = _check_meta_out(x)
            except Exception as e:
                code = "KV101" if is_shape_error(e) else "KV402"
                self.diag(
                    code,
                    f"{label}: featurize chain "
                    + ("rejects input" if code == "KV101" else "does not run on the meta device for")
                    + f" {_render_spec(data_spec)} ({_exc_text(e)})",
                    node=node,
                    op=label,
                )
                feat_spec = UNKNOWN
        self.specs[("feat", node)] = feat_spec  # side-channel for gram check
        est_out_spec = getattr(op.estimator, "out_spec", None)
        if callable(est_out_spec):
            try:
                return as_spec(est_out_spec([feat_spec] + list(in_specs[1:])))
            except SpecMismatch as e:
                self.diag("KV101", str(e), node=node, op=label)
                return UNKNOWN
            except Exception as e:
                self.diag(
                    "KV402", f"{label}: estimator out_spec failed ({type(e).__name__}: {e})", node=node, op=label
                )
                return UNKNOWN
        return TransformerSpec(None, label=label)


# ----------------------------------------------------------- eligibility scan


def _fusion_diagnostics(graph: Graph, interp: _Interpreter) -> None:
    """Why is each transformer not (or no longer) fusable? Mirrors the
    NodeFusionRule gates so the reasons are the rule's reasons."""
    from ..ops.util.misc import CacherOperator
    from .fusion import FusedTransformerOperator, _overrides, is_fusable
    from .pipeline import BatchTransformer

    dependents = graph.dependents()
    for node in sorted(graph.nodes):
        op = graph.get_operator(node)
        label = str(getattr(op, "label", type(op).__name__))
        if isinstance(op, FusedTransformerOperator):
            continue
        if isinstance(op, CacherOperator):
            interp.diag(
                "KV201",
                f"{label}: Cacher boundary — chains never fuse across a cache materialization point",
                node=node,
                reason="cacher-boundary",
            )
            continue
        if not isinstance(op, BatchTransformer):
            continue
        if is_fusable(op):
            consumers = dependents.get(node, [])
            node_consumers = [c for c in consumers if isinstance(c, NodeId)]
            if len(consumers) > 1 and node_consumers:
                interp.diag(
                    "KV201",
                    f"{label}: multi-consumer interior — {len(consumers)} consumers need this value "
                    "host-side, so a fused chain is cut here",
                    node=node,
                    reason="multi-consumer",
                )
            continue
        if not getattr(op, "fusable", True):
            reason = "opted out (fusable=False — op manages its own dispatch)"
            key = "opt-out"
        elif not _overrides(op, "apply_arrays"):
            reason = "does not implement apply_arrays"
            key = "no-apply-arrays"
        else:
            reason = "bespoke apply/apply_batch override — whole-batch semantics are not its apply_arrays"
            key = "bespoke-apply"
        interp.diag("KV201", f"{label}: not fusable — {reason}", node=node, reason=key)


def _streaming_diagnostics(graph: Graph, interp: _Interpreter, memory_limit: Optional[int]) -> None:
    from .streaming import StreamingFitOperator, stream_chunk_rows, stream_min_rows

    floor = max(2 * stream_chunk_rows(), stream_min_rows())
    for node in sorted(graph.nodes):
        op = graph.get_operator(node)
        label = str(getattr(op, "label", type(op).__name__))
        if isinstance(op, StreamingFitOperator):
            if _plan_state_kind(interp, node, op) == "sketch":
                _sketch_feasibility(graph, interp, node, op, memory_limit)
            else:
                _gram_feasibility(graph, interp, node, op, memory_limit)
            continue
        if not isinstance(op, EstimatorOperator):
            continue
        if not getattr(op, "supports_fit_stream", False):
            interp.diag(
                "KV202",
                f"{label}: estimator does not implement fit_stream — fit materializes the full feature matrix",
                node=node,
                reason="no-fit-stream",
            )
            continue
        # Supports streaming but was not rewritten: explain with the
        # planner's own gates.
        deps = graph.get_dependencies(node)
        head = deps[0] if deps else None
        reason, key = "no chunkable bound dataset upstream", "no-bound-data"
        if isinstance(head, NodeId):
            head_op = graph.get_operator(head)
            if isinstance(head_op, DatasetOperator):
                try:
                    n = len(head_op.dataset)
                except Exception:
                    n = -1
                if 0 <= n < floor:
                    reason = (
                        f"dataset holds {n} rows, below the streaming floor "
                        f"{floor} (max(2*chunk_rows, KEYSTONE_STREAM_MIN_ROWS))"
                    )
                    key = "below-row-floor"
        interp.diag(
            "KV202",
            f"{label}: fit_stream-capable but not planned onto the streaming engine — {reason}",
            node=node,
            reason=key,
        )


def _gram_feasibility(
    graph: Graph, interp: _Interpreter, node: NodeId, op: Any, memory_limit: Optional[int]
) -> None:
    """O(d²) sufficient statistics must fit next to two chunk buffers —
    the whole point of the streamed fit is bounded residency, so an
    infeasible Gram should be caught at plan time, not as an OOM ten
    minutes into ingest."""
    if memory_limit is None:
        return
    feat_spec = interp.specs.get(("feat", node))
    d = _width(feat_spec) if feat_spec is not None else None
    if d is None:
        return
    label = str(getattr(op, "label", type(op).__name__))
    # carry (gram d², cross d·k, sums) + the update's transient
    # double-residency: 2× is the engine's working-set model.
    k = 1
    deps = graph.get_dependencies(node)
    if len(deps) > 1:
        k = _width(interp.specs.get(deps[1])) or 1
    gram_bytes = 2 * 4 * (d * d + d * k + d + k)
    if gram_bytes > memory_limit:
        interp.diag(
            "KV303",
            f"{label}: streamed fit needs ~{gram_bytes / 1e9:.2f} GB of Gram state (d={d}, k={k}) but the "
            f"device memory budget is {memory_limit / 1e9:.2f} GB — use the sketched/rematerialized tier instead",
            node=node,
            d=d,
            k=k,
            gram_bytes=gram_bytes,
            memory_limit=memory_limit,
        )


def _plan_state_kind(interp: _Interpreter, node: NodeId, op: Any) -> str:
    """Which stream-state kind this fit will produce at plan time —
    mirrors the solver ladder's width-based dispatch so the feasibility
    check inspects the rung that will actually run."""
    from ..refit.state import SketchStreamStateMixin

    est = getattr(op, "estimator", None)
    if isinstance(est, SketchStreamStateMixin):
        return "sketch"
    feat_spec = interp.specs.get(("feat", node))
    d = _width(feat_spec) if feat_spec is not None else None
    solver_for = getattr(est, "_stream_solver", None)
    if callable(solver_for) and d is not None:
        try:
            return str(getattr(solver_for(d), "stream_state_kind", "gram"))
        except Exception:
            return "gram"
    return "gram"


def _sketch_feasibility(
    graph: Graph, interp: _Interpreter, node: NodeId, op: Any, memory_limit: Optional[int]
) -> None:
    """The sketched tier is the LAST memory rung — below it there is
    nothing to degrade to, so an O(s·d) state that still misses the
    budget, or a sketch size too small for its error bound to mean
    anything (s below the dual-solve / label-width floor), is a plan
    error (KV308), not a warning like the Gram tier's KV303."""
    from ..sketch.core import sketch_state_bytes
    from ..sketch.solvers import default_sketch_size

    feat_spec = interp.specs.get(("feat", node))
    d = _width(feat_spec) if feat_spec is not None else None
    if d is None:
        return
    label = str(getattr(op, "label", type(op).__name__))
    k = 1
    deps = graph.get_dependencies(node)
    if len(deps) > 1:
        k = _width(interp.specs.get(deps[1])) or 1
    est = getattr(op, "estimator", None)
    s = env_int("KEYSTONE_SKETCH_SIZE", 0) or int(getattr(est, "sketch_size", 0) or 0) or default_sketch_size(d)
    # Conditioning / bound heuristic: the finish is a dual s×s ridge
    # whose solution spans at most s directions — with s below a small
    # multiple of the label width (or a hard floor) the sketched
    # objective's error bound is vacuous. Checked even without a memory
    # budget: a bad sketch size is wrong on any device.
    floor = max(32, 4 * (k + 1))
    if s < floor:
        interp.diag(
            "KV308",
            f"{label}: sketch size s={s} is below the conditioning floor {floor} (max(32, 4*(k+1)) with k={k}) "
            "— the dual ridge finish spans too few directions for the sketch-and-solve error bound to hold; "
            "raise KEYSTONE_SKETCH_SIZE",
            node=node,
            d=d,
            k=k,
            sketch_size=s,
            floor=floor,
        )
        return
    if memory_limit is None:
        return
    # carry (SA s·d, SY s·k, s1, sums) + the update's transient
    # double-residency: same 2× working-set model as the Gram check.
    state_bytes = 2 * sketch_state_bytes(s, d, k)
    if state_bytes > memory_limit:
        interp.diag(
            "KV308",
            f"{label}: even the sketched tier needs ~{state_bytes / 1e9:.2f} GB of state (s={s}, d={d}, k={k}) "
            f"against a {memory_limit / 1e9:.2f} GB budget — no lower-memory rung exists; shrink "
            "KEYSTONE_SKETCH_SIZE or the feature width",
            node=node,
            d=d,
            k=k,
            sketch_size=s,
            state_bytes=state_bytes,
            memory_limit=memory_limit,
        )


# ------------------------------------------------------------------ memory


def _partition_diagnostics(
    graph: Graph, interp: "_Interpreter", memory_limit: Optional[int], report: VerifyReport
) -> None:
    """The partitioner's view of every fit in the plan, re-derived with
    ``record=False`` (the last plan's report and metrics stay untouched):
    KV203 explains a fit that is not partition-managed with the
    partitioner's reason key; KV304 errors when an ELIGIBLE sharded plan
    still cannot hold its shards' slices next to their statistics on one
    card — sharding divides the rows, not the Gram."""
    from ..parallel.partitioner import Partitioner
    from .streaming import StreamingFitOperator, stream_chunk_rows

    part = Partitioner()
    for node in sorted(graph.nodes):
        op = graph.get_operator(node)
        if not isinstance(op, EstimatorOperator):
            continue
        label = str(getattr(op, "label", type(op).__name__))
        deps = graph.get_dependencies(node)
        in_spec = interp.specs.get(deps[0], UNKNOWN) if deps else UNKNOWN
        rows = _rows(in_spec)
        streaming = isinstance(op, StreamingFitOperator)
        pinned = getattr(op, "partition", None)
        if pinned is not None:
            # A planned graph carries the plan's own decision: report THAT.
            decision = pinned
        else:
            target = op.estimator if streaming else op
            opt_out = getattr(target, "partitionable", True) is False
            model_ok = getattr(target, "supports_model_axis", False)
            width = _width(in_spec)
            if streaming:
                decision = part.decide_stream(
                    label, op.chunk_rows or stream_chunk_rows(), rows=rows, record=False,
                    opt_out=opt_out, width=width, model_ok=model_ok,
                )
            else:
                decision = part.decide_fit(
                    label, rows, record=False, opt_out=opt_out, width=width, model_ok=model_ok
                )
        report.partition.append(decision.to_json())
        if not decision.eligible:
            interp.diag(
                "KV203",
                f"{label}: fit is not partition-managed ({decision.reason}"
                + (f": {decision.detail}" if decision.detail else "")
                + ") — streamed/serve fallbacks run single-device, in-core fits keep the legacy "
                "ambient-mesh path",
                node=node,
                reason=decision.reason,
            )
            continue
        if memory_limit is None:
            continue
        # Per-shard residency: the row slice (2× for the centered or
        # featurized working copy) plus the statistics every shard holds.
        in_bytes = spec_bytes(in_spec)
        if streaming:
            feat = interp.specs.get(("feat", node))
            d = _width(feat) if feat is not None else None
            chunk = decision.chunk_rows or stream_chunk_rows()
            row_bytes = (in_bytes // max(rows, 1)) if (in_bytes and rows) else None
            slice_bytes = 2 * chunk * row_bytes // decision.shards if row_bytes else 0
        else:
            d = _width(in_spec)
            slice_bytes = 2 * in_bytes // decision.shards if in_bytes else 0
        k = 1
        if len(deps) > 1:
            k = _width(interp.specs.get(deps[1])) or 1
        # 2-D layouts block the feature-indexed statistics over the model
        # axis; only the label-sized remainder stays whole per shard.
        p_m = max(1, int(decision.model_shards or 1))
        stat_bytes = 2 * 4 * ((d * d + d * k + d) // p_m + k) if d else 0
        per_device = slice_bytes + stat_bytes
        mesh = decision.mesh
        per_card = 1
        if mesh is not None:
            busiest = max(mesh.shards_per_device().values())
            per_card = max(1, decision.total_shards * busiest // mesh.size)
        if per_device * per_card > memory_limit:
            axis_hint = (
                "raise KEYSTONE_PARTITION_MODEL_SHARDS or use the sketched tier"
                if p_m > 1
                else "sharding divides rows, not the O(d²) state; use the sketched tier or a model-axis layout"
            )
            interp.diag(
                "KV304",
                f"{label}: sharded over {decision.shards}"
                + (f"×{p_m}" if p_m > 1 else "")
                + f" devices the per-device residency is still ~{per_device / 1e9:.2f} GB "
                f"(row slice {slice_bytes / 1e9:.2f} GB + "
                + ("feature-blocked" if p_m > 1 else "replicated")
                + f" statistics {stat_bytes / 1e9:.2f} GB), {per_card} shard(s) per card, against a "
                f"{memory_limit / 1e9:.2f} GB budget — " + axis_hint,
                node=node,
                shards=decision.shards,
                model_shards=p_m,
                shards_per_card=per_card,
                per_device_bytes=per_device,
                memory_limit=memory_limit,
            )


def _graph_device(graph: Graph) -> Optional[torch.device]:
    """The device the graph's work runs on: the first tensor's device
    among its bound datasets, then the first ``device`` an operator
    names. Metadata only."""
    from ..data.dataset import ArrayDataset

    named = None
    for node in sorted(graph.nodes):
        op = graph.get_operator(node)
        dataset = getattr(op, "dataset", None)
        if isinstance(dataset, ArrayDataset):
            return dataset.device
        for obj in (op, getattr(op, "estimator", None)):
            device = getattr(obj, "device", None)
            if named is None and isinstance(device, (str, torch.device)):
                try:
                    named = torch.device(device)
                except (RuntimeError, TypeError):
                    pass
    return named


def _device_memory_limit(graph: Optional[Graph] = None) -> Optional[int]:
    """The card's memory (``torch.cuda.mem_get_info``'s total) when the
    graph's work runs on a CUDA device, else None — the CPU reports no
    budget, as a JAX CPU mesh reports none, and the memory checks then
    run only with an explicit one. A graph with no device of its own is
    read as the entry points read ``device=None``: the card, when there
    is one."""
    device = _graph_device(graph) if graph is not None else None
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    if device.type != "cuda":
        return None
    try:
        return int(torch.cuda.mem_get_info(device)[1])
    except Exception:
        try:
            return int(torch.cuda.get_device_properties(device).total_memory)
        except Exception:
            return None


_AUTO = object()


def verify_graph(
    graph: Graph,
    source_specs: Optional[Dict[SourceId, Any]] = None,
    *,
    buckets: Optional[Sequence[int]] = None,
    warmed_buckets: Optional[Sequence[int]] = None,
    device_memory_bytes: Any = _AUTO,
    probe_objects: bool = False,
    context: str = "graph",
) -> VerifyReport:
    """Statically verify a plan graph. Pure host-side analysis: specs
    propagate via ``out_spec`` and the ``meta`` tracer — no kernel, no
    binding call, no card allocation (``check --pipeline`` reports the
    counters). The tracer runs under :class:`~.shape_rules.ShapeRules`,
    so a fresh process pays no import of torch's Python ``meta``
    kernels for the ops those rules cover."""
    from .shape_rules import ShapeRules

    with ShapeRules():
        return _verify_graph(
            graph,
            source_specs,
            buckets=buckets,
            warmed_buckets=warmed_buckets,
            device_memory_bytes=device_memory_bytes,
            probe_objects=probe_objects,
            context=context,
        )


def _verify_graph(
    graph: Graph,
    source_specs: Optional[Dict[SourceId, Any]],
    *,
    buckets: Optional[Sequence[int]],
    warmed_buckets: Optional[Sequence[int]],
    device_memory_bytes: Any,
    probe_objects: bool,
    context: str,
) -> VerifyReport:
    t0 = time.perf_counter()
    report = VerifyReport(context=context)
    interp = _Interpreter(report, probe_objects)
    memory_limit = _device_memory_limit(graph) if device_memory_bytes is _AUTO else device_memory_bytes

    try:
        order = linearize_whole(graph)
    except GraphCycleError as e:
        interp.diag("KV401", str(e))
        report.seconds = time.perf_counter() - t0
        _publish(report, context)
        return report

    peak_node_bytes = 0
    peak_node = None
    for vid in order:
        if isinstance(vid, SourceId):
            interp.specs[vid] = as_spec((source_specs or {}).get(vid, UNKNOWN))
            continue
        if isinstance(vid, SinkId):
            interp.specs[vid] = interp.specs.get(graph.get_sink_dependency(vid), UNKNOWN)
            continue
        op = graph.get_operator(vid)
        in_specs = [interp.specs.get(d, UNKNOWN) for d in graph.get_dependencies(vid)]
        out = interp.node_out_spec(vid, op, in_specs)
        interp.specs[vid] = out

        label = str(getattr(op, "label", type(op).__name__))
        out_bytes = spec_bytes(out)
        report.annotations.append(
            NodeAnnotation(node=repr(vid), label=label, spec=_render_spec(out), est_bytes=out_bytes)
        )
        # Silent widening: a float64 output from non-float64 inputs.
        out_leaves = _leaves(out)
        if out_leaves and any(_is_f64(leaf.dtype) for leaf in out_leaves):
            in_leaves = [leaf for spec in in_specs for leaf in _leaves(spec)]
            # A node with no known input leaves (a source/dataset node,
            # or all-UNKNOWN inputs) cannot have WIDENED anything — f64
            # there is the data's own dtype, not a silent cast.
            if in_leaves and not any(_is_f64(leaf.dtype) for leaf in in_leaves):
                interp.diag(
                    "KV102",
                    f"{label}: output widens to float64 from narrower inputs — 2× the bytes and a silent "
                    "slow path on accelerators",
                    node=vid,
                    op=label,
                )
        live = (out_bytes or 0) + sum(spec_bytes(spec) or 0 for spec in in_specs)
        if live > peak_node_bytes:
            peak_node_bytes, peak_node = live, (vid, label)

    if memory_limit is not None and peak_node_bytes > memory_limit:
        interp.diag(
            "KV302",
            f"estimated peak residency ~{peak_node_bytes / 1e9:.2f} GB at node {peak_node[0]!r} "
            f"({peak_node[1]}) exceeds the device memory budget {memory_limit / 1e9:.2f} GB",
            node=peak_node[0],
            peak_bytes=peak_node_bytes,
            memory_limit=memory_limit,
        )

    _fusion_diagnostics(graph, interp)
    _streaming_diagnostics(graph, interp, memory_limit)
    _partition_diagnostics(graph, interp, memory_limit, report)

    if buckets:
        # The serving decision rides the report next to the warm-set check.
        from ..parallel.partitioner import Partitioner

        report.partition.append(Partitioner().decide_serve("serving", buckets, record=False).to_json())
        warmed = set(int(b) for b in (warmed_buckets or ()))
        missing = sorted(set(int(b) for b in buckets) - warmed)
        if missing:
            interp.diag(
                "KV301",
                f"serving buckets {missing} are not in the warmed set {sorted(warmed)} — every batch padded "
                "onto them meets a cold shape at serve time (steady-state cold-shape hazard; "
                "utils/aot.warm_buckets)",
                missing=missing,
                warmed=sorted(warmed),
            )

    report.seconds = time.perf_counter() - t0
    _publish(report, context)
    return report


def verify_pipeline(pipeline: Any, input_spec: Any = None, **kwargs: Any) -> VerifyReport:
    """Verify a ``Pipeline`` or ``FittedPipeline``: binds ``input_spec``
    (a tree of spec leaves for the pipeline's input batch) to the
    unbound source when given."""
    graph = pipeline.graph
    source_specs = {}
    source = getattr(pipeline, "source", None)
    if input_spec is not None and source is not None and source in graph.sources:
        source_specs[source] = input_spec
    kwargs.setdefault("context", type(pipeline).__name__)
    return verify_graph(graph, source_specs or None, **kwargs)


def verification_mode() -> str:
    """``KEYSTONE_VERIFY``: ``warn`` (default — log and continue),
    ``strict`` (errors raise :class:`VerificationError`), ``off``."""
    raw = env_str("KEYSTONE_VERIFY", "warn").lower()
    if raw in ("off", "0", "disabled", "none"):
        return "off"
    if raw == "strict":
        return "strict"
    return "warn"


def verify_and_enforce(
    graph: Graph,
    context: str,
    source_specs: Optional[Dict[SourceId, Any]] = None,
    **kwargs: Any,
) -> Optional[VerifyReport]:
    """The fit/load hook: verify under the ``KEYSTONE_VERIFY`` mode.

    ``warn`` logs error/warning diagnostics and never interferes;
    ``strict`` raises :class:`VerificationError` when errors were found.
    An internal verifier failure is logged and swallowed in every mode —
    a bug in the verifier must never take down a fit that would have
    succeeded (only *verified* findings raise).
    """
    mode = verification_mode()
    if mode == "off":
        return None
    try:
        report = verify_graph(graph, source_specs, context=context, **kwargs)
    except Exception:
        logger.warning("plan-time verification of %s failed internally (ignored)", context, exc_info=True)
        return None
    for d in report.diagnostics:
        if d.severity == ERROR:
            logger.warning("plan-time verify [%s]: %s", context, d.render())
        elif d.severity == WARNING:
            logger.info("plan-time verify [%s]: %s", context, d.render())
    if mode == "strict" and not report.ok:
        raise VerificationError(report)
    return report


def _publish(report: VerifyReport, context: str) -> None:
    _names.metric(_names.VERIFY_RUNS).inc(context=context)
    _names.metric(_names.VERIFY_NODES).inc(len(report.annotations))
    _names.metric(_names.VERIFY_SECONDS).observe(report.seconds)
    diag_c = _names.metric(_names.VERIFY_DIAGNOSTICS)
    for d in report.diagnostics:
        diag_c.inc(code=d.code, severity=d.severity)


# -------------------------------------------------------------- KV305


def _model_device(model: Any) -> Optional[torch.device]:
    """The device of the first tensor among ``model``'s attributes (the
    operators' attributes for a fitted pipeline), else its ``device``
    attribute; None when neither says."""
    objs = [model]
    graph = getattr(model, "graph", None)
    if graph is not None:
        objs += list(getattr(graph, "operators", {}).values())
        objs += [m for op in objs[1:] for m in getattr(op, "members", ())]
    for obj in objs:
        for value in vars(obj).values() if hasattr(obj, "__dict__") else ():
            for leaf in tree_leaves(value) if isinstance(value, (tuple, list, dict)) else (value,):
                if isinstance(leaf, torch.Tensor):
                    return leaf.device
    device = getattr(model, "device", None)
    return torch.device(device) if device is not None else None


def _apply_out_spec(model: Any, example: Any):
    """A fitted model's per-row output spec for one request payload: ONE
    apply on a one-row zero batch on the model's device. This check keeps
    the real apply rather than the ``meta`` tracer: a candidate's apply is
    checked through the same binding calls it will serve with, and
    ``tests/test_torch_cuda.py`` holds it to that on the card. Returns a
    ``(kind, rendering)`` pair — ``arrays`` for an ``apply_arrays``
    model, ``batch`` for one applied through ``apply_batch`` (a fitted
    pipeline); the caller compares only like kinds. UNKNOWN when the
    model's device cannot be told or the apply fails."""
    from ..data.dataset import ArrayDataset

    device = _model_device(model)
    if device is None:
        return UNKNOWN

    def zero_row(a):
        dtype = getattr(a, "dtype", None)
        if isinstance(a, torch.Tensor):
            return torch.zeros((1,) + tuple(a.shape), dtype=a.dtype)
        return np.zeros((1,) + np.shape(a), np.dtype(dtype) if dtype is not None else np.asarray(a).dtype)

    def render(out) -> str:
        return repr(tree_map(lambda a: (tuple(a.shape[1:]), str(a.dtype)), out))

    try:
        batch = ArrayDataset(tree_map(zero_row, example), device=device)
        apply_arrays = getattr(model, "apply_arrays", None)
        if apply_arrays is not None:
            with torch.no_grad():
                return ("arrays", render(apply_arrays(batch.data)))
        apply_batch = getattr(model, "apply_batch", None)
        if apply_batch is None:
            return UNKNOWN
        with torch.no_grad():
            out = apply_batch(batch)
        return ("batch", render(getattr(out, "data", out)))
    except Exception:
        return UNKNOWN


def verify_refit_publish(
    candidate: Any,
    incumbent: Any,
    example: Any = None,
    buckets: Optional[Sequence[int]] = None,
    warmed_buckets: Optional[Sequence[int]] = None,
    context: str = "refit-publish",
) -> VerifyReport:
    """The publish-path face of the steady-state-recompile hazard (KV305).

    A refit-published candidate serves at the INCUMBENT's warmed bucket
    shapes: a candidate whose per-row output spec or required bucket set
    disagrees with what the incumbent warmed would meet cold shapes on
    live traffic after the publish settled. Runs before every controller
    publish."""
    t0 = time.perf_counter()
    report = VerifyReport(context=context)

    if buckets is not None:
        want = set(int(b) for b in buckets)
        warmed = set(int(b) for b in (warmed_buckets or ()))
        missing = sorted(want - warmed)
        if missing:
            report.diag(
                "KV305",
                f"candidate's serving buckets {missing} are not in the "
                f"incumbent's warmed set {sorted(warmed)} — every batch "
                "padded onto them meets a cold shape at serve time, AFTER "
                "the publish settled (re-warm the new buckets before swapping)",
                missing=missing,
                warmed=sorted(warmed),
            )

    if example is not None and incumbent is not None:
        cand_out = _apply_out_spec(candidate, example)
        inc_out = _apply_out_spec(incumbent, example)
        if (
            cand_out is not UNKNOWN
            and inc_out is not UNKNOWN
            # Same apply door only: renderings are not comparable
            # across kinds.
            and cand_out[0] == inc_out[0]
            and cand_out[1] != inc_out[1]
        ):
            report.diag(
                "KV305",
                f"candidate's apply spec {cand_out[1]} != incumbent's "
                f"{inc_out[1]} for the same request — the warmed shapes "
                "cannot serve it (shape/dtype drift in the refit candidate)",
                candidate_spec=str(cand_out[1]),
                incumbent_spec=str(inc_out[1]),
            )

    report.seconds = time.perf_counter() - t0
    _publish(report, context)
    return report


# -------------------------------------------------------------- KV306

#: cursor field → title, in the order the JAX package checks them.
RESUME_FINGERPRINTS: Tuple[Tuple[str, str], ...] = (
    ("dataset_digest", "dataset content digest"),
    ("labels_digest", "labels content digest"),
    ("chain_digest", "featurize-chain digest"),
    ("feature_width", "featurized width"),
    ("feature_dtype", "featurized dtype"),
)


def verify_stream_resume(cursor: Any, current: Dict[str, Any], context: str = "stream-resume") -> VerifyReport:
    """The durable-fit face of stale-state corruption (KV306).

    A mid-stream resume entry seeds a fold with statistics captured over
    a PREFIX of the dataset — sound only when the re-planned pipeline
    reproduces the exact same features for the exact same rows. Any
    disagreement between the cursor's fingerprints and ``current`` (the
    same field names, the re-planned pipeline's values) refuses the
    entry. Pure host-side comparison, no device work."""
    t0 = time.perf_counter()
    report = VerifyReport(context=context)
    for field_name, title in RESUME_FINGERPRINTS:
        have = getattr(cursor, field_name)
        want = current.get(field_name)
        if have != want:
            report.diag(
                "KV306",
                f"resume entry's {title} ({str(have)[:16]}) disagrees with "
                f"the re-planned pipeline's ({str(want)[:16]}) — seeding "
                "the fold from this entry would silently corrupt the fit; "
                "the entry is refused and the fit re-ingests from scratch",
                field=field_name,
                entry=str(have)[:16],
                planned=str(want)[:16],
            )
    report.seconds = time.perf_counter() - t0
    _publish(report, context)
    return report


# -------------------------------------------------------------- KV307

#: manifest/environment fields verify_boot_image compares, with the human
#: titles its diagnostics use. serving/bootimage.py builds both sides.
BOOT_IMAGE_FINGERPRINTS: Tuple[Tuple[str, str], ...] = (
    ("format_version", "artifact format version"),
    ("torch_version", "torch version"),
    ("cuda_version", "CUDA version"),
    ("device_name", "device"),
    ("compute_capability", "compute capability"),
    ("kernel_sources", "kernel sources hash"),
    ("weights_digest", "fitted-weights digest"),
)


def verify_boot_image(
    manifest: Dict[str, Any], current: Dict[str, Any], context: str = "boot-image"
) -> VerifyReport:
    """The serving face of stale-state corruption (KV307).

    A boot image carries the fitted weights, the kernel libraries the
    model's apply loads and the parity digests of its build — sound to
    serve from only when the loading worker's environment matches the
    builder's: the same artifact format, torch and CUDA versions (the
    pickled model and the libraries' ABI), the same card and compute
    capability (libraries built for ``sm_90a``; digests of products on
    that card), the same kernel sources (a library built from other
    sources must not be placed where ``_build`` looks), and the same
    weights digest (a ``model.pkl`` that is not the one the digests were
    taken from). Any disagreement refuses the image: the worker falls
    back to the classic warm path — slower first request, never garbage.
    Pure host-side comparison, no device work."""
    t0 = time.perf_counter()
    report = VerifyReport(context=context)
    for field_name, title in BOOT_IMAGE_FINGERPRINTS:
        have = manifest.get(field_name)
        want = current.get(field_name)
        if have != want:
            report.diag(
                "KV307",
                f"boot image's {title} ({str(have)[:24]}) disagrees with "
                f"this worker's ({str(want)[:24]}) — serving from it could "
                "return garbage; the image is refused and the worker warms "
                "through the classic path",
                field=field_name,
                image=str(have)[:24],
                worker=str(want)[:24],
            )
    report.seconds = time.perf_counter() - t0
    _publish(report, context)
    return report


__all__ = [
    "CODES",
    "Diagnostic",
    "NodeAnnotation",
    "SpecMismatch",
    "TensorSpec",
    "TransformerSpec",
    "UNKNOWN",
    "VerificationError",
    "VerifyReport",
    "as_spec",
    "dense_fit_spec",
    "elementwise_fit_spec",
    "is_shape_error",
    "projection_fit_spec",
    "spec_bytes",
    "spec_leaf",
    "verification_mode",
    "verify_and_enforce",
    "verify_boot_image",
    "verify_graph",
    "verify_pipeline",
    "verify_refit_publish",
    "verify_stream_resume",
]
