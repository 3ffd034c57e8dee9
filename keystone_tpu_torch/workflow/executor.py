"""Pull-based memoized graph execution + the process-wide pipeline env.

Port of ``keystone_tpu/workflow/executor.py``
(reference: workflow/GraphExecutor.scala:14-81, workflow/PipelineEnv.scala:7-37).

``GraphExecutor`` optimizes its graph once (on first pull), then recursively
executes dependencies with memoization. Results are lazy ``Expression``s:
forcing one is what launches the device work.

``PipelineEnv`` holds the prefix-state table used for cross-pipeline reuse
of fit estimators and cached datasets, the active optimizer stack, and the
reliability hook the executor consults per node: ``retry_policy`` (a
``reliability.RetryPolicy`` — transient faults retried, per-node deadline
enforced). Its ``nodes_executed`` counts the operators the executors have
run since the last :meth:`PipelineEnv.reset`; the
``keystone_executor_nodes_executed_total`` and ``_memo_hits_total``
counters count the same across resets, and optimizing opens an
``optimize`` span.

Left out for now: the ``checkpoint`` hook (``reliability/checkpoint.py``),
the auto-cache counters and ``partition_decisions``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..obs import names as _names
from ..obs import spans as _spans
from ..reliability import faultinject
from ..reliability.recovery import reset_recovery_log
from .graph import Graph, GraphId, NodeId, SinkId, SourceId
from .operators import Expression
from .prefix import Prefix
from .tracing import timed_execute


class PipelineEnv:
    """Process-wide executor state (reference: PipelineEnv.scala:7-37)."""

    _instance: Optional["PipelineEnv"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.state: Dict[Prefix, Expression] = {}
        self.nodes_executed = 0
        self._optimizer = None
        # Reliability hook, default OFF (zero per-node overhead): a
        # reliability.RetryPolicy applied to every node forcing.
        self.retry_policy = None

    @classmethod
    def get_or_create(cls) -> "PipelineEnv":
        with cls._lock:
            if cls._instance is None:
                cls._instance = PipelineEnv()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Drop all global state — required between tests
        (reference: test fixture PipelineContext.scala:9-25). Clears the
        recovery ledger too: it is per-run state like the prefix table."""
        with cls._lock:
            cls._instance = None
        reset_recovery_log()

    @property
    def optimizer(self):
        if self._optimizer is None:
            from .rules import default_optimizer

            self._optimizer = default_optimizer()
        return self._optimizer

    @optimizer.setter
    def optimizer(self, value) -> None:
        self._optimizer = value


class GraphExecutor:
    """Memoized recursive interpreter over an (optionally optimized) graph."""

    def __init__(self, graph: Graph, optimize: bool = True):
        self._raw_graph = graph
        self._optimize = optimize
        self._optimized: Optional[Graph] = None
        self._prefixes: Dict[NodeId, Prefix] = {}
        self._memo: Dict[GraphId, Expression] = {}

    @property
    def graph(self) -> Graph:
        """The optimized graph (optimizes on first access)."""
        if self._optimized is None:
            if self._optimize:
                env = PipelineEnv.get_or_create()
                with _spans.span("optimize"):
                    self._optimized, self._prefixes = env.optimizer.execute(self._raw_graph)
            else:
                self._optimized = self._raw_graph
        return self._optimized

    @property
    def raw_graph(self) -> Graph:
        return self._raw_graph

    def execute(self, graph_id: GraphId) -> Expression:
        graph = self.graph
        if graph_id in self._memo:
            if isinstance(graph_id, NodeId):
                _names.metric(_names.MEMO_HITS).inc()
            return self._memo[graph_id]
        if isinstance(graph_id, SourceId):
            raise ValueError(
                f"cannot execute unbound source {graph_id}: bind pipeline inputs first"
            )
        if isinstance(graph_id, SinkId):
            result = self.execute(graph.get_sink_dependency(graph_id))
            self._memo[graph_id] = result
            return result

        deps = [self.execute(d) for d in graph.get_dependencies(graph_id)]
        op = graph.get_operator(graph_id)
        env = PipelineEnv.get_or_create()
        env.nodes_executed += 1
        _names.metric(_names.NODES_EXECUTED).inc()
        expression = _wrap_reliability(op, deps, timed_execute(op, deps))

        # Prefix write-back: make this node's result reusable by later
        # pipelines (reference: GraphExecutor.scala:65-71).
        prefix = self._prefixes.get(graph_id)
        if prefix is not None:
            env.state[prefix] = expression

        self._memo[graph_id] = expression
        return expression


def _wrap_reliability(op, deps, expression: Expression) -> Expression:
    """Layer the reliability hooks around a node's lazy result.

    Expressions are call-by-name memoized and a failing thunk leaves the
    memo unset, so re-forcing after a failure genuinely re-executes —
    which is what makes wrapping the *expression* (not the eager execute
    call) the right retry boundary: the heavy work happens at force time.

    Wrapping order, innermost out:
      1. fault injection — stands in for the op itself failing;
      2. (checkpoint — a digest hit skips the op; not ported yet);
      3. retry + per-node deadline — sees injected and real faults alike.
    Both default off; with neither active the original expression is
    returned untouched.

    Each retry executes the op FRESH (``timed_execute(op, deps)`` only
    builds lazy thunks; deps stay memoized) rather than re-entering the
    shared Expression: after a deadline abandonment the watchdog thread
    may still be inside the old expression's ``get`` holding its lock,
    and a retry re-entering it would block behind the hung attempt. The
    wrapper expression memoizes the one successful result for all
    downstream readers.
    """
    injector = faultinject.current()
    policy = PipelineEnv.get_or_create().retry_policy
    if injector is None and policy is None:
        return expression

    label = str(getattr(op, "label", type(op).__name__))

    def thunk(_first=[expression]):
        # The first attempt consumes the already-built expression;
        # retries get a fresh one (see docstring).
        inner = _first.pop() if _first else timed_execute(op, deps)
        return inner.get()

    if injector is not None:
        thunk = injector.wrap(label, thunk)
    if policy is not None:
        attempt = thunk
        thunk = lambda: policy.call(attempt, label=label)  # noqa: E731
    return type(expression)(thunk)
