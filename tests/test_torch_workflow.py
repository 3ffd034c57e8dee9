"""Graph IR, optimizer rules, executor and pipeline semantics of
``keystone_tpu_torch.workflow``, on the port's own operators, on the CPU.

Mirrors the JAX package's ``tests/workflow/test_graph.py``,
``test_analysis.py``, ``test_rules.py``, ``test_pipeline.py`` and
``test_node_optimization.py``. Results are exact (no tolerance) except
where a line says otherwise.
"""

import sys
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
from keystone_tpu_torch.ops.stats.core import LinearRectifier, NormalizeRows, RandomSignNode
from keystone_tpu_torch.ops.util.misc import CacherOperator, ShufflerOperator
from keystone_tpu_torch.workflow import analysis
from keystone_tpu_torch.workflow.executor import GraphExecutor, PipelineEnv
from keystone_tpu_torch.workflow.graph import Graph, NodeId
from keystone_tpu_torch.workflow.operators import (
    DatasetOperator,
    Expression,
    ExpressionOperator,
    TransformerOperator,
)
from keystone_tpu_torch.workflow.optimize import (
    DataStats,
    NodeOptimizationRule,
    Optimizable,
    UnportedRung,
)
from keystone_tpu_torch.workflow.pipeline import (
    BatchTransformer,
    Estimator,
    FittedPipeline,
    Identity,
    LabelEstimator,
    Pipeline,
    Transformer,
)
from keystone_tpu_torch.workflow.prefix import find_prefix
from keystone_tpu_torch.workflow.rules import (
    EquivalentNodeMergeRule,
    SavedStateLoadRule,
    UnusedBranchRemovalRule,
    default_optimizer,
)
from keystone_tpu_torch.workflow.tracing import current_trace, trace

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


# ------------------------------------------------------------------ operators


class Op(TransformerOperator):
    def __init__(self, name):
        self.name = name

    @property
    def label(self):
        return self.name

    def single_transform(self, datums):
        return datums[0]


class Plus(Transformer):
    def __init__(self, k):
        self.k = k

    def apply(self, x):
        return x + self.k


class CountingEstimator(Estimator):
    """Fits a transformer adding the dataset mean; counts fit calls."""

    def __init__(self):
        self.fit_count = 0

    def fit(self, data):
        self.fit_count += 1
        return Plus(float(np.mean(data.collect())))


class CountingLabelEstimator(LabelEstimator):
    def __init__(self):
        self.fit_count = 0

    def fit(self, data, labels):
        self.fit_count += 1
        return Plus(float(np.mean(labels.collect())) - float(np.mean(data.collect())))


class Scale(BatchTransformer):
    """Multiplies by a factor; counts batch applications."""

    def __init__(self, factor):
        self.factor = factor
        self.batches = 0

    def apply_arrays(self, x):
        self.batches += 1
        return x * self.factor


def simple_graph():
    g = Graph()
    g, src = g.add_source()
    g, a = g.add_node(Op("a"), [src])
    g, b = g.add_node(Op("b"), [a])
    g, sink = g.add_sink(b)
    return g, src, a, b, sink


def _chain_graph(n):
    graph = Graph()
    graph, src = graph.add_source()
    prev = src
    nodes = []
    for i in range(n):
        graph, node = graph.add_node(Op(f"op{i}"), [prev])
        nodes.append(node)
        prev = node
    graph, sink = graph.add_sink(prev)
    return graph, src, nodes, sink


def _cpu(a):
    return ArrayDataset(np.asarray(a, np.float32), device=CPU)


# ---------------------------------------------------------------------- graph


def test_add_node_sink_and_unique_ids():
    g, src, a, b, sink = simple_graph()
    assert g.sources == {src}
    assert g.nodes == {a, b}
    assert g.get_sink_dependency(sink) == b
    assert g.get_dependencies(b) == (a,)
    assert len({src.id, a.id, b.id, sink.id}) == 4


def test_remove_referenced_vertex_fails_until_redirected():
    g, src, a, b, sink = simple_graph()
    with pytest.raises(ValueError):
        g.remove_node(a)  # b depends on a
    with pytest.raises(ValueError):
        g.remove_source(src)  # a depends on src
    g2 = g.replace_dependency(a, src).remove_node(a)
    assert g2.nodes == {b}
    assert g2.get_dependencies(b) == (src,)
    assert g.replace_dependency(b, a).get_sink_dependency(sink) == a


def test_add_graph_and_connect_graph():
    g1, src1, a1, b1, sink1 = simple_graph()
    g2, src2, a2, b2, sink2 = simple_graph()
    combined, source_map, _ = g1.add_graph(g2)
    assert (len(combined.nodes), len(combined.sources), len(combined.sinks)) == (4, 2, 2)
    assert source_map[src2] != src1
    assert len(g1.nodes) == 2  # original untouched
    joined, _, sink_map = g1.connect_graph(g2, {src2: sink1})
    assert (len(joined.sources), len(joined.sinks)) == (1, 1)
    order = analysis.linearize(joined, sink_map[sink2])
    assert order[0] == src1
    assert len([v for v in order if isinstance(v, NodeId)]) == 4


def test_set_operator_and_dot_export():
    g, src, a, b, sink = simple_graph()
    new_op = Op("z")
    assert g.set_operator(a, new_op).get_operator(a) is new_op
    dot = g.to_dot()
    assert dot.startswith("digraph")
    for vid in [src, a, b, sink]:
        assert repr(vid) in dot


def test_ancestors_descendants_and_linearize():
    g, src, a, b, sink = simple_graph()
    assert analysis.get_ancestors(g, sink) == {src, a, b}
    assert analysis.get_descendants(g, src) == {a, b, sink}
    assert analysis.get_children(g, a) == {b}
    assert analysis.get_parents(g, b) == [a]
    order = analysis.linearize(g, sink)
    assert order.index(src) < order.index(a) < order.index(b) < order.index(sink)


@pytest.mark.parametrize("shape", ["chain", "self_loop", "island"])
def test_cycles_detected(shape):
    graph, _src, nodes, _sink = _chain_graph(4)
    if shape == "chain":
        cyclic = graph.set_dependencies(nodes[1], [nodes[3]])
    elif shape == "self_loop":
        cyclic = graph.set_dependencies(nodes[0], [nodes[0]])
    else:  # a cyclic island that no sink reaches
        graph, a = graph.add_node(Op("a"), [])
        graph, b = graph.add_node(Op("b"), [a])
        cyclic = graph.set_dependencies(a, [b])
    cycle = analysis.find_cycle(cyclic)
    assert cycle is not None and cycle[0] == cycle[-1]
    with pytest.raises(analysis.GraphCycleError, match="dependency cycle"):
        analysis.linearize_whole(cyclic)
    assert analysis.find_cycle(graph) is None


def test_diamond_linearizes_once_and_deep_chain_does_not_recurse():
    graph = Graph()
    graph, src = graph.add_source()
    graph, head = graph.add_node(Op("head"), [src])
    graph, left = graph.add_node(Op("left"), [head])
    graph, right = graph.add_node(Op("right"), [head])
    graph, join = graph.add_node(Op("join"), [left, right])
    graph, _ = graph.add_sink(join)
    order = analysis.linearize_whole(graph)
    assert len(order) == len(set(order))
    pos = {v: i for i, v in enumerate(order)}
    assert pos[head] < pos[left] < pos[join] and pos[right] < pos[join]
    depth = sys.getrecursionlimit() + 200
    assert len(analysis.linearize_whole(_chain_graph(depth)[0])) == depth + 2


# ---------------------------------------------------------------------- rules


@pytest.mark.parametrize(
    "case, nodes_after", [("same_op", 1), ("chains", 2), ("different_ops", 2)]
)
def test_cse_to_fixed_point(case, nodes_after):
    g = Graph()
    g, src = g.add_source()
    if case == "same_op":
        op = Op("same")
        g, a = g.add_node(op, [src])
        g, b = g.add_node(op, [src])
    elif case == "chains":
        op1, op2 = Op("x"), Op("y")
        g, a1 = g.add_node(op1, [src])
        g, a2 = g.add_node(op1, [src])
        g, a = g.add_node(op2, [a1])
        g, b = g.add_node(op2, [a2])
    else:
        g, a = g.add_node(Op("x"), [src])
        g, b = g.add_node(Op("x"), [src])  # equal names, distinct instances
    g, s1 = g.add_sink(a)
    g, s2 = g.add_sink(b)
    merged, _ = EquivalentNodeMergeRule().apply(g, {})
    assert len(merged.nodes) == nodes_after
    shared = merged.get_sink_dependency(s1) == merged.get_sink_dependency(s2)
    assert shared == (case != "different_ops")


def test_cse_keys_tensor_holding_operators_by_identity():
    """Operators that hold tensors never compare by value: one instance
    used twice merges, two instances with equal tensors do not, and
    neither raises (a tensor-valued ``==`` would)."""
    shared = RandomSignNode(np.ones(3), device=CPU)
    twin_a, twin_b = RandomSignNode(np.ones(3), device=CPU), RandomSignNode(np.ones(3), device=CPU)
    g = Graph()
    g, src = g.add_source()
    for op in (shared, shared, twin_a, twin_b):
        g, n = g.add_node(op, [src])
        g, _ = g.add_sink(n)
    merged, _ = EquivalentNodeMergeRule().apply(g, {})
    assert sorted(Counter(id(o) for o in merged.operators.values()).values()) == [1, 1, 1]


def test_unused_branch_removal():
    g = Graph()
    g, src = g.add_source()
    g, a = g.add_node(Op("live"), [src])
    g, dead1 = g.add_node(Op("dead1"), [src])
    g, _ = g.add_node(Op("dead2"), [dead1])
    g, _ = g.add_sink(a)
    pruned, _ = UnusedBranchRemovalRule().apply(g, {})
    assert pruned.nodes == {a}


def test_prefixes_across_graphs():
    op = Op("a")
    ds = ObjectDataset([1, 2])
    graphs = []
    for dataset in (ds, ds, ObjectDataset([1, 2])):
        g = Graph()
        g, d = g.add_node(DatasetOperator(dataset), [])
        g, a = g.add_node(op, [d])
        graphs.append((g, a))
    p1, p2, p3 = (find_prefix(g, a) for g, a in graphs)
    assert p1 == p2  # same dataset object → same prefix
    assert p1 != p3  # equal contents, other object → other prefix
    g, src, a, _, _ = simple_graph()
    assert find_prefix(g, a) is None  # depends on an unbound source


def test_saved_state_load_splices_expression():
    g = Graph()
    g, d = g.add_node(DatasetOperator(ObjectDataset([1, 2])), [])
    g, a = g.add_node(Op("a"), [d])
    g, _ = g.add_sink(a)
    prefix = find_prefix(g, a)
    PipelineEnv.get_or_create().state[prefix] = Expression.of("stored-result")
    new_graph, prefixes = SavedStateLoadRule().apply(g, {a: prefix})
    assert isinstance(new_graph.get_operator(a), ExpressionOperator)
    assert new_graph.get_dependencies(a) == ()
    assert a not in prefixes


def test_default_optimizer_batches():
    names = [(b.name, b.fixed_point) for b in default_optimizer().batches]
    assert names == [
        ("load-saved-state", False), ("cse", True), ("node-level-optimization", False),
        ("fusion", False), ("streaming", False),
    ]


# ---------------------------------------------------------- node optimization


class _ChooseByN(Transformer, Optimizable):
    """Picks ×2 below ``threshold`` rows, ×3 above; records what it saw."""

    def __init__(self, threshold=50):
        self.threshold = threshold
        self.seen = None

    def apply(self, x):
        return x

    def apply_batch(self, ds):
        return ds

    def optimize(self, samples, stats: DataStats):
        self.seen = (len(samples[0]), stats)
        return Scale(2.0) if stats.n_total < self.threshold else Scale(3.0)


@pytest.mark.parametrize("rows, factor", [(80, 3.0), (10, 2.0)])
def test_node_optimization_uses_full_data_stats(rows, factor):
    op = _ChooseByN(threshold=50)
    got = op.to_pipeline()(_cpu(np.ones((rows, 2)))).get().data
    torch.testing.assert_close(got, torch.full((rows, 2), factor))
    sample_len, stats = op.seen
    assert stats.n_total == rows and stats.num_shards == 1
    assert sample_len <= NodeOptimizationRule().sample_size


def test_node_optimization_failure_keeps_default(caplog):
    class _Broken(_ChooseByN):
        def optimize(self, samples, stats):
            raise RuntimeError("boom")

    got = _Broken().to_pipeline()(_cpu(np.ones((10, 2)))).get().data
    torch.testing.assert_close(got, torch.ones(10, 2))
    assert "node optimization skipped" in caplog.text


class _NoTake(ObjectDataset):
    """A dataset whose sampling is not implemented."""

    def take(self, n):
        raise NotImplementedError


@pytest.mark.parametrize("where", ["optimize", "sample"])
def test_node_optimization_bare_not_implemented_keeps_default(where, caplog):
    """A bare NotImplementedError, from ``optimize`` or from the sample
    pass, is logged and leaves the default operator, as in the JAX
    package; only ``UnportedRung`` fails the plan."""

    class _Abstract(_ChooseByN):
        def optimize(self, samples, stats):
            raise NotImplementedError

    if where == "optimize":
        got = _Abstract().to_pipeline()(_cpu(np.ones((10, 2)))).get().data
        torch.testing.assert_close(got, torch.ones(10, 2))
    else:
        items = list(range(NodeOptimizationRule().sample_size + 50))
        got = _ChooseByN().to_pipeline()(_NoTake(items)).get()
        assert got.collect() == items
    assert "node optimization skipped" in caplog.text


def test_node_optimization_unported_rung_fails_the_plan():
    class _Unported(_ChooseByN):
        def optimize(self, samples, stats):
            raise UnportedRung("rung not ported")

    with pytest.raises(UnportedRung, match="not ported"):
        _Unported().to_pipeline()(_cpu(np.ones((10, 2)))).get()


# ------------------------------------------------------------------- datasets


@pytest.mark.parametrize("kind", ["tensor", "tuple", "list", "dict"])
def test_array_dataset_trees(kind):
    a = np.arange(12, dtype=np.float64).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    data = {"tensor": a, "tuple": (a, b), "list": [a, b], "dict": {"x": a, "y": b}}[kind]
    ds = ArrayDataset(data, num_examples=4, device=CPU)
    assert len(ds) == 4 and ds.physical_rows == 6 and ds.device == CPU
    assert ds.num_shards == 1 and ds.per_shard_counts() == [4]
    torch.testing.assert_close(ds.mask(), torch.tensor([1.0, 1, 1, 1, 0, 0]))
    rows = ds.collect()
    assert len(rows) == 4 and len(ds.take(2)) == 2
    first = rows[3] if kind == "tensor" else rows[3][0 if kind != "dict" else "x"]
    np.testing.assert_array_equal(first, a[3].astype(np.float32))  # float64 narrows
    doubled = ds.map_batched(lambda t: t)
    assert type(doubled.data) is type(ds.data) and doubled.num_examples == 4


def test_array_dataset_rejects_ragged_and_scalar_leaves():
    with pytest.raises(ValueError, match="inconsistent"):
        ArrayDataset((np.zeros((3, 2)), np.zeros(4)), device=CPU)
    with pytest.raises(ValueError, match="leading example axis"):
        ArrayDataset(np.float32(1.0), device=CPU)


def test_batch_transformer_zeroes_pad_rows_in_every_leaf():
    class Log(BatchTransformer):
        def apply_arrays(self, tree):
            return {k: torch.log(v) for k, v in tree.items()}

    tree = {"a": np.full((4, 2), 3.0), "b": np.full(4, 2.0)}
    out = Log().apply_batch(ArrayDataset(tree, num_examples=3, device=CPU))
    assert torch.equal(out.data["a"][3], torch.zeros(2))
    assert torch.equal(out.data["b"], torch.log(torch.tensor([2.0, 2.0, 2.0, 1.0])))


# --------------------------------------------------------------------- pipeline


def test_transformer_single_batch_and_chaining():
    t = Plus(2)
    assert t(3) == 5
    assert t(ObjectDataset([1, 2, 3])).get().collect() == [3, 4, 5]
    pipe = Plus(1) >> Plus(10)
    assert pipe(1).get() == 12
    assert pipe(ObjectDataset([0, 5])).get().collect() == [11, 16]
    assert Identity()(7) == 7
    double = Transformer.from_fn(lambda v: v * 2, batch_fn=lambda t: t * 2, name="double")
    assert double.label == "double" and double(4) == 8
    torch.testing.assert_close(double(_cpu([[1.0], [2.0]])).get().data, torch.tensor([[2.0], [4.0]]))


def test_estimator_laziness_and_fit_once_across_applications():
    est = CountingEstimator()
    pipe = est.with_data(ObjectDataset([2.0, 4.0]))  # mean 3
    result = pipe(1.0)
    assert est.fit_count == 0  # nothing forced yet
    assert result.get() == 4.0
    assert pipe(2.0).get() == 5.0
    assert pipe(ObjectDataset([0.0])).get().collect() == [3.0]
    assert est.fit_count == 1


def test_then_estimator_and_then_label_estimator():
    est = CountingEstimator()
    pipe = Plus(1).then_estimator(est, ObjectDataset([0.0, 2.0]))  # fits on [1, 3]
    assert pipe(0.0).get() == 3.0
    lest = CountingLabelEstimator()
    pipe2 = Identity().then_label_estimator(
        lest, ObjectDataset([1.0, 3.0]), ObjectDataset([11.0, 13.0])
    )
    assert pipe2(5.0).get() == 15.0
    assert (est.fit_count, lest.fit_count) == (1, 1)


def test_gather_datum_object_and_tensor_batches():
    pipe = Pipeline.gather([Plus(1), Plus(2), Plus(3)])
    assert pipe(10).get() == [11, 12, 13]
    assert pipe(ObjectDataset([0, 10])).get().collect() == [[1, 2, 3], [11, 12, 13]]
    x = _cpu(np.arange(6).reshape(3, 2))
    gathered = Pipeline.gather([Scale(1.0), Scale(-1.0)])(x).get()
    assert isinstance(gathered.data, tuple) and len(gathered.data) == 2
    torch.testing.assert_close(gathered.data[1], -x.data)


def test_shared_featurize_chain_runs_once_per_get():
    """CSE merges the chain that the estimator's data and the apply path
    share: applied to its own training data, the chain runs once."""
    scale = Scale(2.0)
    x = _cpu(np.ones((5, 2)))

    class MeanEstimator(Estimator):
        def fit(self, data):
            return Scale(float(data.data.mean()))

    pipe = scale.to_pipeline().then_estimator(MeanEstimator(), x)
    out = pipe(x).get().data
    torch.testing.assert_close(out, torch.full((5, 2), 4.0))
    assert scale.batches == 1


@pytest.mark.parametrize("with_labels", [False, True])
def test_estimator_with_data_equals_direct_fit(with_labels):
    rng = np.random.default_rng(int(with_labels))
    train, test = _cpu(rng.random((20, 3))), _cpu(rng.random((5, 3)))
    labels = _cpu(rng.random((20, 1)))

    class Mean(Estimator):
        def fit(self, data):
            return Scale(float(data.data.mean()))

    class LabelMean(LabelEstimator):
        def fit(self, data, labels):
            return Scale(float(labels.data.mean()))

    if with_labels:
        pipe, model = LabelMean().with_data(train, labels), LabelMean().fit(train, labels)
    else:
        pipe, model = Mean().with_data(train), Mean().fit(train)
    torch.testing.assert_close(pipe(test).get().data, model.apply_batch(test).data)


def test_fit_leaves_no_estimator_and_composes():
    est = CountingEstimator()
    pipe = Plus(1) >> est.with_data(ObjectDataset([2.0, 4.0]))  # mean 3
    fitted = pipe.fit()
    assert isinstance(fitted, FittedPipeline)
    kinds = {type(op).__name__ for op in fitted.graph.operators.values()}
    assert kinds == {"Plus"}  # no estimator, no delegating node, no dataset
    assert fitted.apply(0.0) == 4.0 and fitted.apply(1.0) == 5.0
    assert est.fit_count == 1
    assert (fitted >> Plus(100))(0.0).get() == 104.0


def test_save_load_round_trip_on_cpu(tmp_path):
    x = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    est = CountingEstimator()
    fitted = (RandomSignNode.create(4, seed=3, device=CPU) >> LinearRectifier(0.0)).fit()
    want = fitted.apply_batch(_cpu(x)).data
    path = str(tmp_path / "pipe.pt")
    fitted.save(path)
    loaded = FittedPipeline.load(path, device="cpu")
    assert torch.equal(loaded.apply_batch(_cpu(x)).data, want)
    assert loaded.apply(x[0]).device == CPU
    with pytest.raises(TypeError, match="FittedPipeline"):
        torch.save(est, path)
        FittedPipeline.load(path, device="cpu")


def test_trace_records_per_node_times_and_is_off_by_default():
    ds = _cpu(np.random.default_rng(0).normal(size=(16, 4)))
    pipeline = LinearRectifier(0.0).to_pipeline() >> NormalizeRows()
    with trace() as t:
        pipeline(ds).get()
    labels = [x.label for x in t.timings]
    assert "Fused[LinearRectifier+NormalizeRows]" in labels  # one node: the fused chain
    assert all(x.seconds >= 0 for x in t.timings) and "TOTAL" in t.report()
    assert current_trace() is None

    calls = []

    class Probe(Transformer):
        def apply(self, x):
            calls.append(x)
            return x + 1

    result = Probe().to_pipeline()(ObjectDataset([1, 2]))
    assert calls == []  # untraced application stays lazy until forced
    assert result.get().collect() == [2, 3] and calls == [1, 2]


def test_single_datum_apply_goes_to_the_operator_device(monkeypatch):
    signs = RandomSignNode(np.array([1.0, -1.0]), device=CPU)
    out = signs.apply(np.array([3.0, 4.0]))  # numpy datum → the signs' device
    assert out.device == CPU and out.dtype == torch.float32
    torch.testing.assert_close(out, torch.tensor([3.0, -4.0]))
    # A host datum for an operator without tensors goes to the default
    # CUDA device: without a card that raises instead of using the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinearRectifier(0.0).apply(np.array([1.0, -1.0]))
    torch.testing.assert_close(LinearRectifier(0.0).apply(torch.tensor([1.0, -1.0])),
                               torch.tensor([1.0, 0.0]))


def test_fitted_pipeline_apply_is_thread_safe():
    fitted = (Plus(1) >> CountingEstimator().with_data(ObjectDataset([2.0, 4.0]))).fit()
    inputs = [float(i) for i in range(64)]
    expected = [fitted.apply(v) for v in inputs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            got = list(pool.map(fitted.apply, inputs))
    finally:
        sys.setswitchinterval(interval)
    assert got == expected


def test_expression_forces_once_under_threads():
    calls = []
    expr = Expression(lambda: calls.append(1) or len(calls))
    threads = [threading.Thread(target=expr.get) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert calls == [1] and expr.get() == 1


def test_executor_counts_nodes_and_reset_clears_state():
    pipe = CountingEstimator().with_data(ObjectDataset([1.0]))
    pipe(ObjectDataset([0.0])).get()
    env = PipelineEnv.get_or_create()
    assert env.nodes_executed == 4  # train data, estimator, test data, delegating
    assert len(env.state) == 1  # the estimator's prefix
    PipelineEnv.reset()
    assert PipelineEnv.get_or_create().state == {}
    executor = GraphExecutor(simple_graph()[0])
    with pytest.raises(ValueError, match="unbound source"):
        executor.execute(simple_graph()[1])


@pytest.mark.parametrize("level", ["hbm", "host"])
def test_cacher_is_saveable_identity(level):
    x = _cpu(np.arange(8).reshape(4, 2))
    cacher = CacherOperator("c", level=level)
    g = Graph()
    g, d = g.add_node(DatasetOperator(x), [])
    g, c = g.add_node(cacher, [d])
    g, s = g.add_sink(c)
    out = GraphExecutor(g).execute(s).get()
    torch.testing.assert_close(out.data, x.data)
    assert len(PipelineEnv.get_or_create().state) == 1  # its prefix was saved
    with pytest.raises(ValueError):
        CacherOperator(level="disk")


def test_shuffler_permutes_rows_like_numpy():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    perm = np.random.default_rng(7).permutation(5)
    out = ShufflerOperator(seed=7).batch_transform([_cpu(x)])
    np.testing.assert_array_equal(out.data.numpy(), x[perm])
    items = ShufflerOperator(seed=7).batch_transform([ObjectDataset(list(range(5)))]).collect()
    assert sorted(items) == list(range(5))


# ------------------------------------------- fusion in fit, precision modes


def test_fit_returns_fused_pipeline_and_fused_is_stable():
    from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator, fusion_disabled

    x = _cpu(np.random.default_rng(1).normal(size=(6, 4)))
    chain = RandomSignNode.create(4, seed=2, device=CPU) >> LinearRectifier(0.0) >> NormalizeRows()
    fitted = chain.fit()
    (fused,) = fitted.graph.operators.values()
    assert isinstance(fused, FusedTransformerOperator)
    assert fused.label == "Fused[RandomSignNode+LinearRectifier+NormalizeRows]"
    assert fitted.fused() is fitted  # nothing left to fuse
    with fusion_disabled():
        unfused = chain.fit()
    assert len(unfused.graph.operators) == 3 and unfused.fused() is not unfused
    assert torch.equal(fitted.apply_batch(x).data, unfused.apply_batch(x).data)


def test_solver_mode_env_precedence_and_thread_local_scope(monkeypatch):
    from keystone_tpu_torch.parallel import linalg

    monkeypatch.delenv("KEYSTONE_SOLVER_PRECISION", raising=False)
    assert linalg.solver_mode() == "refine"
    seen = {}
    with linalg.solver_mode_scope("highest"):
        assert linalg.solver_mode() == "highest"
        other = threading.Thread(target=lambda: seen.setdefault("mode", linalg.solver_mode()))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", "HIGH")  # the env var wins
        assert linalg.solver_mode() == "high"
        monkeypatch.delenv("KEYSTONE_SOLVER_PRECISION")
    assert seen["mode"] == "refine"  # the scope never leaks to another thread
    assert linalg.solver_mode() == "refine"
    with linalg.solver_mode_scope(None):
        assert linalg.solver_mode() == "refine"
    with pytest.raises(ValueError, match="expected one of"):
        linalg.set_solver_mode_override("fast")
    monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", "typo")
    with pytest.raises(ValueError, match="KEYSTONE_SOLVER_PRECISION"):
        linalg.solver_mode()


def test_estimator_execute_scopes_its_solver_precision():
    from keystone_tpu_torch.parallel import linalg

    seen = []

    class Pinned(Estimator):
        solver_precision = "highest"

        def fit(self, data):
            seen.append(linalg.solver_mode())
            return Plus(0)

    Pinned().with_data(ObjectDataset([1.0]))(ObjectDataset([0.0])).get()
    assert seen == ["highest"] and linalg.solver_mode() == "refine"


def test_gram_stream_step_accumulates_in_place_and_solvers_agree_with_float64():
    from keystone_tpu_torch.parallel import linalg

    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 7)).astype(np.float32) + 3.0
    y = rng.normal(size=(300, 2)).astype(np.float32)
    carry = linalg.gram_stream_init(7, 2, CPU)
    ids = [id(t) for t in carry]
    for s in range(0, 300, 128):
        out = linalg.gram_stream_step(carry, torch.from_numpy(x[s : s + 128]), torch.from_numpy(y[s : s + 128]))
        assert out is carry and [id(t) for t in out] == ids
    gc, cc, _, _ = linalg.gram_stream_finish(carry, 300)
    xd, yd = x.astype(np.float64), y.astype(np.float64)
    xc, yc = xd - xd.mean(0), yd - yd.mean(0)
    want = np.linalg.solve(xc.T @ xc + 0.5 * np.eye(7), xc.T @ yc)
    w_stream = linalg.solve_from_gram(gc, cc, reg=0.5).numpy()
    for steps in (0, 2):
        w, mu_a, mu_b = linalg.centered_solve_refined(
            torch.from_numpy(x), torch.from_numpy(y), 300, 0.5, refine_steps=steps
        )
        assert np.linalg.norm(w.numpy() - want) / np.linalg.norm(want) <= 1e-5
        np.testing.assert_allclose(mu_a.numpy(), xd.mean(0), rtol=1e-5)
    assert np.linalg.norm(w_stream - want) / np.linalg.norm(want) <= 1e-5
    with pytest.raises(FloatingPointError, match="reg > 0"):
        linalg.check_finite(torch.tensor([1.0, float("nan")]), "test")
