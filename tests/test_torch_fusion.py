"""Whole-pipeline fusion in the port (``keystone_tpu_torch/workflow/fusion.py``),
on the CPU: chain detection, boundaries, parity, dispatch accounting,
serialization and serving — mirrors of the JAX package's
``tests/workflow/test_fusion.py`` — and parity with the JAX package.

Mirrors left out, and why:

- ``test_parity_cifar_patch_chain``: ``ops/images`` is not ported yet.
- ``test_autocache_decisions_identical_with_fusion_on`` and the
  ``auto_caching_optimizer`` half of the batch-order test: autocache is
  not ported yet.
- The checkpoint door of the registry test: ``load_checkpoint`` is not
  ported yet.
- ``test_untraceable_member_falls_back_to_eager``: the port traces
  nothing, so it has no eager fallback; replaced by
  ``test_member_error_propagates_and_chain_stays_fused``.

Tolerances: fused and unfused runs execute the same kernels in the same
order, so the port's own parity is held at the JAX test's bounds (which
they meet exactly); JAX-vs-port parity at 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import names as _names
from keystone_tpu_torch.ops.util.misc import CacherOperator
from keystone_tpu_torch.workflow import (
    BatchTransformer,
    FittedPipeline,
    FusedTransformerOperator,
    Pipeline,
    fuse_graph,
    fusion_disabled,
)
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.fusion import NodeFusionRule, is_fusable
from keystone_tpu_torch.workflow.rules import default_optimizer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


class Scale(BatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    @property
    def label(self):
        return f"Scale[{self.c}]"

    def apply_arrays(self, x):
        return x * self.c


class Shift(BatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    @property
    def label(self):
        return f"Shift[{self.c}]"

    def apply_arrays(self, x):
        return x + self.c


class CustomBatch(BatchTransformer):
    """Overrides apply_batch → must never fuse."""

    def apply_arrays(self, x):
        return x

    def apply_batch(self, dataset):
        return dataset


def _cpu(a):
    return ArrayDataset(np.asarray(a, np.float32), device=CPU)


def _chain(*ops):
    pipe = ops[0].to_pipeline()
    for op in ops[1:]:
        pipe = pipe.then(op)
    return pipe


def _append_operator(pipe, op):
    """Append a bare TransformerOperator (e.g. a CacherOperator) to a
    pipeline's sink by direct graph surgery."""
    graph = pipe.graph
    graph, node = graph.add_node(op, [graph.get_sink_dependency(pipe.sink)])
    graph = graph.set_sink_dependency(pipe.sink, node)
    return Pipeline(graph, pipe.source, pipe.sink)


def _fused_ops(graph):
    return [op for op in graph.operators.values() if isinstance(op, FusedTransformerOperator)]


def _dispatch_counts():
    c = _names.metric(_names.FUSION_BATCH_DISPATCHES)
    return c.value(fused="1"), c.value(fused="0")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


x4 = np.arange(24, dtype=np.float32).reshape(4, 6)


# ----------------------------------------------------------------- structure


def test_four_node_chain_fuses_to_one_node():
    pipe = _chain(Scale(2), Shift(1), Scale(3), Shift(-2))
    res = pipe(_cpu(x4))
    res.get()
    graph = res._executor.graph
    fused = _fused_ops(graph)
    assert len(fused) == 1
    assert fused[0].member_labels == ("Scale[2.0]", "Shift[1.0]", "Scale[3.0]", "Shift[-2.0]")
    assert len(graph.nodes) == 2  # the dataset node and the fused node


def test_fusion_rule_is_in_default_optimizer():
    names = [b.name for b in default_optimizer().batches]
    assert names[-2:] == ["fusion", "streaming"]


def test_cacher_is_a_fusion_boundary():
    pipe = _append_operator(_chain(Scale(2), Shift(1)), CacherOperator())
    pipe = pipe.then(Scale(3)).then(Shift(4))
    fused_graph = fuse_graph(pipe.graph)
    fused = _fused_ops(fused_graph)
    assert sorted(f.member_labels for f in fused) == [
        ("Scale[2.0]", "Shift[1.0]"),
        ("Scale[3.0]", "Shift[4.0]"),
    ]
    assert any(isinstance(op, CacherOperator) for op in fused_graph.operators.values())


def test_prefix_marked_node_is_not_fused():
    pipe = _chain(Scale(2), Shift(1), Scale(3))
    graph = pipe.graph
    middle = next(n for n in graph.nodes if graph.get_operator(n).label == "Shift[1.0]")
    out, _ = NodeFusionRule().apply(graph, {middle: object()})
    assert _fused_ops(out) == []
    assert middle in out.nodes


def test_branch_point_cuts_chain():
    """A node consumed by two downstream nodes stays a node of its own."""
    pipe_a = Scale(2).to_pipeline()
    gathered = Pipeline.gather([pipe_a.then(Shift(1)).then(Scale(5)), pipe_a.then(Shift(3))])
    res = gathered(_cpu(x4))
    got = res.get()
    for fused in _fused_ops(res._executor.graph):
        assert "Scale[2.0]" not in fused.member_labels
    PipelineEnv.reset()
    with fusion_disabled():
        ref = gathered(_cpu(x4)).get()
    for g, r in zip(got.data, ref.data):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=0)


def test_bespoke_apply_batch_is_not_fusable():
    assert is_fusable(Scale(2))
    assert not is_fusable(CustomBatch())  # overrides apply_batch
    assert not is_fusable(CacherOperator())  # not a BatchTransformer
    from keystone_tpu_torch.ops.util.vectors import VectorCombiner

    assert not is_fusable(VectorCombiner())  # overrides apply


def test_fusable_opt_out_flag():
    class OptedOut(Scale):
        fusable = False

    out = fuse_graph(_chain(OptedOut(2), Shift(1), Scale(3)).graph)
    (fused,) = _fused_ops(out)
    assert fused.member_labels == ("Shift[1.0]", "Scale[3.0]")


def test_nested_fusion_flattens():
    inner = FusedTransformerOperator([Scale(2), Shift(1)])
    outer = FusedTransformerOperator([inner, Scale(3)])
    assert outer.member_labels == ("Scale[2.0]", "Shift[1.0]", "Scale[3.0]")
    with pytest.raises(ValueError, match=">= 2 members"):
        FusedTransformerOperator([Scale(2)])


# --------------------------------------------------------------------- parity


def _parity(pipe, data, rel=1e-5):
    PipelineEnv.reset()
    got = pipe(data).get()
    PipelineEnv.reset()
    with fusion_disabled():
        ref = pipe(data).get()
    err = _rel(got.data, ref.data)
    assert err <= rel, f"fused vs unfused rel_err {err}"
    return got


def test_parity_mnist_fft_featurizer():
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_featurizer

    featurizer = build_featurizer(MnistRandomFFTConfig(num_ffts=2), image_size=64, device=CPU)
    x = np.random.default_rng(0).normal(size=(16, 64)).astype(np.float32)
    res = featurizer(_cpu(x))
    res.get()
    assert len(_fused_ops(res._executor.graph)) == 2
    _parity(featurizer, _cpu(x))


def test_parity_with_cacher_boundary():
    pipe = _append_operator(_chain(Scale(2), Shift(1)), CacherOperator())
    pipe = pipe.then(Scale(0.5)).then(Shift(-3))
    _parity(pipe, _cpu(x4), rel=1e-6)


def test_parity_padded_rows_stay_zero():
    """Pad-row re-zeroing once at the end equals once per member."""
    data = ArrayDataset(np.ones((6, 4), np.float32), num_examples=4, device=CPU)
    pipe = _chain(Shift(2), Scale(3), Shift(-1))
    out = pipe(data).get()
    assert out.num_examples == 4
    assert torch.equal(out.data[4:], torch.zeros(2, 4))
    PipelineEnv.reset()
    with fusion_disabled():
        ref = pipe(data).get()
    torch.testing.assert_close(out.data, ref.data, rtol=1e-6, atol=0)


# ---------------------------------------------------------- dispatch counting


def test_four_node_chain_is_exactly_one_dispatch():
    pipe = _chain(Scale(2), Shift(1), Scale(3), Shift(-2))
    data = _cpu(np.ones((4, 6)))

    before_f, before_u = _dispatch_counts()
    pipe(data).get()
    after_f, after_u = _dispatch_counts()
    assert after_f - before_f == 1, "a fused chain is one batch application"
    assert after_u - before_u == 0

    PipelineEnv.reset()
    with fusion_disabled():
        before_f, before_u = _dispatch_counts()
        pipe(data).get()
        after_f, after_u = _dispatch_counts()
    assert after_f - before_f == 0
    assert after_u - before_u == 4, "an unfused chain is one application per node"


def test_fused_chain_compiles_once():
    """The compile counter counts a chain's first application at a new
    input shape: once for a fresh shape, then never in steady state."""
    compiles = _names.metric(_names.FUSION_COMPILES)
    fitted = _chain(Scale(7), Shift(2), Scale(0.5), Shift(1)).fit()
    assert len(_fused_ops(fitted.graph)) == 1
    before = compiles.total()
    fitted.apply_batch(_cpu(np.ones((5, 11))))
    assert compiles.total() - before == 1
    before = compiles.total()
    fitted.apply_batch(_cpu(np.ones((5, 11))))
    assert compiles.total() - before == 0


def test_fusion_metrics_move():
    before = {
        name: _names.metric(name).total()
        for name in (
            _names.FUSION_CHAINS, _names.FUSION_FUSED_NODES,
            _names.FUSION_DISPATCHES_SAVED, _names.FUSION_COMPILES,
        )
    }
    _chain(Scale(2), Shift(1), Scale(3))(_cpu(np.ones((3, 9)))).get()
    moved = {name: _names.metric(name).total() - value for name, value in before.items()}
    assert moved[_names.FUSION_CHAINS] == 1
    assert moved[_names.FUSION_FUSED_NODES] == 3
    assert moved[_names.FUSION_DISPATCHES_SAVED] == 2
    assert moved[_names.FUSION_COMPILES] >= 1


def test_repeated_unfitted_apply_shares_one_compiled_chain():
    """Every optimizer run builds a fresh FusedTransformerOperator, but
    chains over the same member instances share one record of the shapes
    seen: re-applying an unfitted pipeline counts no new first
    application."""
    compiles = _names.metric(_names.FUSION_COMPILES)
    pipe = _chain(Scale(1.5), Shift(2), Scale(3))
    pipe(_cpu(np.ones((6, 7)))).get()
    before = compiles.total()
    for _ in range(3):
        PipelineEnv.reset()
        pipe(_cpu(np.ones((6, 7)))).get()
    assert compiles.total() - before == 0


def test_member_error_propagates_and_chain_stays_fused():
    """No ``try`` unfuses a chain: a member raising inside the fused call
    propagates, the operator stays fused, and the next valid batch runs
    through the same fused operator."""

    class FailsOnNegative(Scale):
        def apply_arrays(self, x):
            if bool((x < 0).any()):
                raise RuntimeError("negative input")
            return x * self.c

    fitted = _chain(Shift(1), FailsOnNegative(2)).fit()
    (fused,) = _fused_ops(fitted.graph)
    with pytest.raises(RuntimeError, match="negative input"):
        fitted.apply_batch(_cpu(-5 * np.ones((3, 4))))
    assert _fused_ops(fitted.graph) == [fused]
    before_f, before_u = _dispatch_counts()
    out = fitted.apply_batch(_cpu(np.ones((3, 4))))
    torch.testing.assert_close(out.data, torch.full((3, 4), 4.0))
    assert _dispatch_counts() == (before_f + 1, before_u)


def test_runtime_errors_propagate_without_unfusing():
    class Boom(Scale):
        def apply_arrays(self, x):
            raise RuntimeError("device exploded")

    fitted = _chain(Scale(2), Boom(1)).fit()
    (fused,) = _fused_ops(fitted.graph)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device exploded"):
            fitted.apply_batch(_cpu(np.ones((3, 4))))
    assert isinstance(fused, FusedTransformerOperator) and _fused_ops(fitted.graph) == [fused]


# -------------------------------------------------------------- serialization


def test_fused_fitted_pipeline_pickles(tmp_path):
    fitted = _chain(Scale(2), Shift(1), Scale(3)).fit()
    assert len(_fused_ops(fitted.graph)) == 1
    path = str(tmp_path / "fused.pt")
    fitted.save(path)
    loaded = FittedPipeline.load(path, device="cpu")
    assert len(_fused_ops(loaded.graph)) == 1
    assert torch.equal(loaded.apply_batch(_cpu(x4)).data, fitted.apply_batch(_cpu(x4)).data)


def test_registry_refuses_nothing_and_refuses_loaded_artifacts(tmp_path):
    """Artifacts saved UNFUSED are re-fused by the serving registry."""
    from keystone_tpu_torch.serving.registry import ModelRegistry

    with fusion_disabled():
        fitted = _chain(Scale(2), Shift(1), Scale(3)).fit()
    assert _fused_ops(fitted.graph) == []
    path = str(tmp_path / "unfused.pt")
    fitted.save(path)
    entry = ModelRegistry().load_fitted("m", path, device="cpu")
    assert len(_fused_ops(entry.model.graph)) == 1
    out = entry.batch_apply(_cpu(x4))
    torch.testing.assert_close(out.data, fitted.apply_batch(_cpu(x4)).data, rtol=1e-6, atol=0)


# ------------------------------------------------------------------- serving


def test_serving_zero_compiles_after_warmup_with_fusion():
    """Warmup applies the fused chain at every bucket; afterwards every
    batch lands on a warm bucket, so the fused chain sees no new shape."""
    from keystone_tpu_torch.serving import PipelineServer, ServingConfig
    from keystone_tpu_torch.serving.synthetic import synthetic_chain_pipeline, synthetic_requests

    d = 16
    fitted = synthetic_chain_pipeline(num_nodes=4, d=d, fused=True, device=CPU)
    assert len(_fused_ops(fitted.graph)) == 1
    compiles = _names.metric(_names.FUSION_COMPILES)
    server = PipelineServer(
        fitted, config=ServingConfig(max_batch=4, max_wait_ms=1.0, queue_depth=64), device=CPU
    ).start()
    try:
        server.warmup(np.zeros((d,), np.float32))
        before = compiles.total()
        for f in server.submit_many(synthetic_requests(24, d=d)):
            f.result(timeout=30)
        stats = server.stats()
    finally:
        server.stop()
    assert stats["served"] == 24
    assert compiles.total() - before == 0


def test_synthetic_chain_fused_unfused_parity():
    from keystone_tpu_torch.serving.synthetic import synthetic_chain_pipeline

    d = 8
    x = np.random.default_rng(3).normal(size=(5, d)).astype(np.float32)
    fused = synthetic_chain_pipeline(num_nodes=5, d=d, seed=7, fused=True, device=CPU)
    unfused = synthetic_chain_pipeline(num_nodes=5, d=d, seed=7, fused=False, device=CPU)
    assert len(_fused_ops(fused.graph)) == 1
    assert _fused_ops(unfused.graph) == []
    a = fused.apply_batch(_cpu(x)).data
    b = unfused.apply_batch(_cpu(x)).data
    assert _rel(a, b) <= 1e-5


# ------------------------------------------------------- parity with the JAX package


def test_synthetic_chain_matches_jax():
    from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.serving.synthetic import synthetic_chain_pipeline as jchain
    from keystone_tpu_torch.serving.synthetic import synthetic_chain_pipeline

    d = 16
    x = np.random.default_rng(5).normal(size=(9, d)).astype(np.float32)
    j = np.asarray(jchain(num_nodes=4, d=d, seed=2).apply_batch(JArrayDataset(x)).data)
    t = synthetic_chain_pipeline(num_nodes=4, d=d, seed=2, device=CPU).apply_batch(_cpu(x)).data
    assert _rel(t, j) <= 1e-5


def _sorted_labels(graph):
    return sorted(str(op.label) for op in graph.operators.values())


def test_mnist_optimized_plan_matches_jax():
    """The same MNIST pipeline (1,024 rows, 2 FFTs) gives the same
    optimized fit graph and fitted graph in both packages: one fused
    sign → FFT → ReLU node per branch on each side of the fit, no
    StreamFit node (the estimator's input is a VectorCombiner, which is
    not fusable)."""
    from keystone_tpu.pipelines import mnist_random_fft as jm
    from keystone_tpu.workflow.executor import PipelineEnv as JPipelineEnv
    from keystone_tpu_torch.pipelines import mnist_random_fft as tm

    def plans(pipe, env):
        optimized, _ = env.optimizer.execute(pipe.graph)
        return _sorted_labels(optimized), _sorted_labels(pipe.fit().graph)

    JPipelineEnv.reset()
    try:
        jcfg = jm.MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=10.0)
        j_plans = plans(jm.build_pipeline(jcfg, jm.synthetic_mnist(1024)), JPipelineEnv.get_or_create())
    finally:
        JPipelineEnv.reset()
    tcfg = tm.MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=10.0)
    train = tm.synthetic_mnist(1024, device=CPU)
    t_plans = plans(tm.build_pipeline(tcfg, train, device=CPU), PipelineEnv.get_or_create())
    assert t_plans == j_plans
    fused = "Fused[RandomSignNode+PaddedFFT+LinearRectifier]"
    assert t_plans[0].count(fused) == 4 and not any("StreamFit" in s for s in t_plans[0])
    assert t_plans[1].count(fused) == 2 and "Fused[BlockLinearMapper+MaxClassifier]" in t_plans[1]


def test_mnist_fused_scores_equal_unfused():
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
    from keystone_tpu_torch.pipelines import mnist_random_fft as tm

    cfg = tm.MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=10.0)
    train = tm.synthetic_mnist(1024, seed=0, device=CPU)
    test = tm.synthetic_mnist(256, seed=1, device=CPU)

    def fit_scores():
        PipelineEnv.reset()
        fitted = tm.build_pipeline(cfg, train, device=CPU).fit()
        members = [m for op in fitted.graph.operators.values() for m in getattr(op, "members", (op,))]
        (mapper,) = [m for m in members if isinstance(m, BlockLinearMapper)]
        features = tm.build_featurizer(cfg, device=CPU)(test.data).get().data
        return fitted, mapper.apply_arrays(features), fitted.apply_batch(test.data).data

    fused, s_fused, p_fused = fit_scores()
    with fusion_disabled():
        unfused, s_unfused, p_unfused = fit_scores()
    assert _fused_ops(fused.graph) and not _fused_ops(unfused.graph)
    assert _rel(s_fused, s_unfused) <= 1e-6
    assert torch.equal(p_fused, p_unfused)
