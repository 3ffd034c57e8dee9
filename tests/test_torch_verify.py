"""The plan-time graph verifier in the port (``keystone_tpu_torch/workflow/
verify.py``), on the CPU: every case of the JAX package's
``tests/workflow/test_verify.py``, each built in both packages from the
same numpy inputs and held to the same codes, severities, node ids,
rendered specs and ``ok``; the port's ``out_spec``s against the JAX
package's at the same input specs; the ``meta`` tracer's KV101 / KV402
line; the wrappers' ``meta`` branches; and the fit and load hooks.

Where the two packages really read a case differently, the test states
both readings and the reason:

- ``test_no_widening_diag_on_float64_source_data``: the JAX package's
  ``ArrayDataset`` keeps a float64 numpy array as it is, the port's
  narrows it to float32 (its transfer rule), so the source nodes render
  ``(16, 4):float64`` against ``(16, 4):float32``. The codes agree (no
  KV102 in either).
- The zero-compile test becomes ``test_verification_launches_and_allocates_nothing``:
  the port compiles nothing, so it counts what it could do on the card
  instead — ELL launches, binding calls, cost facts — and the fused
  chains' first-application counter.
- KV203 and KV304 come from each package's partitioner, which reads its
  ambient mesh: the JAX package's test mesh has 8 devices, the port's
  default mesh one shard. The summaries leave those two codes out of
  both reports (and ``ok`` is read without them); the tests that compare
  whole diagnostic lists build the port's report on an 8-shard CPU mesh,
  and ``tests/test_torch_partition.py`` holds the codes themselves.
- ``test_docs_codes_sync`` becomes ``test_code_tables_equal_the_jax_packages``:
  the port has no ``docs/``; its tables must equal the JAX package's
  (the lint table without KV505, which the port leaves out).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.workflow import BatchTransformer as JBatchTransformer
from keystone_tpu.workflow import verify as jverify
from keystone_tpu.workflow.pipeline import Estimator as JEstimator
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import names as _names
from keystone_tpu_torch.ops.cuda import blocksparse, gemm
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.ops.learning.logistic import LogisticRegressionEstimator
from keystone_tpu_torch.workflow import BatchTransformer
from keystone_tpu_torch.workflow.analysis import GraphCycleError, linearize_whole
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.operators import EstimatorOperator
from keystone_tpu_torch.workflow.pipeline import Estimator
from keystone_tpu_torch.workflow.verify import (
    CODES,
    ERROR,
    INFO,
    UNKNOWN,
    WARNING,
    SpecMismatch,
    TensorSpec,
    TransformerSpec,
    VerificationError,
    dense_fit_spec,
    elementwise_fit_spec,
    is_shape_error,
    projection_fit_spec,
    spec_leaf,
    verification_mode,
    verify_and_enforce,
    verify_graph,
    verify_pipeline,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


# ------------------------------------------------------------ both packages


class Scale(BatchTransformer):
    def __init__(self, c=2.0):
        self.c = float(c)

    @property
    def label(self):
        return f"Scale[{self.c}]"

    def apply_arrays(self, x):
        return x * self.c


class JScale(JBatchTransformer):
    def __init__(self, c=2.0):
        self.c = float(c)

    @property
    def label(self):
        return f"Scale[{self.c}]"

    def apply_arrays(self, x):
        return x * self.c


class ScaleWithSpec(Scale):
    """Same op, explicit out_spec — for fallback-parity assertions."""

    def out_spec(self, in_specs):
        spec = in_specs[0]
        if not isinstance(spec, torch.Tensor):
            return UNKNOWN
        return spec


class WidenToF64(BatchTransformer):
    """Declares (via out_spec) that it emits float64."""

    @property
    def label(self):
        return "WidenToF64"

    def apply_arrays(self, x):  # pragma: no cover - never executed here
        return x

    def out_spec(self, in_specs):
        return spec_leaf(tuple(in_specs[0].shape), torch.float64)


class JWidenToF64(JBatchTransformer):
    @property
    def label(self):
        return "WidenToF64"

    def apply_arrays(self, x):  # pragma: no cover - never executed here
        return x

    def out_spec(self, in_specs):
        leaf = jax.tree_util.tree_leaves(in_specs[0])[0]
        return jax.ShapeDtypeStruct(tuple(leaf.shape), np.float64)


class CustomBatch(BatchTransformer):
    """Bespoke apply_batch → fusion-ineligible (KV201)."""

    @property
    def label(self):
        return "CustomBatch"

    def apply_arrays(self, x):
        return x

    def apply_batch(self, dataset):
        return dataset


class JCustomBatch(JBatchTransformer):
    @property
    def label(self):
        return "CustomBatch"

    def apply_arrays(self, x):
        return x

    def apply_batch(self, dataset):
        return dataset


class NoSpecEstimator(Estimator):
    """An estimator family that has not adopted the out_spec protocol."""

    @property
    def label(self):
        return "NoSpecEstimator"

    def fit(self, data):  # pragma: no cover - never executed here
        raise AssertionError("verification must not fit")


class JNoSpecEstimator(JEstimator):
    @property
    def label(self):
        return "NoSpecEstimator"

    def fit(self, data):  # pragma: no cover - never executed here
        raise AssertionError("verification must not fit")


def _xy(n=64, d=8, k=3, rows_y=None, dtype=np.float32):
    x = np.zeros((n, d), dtype=dtype)
    y = np.zeros((rows_y or n, k), dtype=dtype)
    return ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)


def _jxy(n=64, d=8, k=3, rows_y=None, dtype=np.float32):
    return (
        JArrayDataset(np.zeros((n, d), dtype=dtype)),
        JArrayDataset(np.zeros((rows_y or n, k), dtype=dtype)),
    )


def _linear_pair(**shape):
    from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinearMapEstimator

    x, y = _xy(**shape)
    jx, jy = _jxy(**shape)
    return LinearMapEstimator(device=CPU).with_data(x, y), JLinearMapEstimator().with_data(jx, jy)


#: The partitioner's codes: they read the ambient mesh, 8 devices in the
#: JAX package's tests and one shard by default in the port.
PARTITION_CODES = ("KV203", "KV304")


def _on_8_shards(fn, *args, **kwargs):
    """``fn`` under an 8-shard CPU mesh: the JAX package's test mesh."""
    from keystone_tpu_torch.parallel.mesh import make_mesh, use_mesh

    with use_mesh(make_mesh(devices=[CPU] * 8)):
        return fn(*args, **kwargs)


def _summary(report, specs=True):
    """What the two packages' reports must agree on, the partitioner's
    codes left out of both."""
    diagnostics = [d for d in report.diagnostics if d.code not in PARTITION_CODES]
    out = {
        "ok": not any(d.severity == ERROR for d in diagnostics),
        "diagnostics": [
            (d.code, d.severity, d.node, tuple(sorted((k, repr(v)) for k, v in d.details.items())))
            for d in diagnostics
        ],
    }
    out["nodes"] = [(a.node, a.label, a.spec if specs else None, a.est_bytes if specs else None)
                    for a in report.annotations]
    return out


def _codes(report):
    return [d.code for d in report.diagnostics]


def _jspec(shape, dtype="float32"):
    return jax.ShapeDtypeStruct(tuple(shape), np.dtype(dtype))


# ------------------------------------------------------------- diagnostics


def test_row_mismatch_is_kv101_error():
    pipe, jpipe = _linear_pair(n=64, rows_y=32)
    report = _on_8_shards(verify_pipeline, pipe)
    kv101 = report.by_code("KV101")
    assert len(kv101) == 1 and kv101[0].severity == ERROR
    assert "64 rows" in kv101[0].message and "32 rows" in kv101[0].message
    assert not report.ok
    jreport = jverify.verify_pipeline(jpipe)
    assert _summary(report) == _summary(jreport)
    assert [d.message for d in report.diagnostics] == [d.message for d in jreport.diagnostics]


def test_clean_pipeline_verifies_ok():
    pipe, jpipe = _linear_pair()
    report = verify_pipeline(pipe)
    assert report.ok
    assert not report.by_code("KV101")
    # The fitted-transformer edge got a real spec, not UNKNOWN.
    assert any("TransformerSpec" in a.spec for a in report.annotations)
    assert _summary(report) == _summary(jverify.verify_pipeline(jpipe))


def test_meta_fallback_catches_bad_width():
    """A fusable apply_arrays chain with no out_spec still verifies by
    running on ``meta`` — the planted-width CLI scenario (the JAX
    package's eval_shape fallback)."""
    from keystone_tpu.serving.synthetic import synthetic_chain_pipeline as jchain
    from keystone_tpu_torch.serving.synthetic import synthetic_chain_pipeline

    pipeline = synthetic_chain_pipeline(num_nodes=3, d=64, device=CPU)
    report = verify_pipeline(pipeline, TensorSpec((16, 63)))
    assert [d.code for d in report.errors()] == ["KV101"]
    good = verify_pipeline(pipeline, TensorSpec((16, 64), "float32"))
    assert good.ok
    jpipeline = jchain(num_nodes=3, d=64)
    jbad = jverify.verify_pipeline(jpipeline, _jspec((16, 63)))
    jgood = jverify.verify_pipeline(jpipeline, _jspec((16, 64)))
    assert _summary(good) == _summary(jgood)
    assert [(d.code, d.severity, d.node) for d in report.diagnostics] == [
        (d.code, d.severity, d.node) for d in jbad.diagnostics
    ]
    assert [a.spec for a in report.annotations] == [a.spec for a in jbad.annotations]


def test_meta_fallback_matches_explicit_out_spec():
    """The same op with and without out_spec annotates the same
    propagated spec."""
    spec = TensorSpec((32, 4))

    def annotations(op):
        report = verify_pipeline(op.to_pipeline(), spec)
        assert report.ok
        return [a.spec for a in report.annotations]

    assert annotations(Scale(3.0)) == annotations(ScaleWithSpec(3.0)) == ["(32, 4):float32"]


def test_float64_widening_is_kv102_warning():
    pipe = Scale(1.0).to_pipeline().then(WidenToF64())
    report = verify_pipeline(pipe, TensorSpec((8, 4), torch.float32))
    kv102 = report.by_code("KV102")
    assert len(kv102) == 1 and kv102[0].severity == WARNING
    assert report.ok  # warning, not error
    jpipe = JScale(1.0).to_pipeline().then(JWidenToF64())
    assert _summary(report) == _summary(jverify.verify_pipeline(jpipe, _jspec((8, 4))))


def test_no_widening_diag_when_input_already_f64():
    report = verify_pipeline(WidenToF64().to_pipeline(), TensorSpec((8, 4), "float64"))
    assert not report.by_code("KV102")
    jreport = jverify.verify_pipeline(JWidenToF64().to_pipeline(), _jspec((8, 4), "float64"))
    assert _summary(report) == _summary(jreport)


def test_no_widening_diag_on_float64_source_data():
    """A dataset that simply IS float64 widened nothing. The JAX package
    keeps the float64 array and renders its source (16, 4):float64; the
    port's ArrayDataset narrows host float64 to float32 on the way in
    (the transfer rule), so its source renders (16, 4):float32. Both
    give no KV102 and the same codes."""
    pipe, jpipe = _linear_pair(n=16, d=4, k=2, dtype=np.float64)
    report = verify_pipeline(pipe)
    jreport = jverify.verify_pipeline(jpipe)
    assert not report.by_code("KV102") and not jreport.by_code("KV102")
    assert _summary(report, specs=False) == _summary(jreport, specs=False)
    assert [a.spec for a in jreport.annotations][:2] == ["(16, 4):float64", "(16, 2):float64"]
    assert [a.spec for a in report.annotations][:2] == ["(16, 4):float32", "(16, 2):float32"]


def test_dense_fit_spec_carries_training_float64():
    """An estimator fitted on float64 produces a float64 map even for
    float32 apply inputs — the captured training dtype participates."""
    ts = dense_fit_spec([TensorSpec((10, 4), torch.float64).meta(), TensorSpec((10, 2), "float64").meta()], "T")
    out = ts.apply_spec(spec_leaf((3, 4), torch.float32))
    assert out.dtype == torch.float64 and out.device.type == "meta"


def test_fusion_ineligibility_reasons():
    from keystone_tpu.ops.util.misc import CacherOperator as JCacherOperator
    from keystone_tpu_torch.ops.util.misc import CacherOperator

    def build(scale, custom, cacher):
        pipe = scale(2.0).to_pipeline().then(custom())
        graph = pipe.graph
        graph, node = graph.add_node(cacher(), [graph.get_sink_dependency(pipe.sink)])
        return graph.set_sink_dependency(pipe.sink, node)

    report = verify_graph(build(Scale, CustomBatch, CacherOperator))
    reasons = {d.details.get("reason") for d in report.by_code("KV201")}
    assert {"bespoke-apply", "cacher-boundary"} <= reasons
    assert all(d.severity == INFO for d in report.by_code("KV201"))
    jreport = jverify.verify_graph(build(JScale, JCustomBatch, JCacherOperator))
    assert _summary(report) == _summary(jreport)


def test_multi_consumer_interior_reported():
    def build(scale):
        pipe = scale(2.0).to_pipeline()
        graph = pipe.graph
        head = graph.get_sink_dependency(pipe.sink)
        graph, n2 = graph.add_node(scale(3.0), [head])
        graph, n3 = graph.add_node(scale(4.0), [head])
        graph, _s2 = graph.add_sink(n2)
        graph, _s3 = graph.add_sink(n3)
        return graph

    report = verify_graph(build(Scale))
    assert "multi-consumer" in {d.details.get("reason") for d in report.by_code("KV201")}
    assert _summary(report) == _summary(jverify.verify_graph(build(JScale)))


def test_streaming_ineligibility_reasons():
    from keystone_tpu.ops.learning.logistic import LogisticRegressionEstimator as JLogistic

    pipe, jpipe = _linear_pair(n=64)
    report = verify_pipeline(pipe)
    kv202 = report.by_code("KV202")
    assert len(kv202) == 1 and kv202[0].details["reason"] == "below-row-floor"
    assert _summary(report) == _summary(jverify.verify_pipeline(jpipe))

    xl = np.zeros((64, 8), dtype=np.float32)
    yl = np.zeros((64,), dtype=np.int32)
    report = verify_pipeline(
        LogisticRegressionEstimator(num_classes=3, device=CPU).with_data(
            ArrayDataset(xl, device=CPU), ArrayDataset(yl, device=CPU)
        )
    )
    kv202 = report.by_code("KV202")
    assert len(kv202) == 1 and kv202[0].details["reason"] == "no-fit-stream"
    jreport = jverify.verify_pipeline(JLogistic(num_classes=3).with_data(JArrayDataset(xl), JArrayDataset(yl)))
    assert _summary(report) == _summary(jreport)


def test_bucket_mismatch_is_kv301_error():
    from keystone_tpu.serving.synthetic import synthetic_chain_pipeline as jchain
    from keystone_tpu_torch.serving.synthetic import synthetic_chain_pipeline

    pipeline = synthetic_chain_pipeline(num_nodes=2, d=64, device=CPU)
    report = verify_pipeline(pipeline, buckets=[8, 32], warmed_buckets=[8])
    kv301 = report.by_code("KV301")
    assert len(kv301) == 1 and kv301[0].severity == ERROR
    assert kv301[0].details == {"missing": [32], "warmed": [8]}
    assert verify_pipeline(pipeline, buckets=[8, 32], warmed_buckets=[8, 32, 64]).ok
    jreport = jverify.verify_pipeline(jchain(num_nodes=2, d=64), buckets=[8, 32], warmed_buckets=[8])
    assert _summary(report) == _summary(jreport)


def test_peak_memory_budget_is_kv302_warning():
    pipe, jpipe = _linear_pair(n=4096, d=64)
    report = verify_pipeline(pipe, device_memory_bytes=10_000)
    kv302 = report.by_code("KV302")
    assert len(kv302) == 1 and kv302[0].severity == WARNING
    assert kv302[0].details["peak_bytes"] > 10_000
    assert verify_pipeline(pipe, device_memory_bytes=None).by_code("KV302") == []
    assert _summary(report) == _summary(jverify.verify_pipeline(jpipe, device_memory_bytes=10_000))


def _stream_graph(pipe, streaming_cls):
    graph = pipe.graph
    est_node = next(
        n
        for n in graph.nodes
        if isinstance(graph.get_operator(n), (EstimatorOperator, jverify.EstimatorOperator))
        and not hasattr(graph.get_operator(n), "dataset")
    )
    return graph.set_operator(est_node, streaming_cls(graph.get_operator(est_node), members=()))


def test_gram_infeasibility_is_kv303():
    from keystone_tpu.workflow.streaming import StreamingFitOperator as JStreamingFitOperator
    from keystone_tpu_torch.workflow.streaming import StreamingFitOperator

    d = 4096
    pipe, jpipe = _linear_pair(n=8, d=d, k=4)
    graph = _stream_graph(pipe, StreamingFitOperator)
    # gram state ~2*4*(d² + d·k) ≈ 134 MB >> 1 MB budget
    report = verify_graph(graph, device_memory_bytes=1_000_000)
    kv303 = report.by_code("KV303")
    assert len(kv303) == 1 and kv303[0].details["d"] == d
    assert verify_graph(graph, device_memory_bytes=None).by_code("KV303") == []
    jreport = jverify.verify_graph(_stream_graph(jpipe, JStreamingFitOperator), device_memory_bytes=1_000_000)
    assert _summary(report) == _summary(jreport)


def test_sketch_infeasibility_is_kv308(monkeypatch):
    """The sketched tier's feasibility is KV308 (ERROR — it is the LAST
    memory rung) and the dispatch routes sketch-kind fits AWAY from the
    Gram tier's KV303 warning."""
    from keystone_tpu.sketch.solvers import SketchedLeastSquaresEstimator as JSketched
    from keystone_tpu.workflow.streaming import StreamingFitOperator as JStreamingFitOperator
    from keystone_tpu_torch.sketch.core import sketch_state_bytes
    from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator
    from keystone_tpu_torch.workflow.streaming import StreamingFitOperator

    d = 8192
    x, y = _xy(n=8, d=d, k=4)
    jx, jy = _jxy(n=8, d=d, k=4)

    def graphs():
        return (
            _stream_graph(SketchedLeastSquaresEstimator(reg=1e-3, device=CPU).with_data(x, y), StreamingFitOperator),
            _stream_graph(JSketched(reg=1e-3).with_data(jx, jy), JStreamingFitOperator),
        )

    # Conditioning floor: checked on ANY device (no budget needed).
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", "4")
    graph, jgraph = graphs()
    report = verify_graph(graph, device_memory_bytes=None)
    kv308 = report.by_code("KV308")
    assert len(kv308) == 1 and kv308[0].severity == ERROR
    assert kv308[0].details["floor"] == max(32, 4 * (4 + 1))
    assert _summary(report) == _summary(jverify.verify_graph(jgraph, device_memory_bytes=None))

    # Memory: 2× the O(s·d) carry vs the budget — and no KV303.
    monkeypatch.delenv("KEYSTONE_SKETCH_SIZE", raising=False)
    graph, jgraph = graphs()
    report = verify_graph(graph, device_memory_bytes=1_000_000)
    kv308 = report.by_code("KV308")
    assert len(kv308) == 1
    assert kv308[0].details["state_bytes"] == 2 * sketch_state_bytes(4096, d, 4)
    assert report.by_code("KV303") == []
    assert _summary(report) == _summary(jverify.verify_graph(jgraph, device_memory_bytes=1_000_000))

    # Feasible sketch plan: a budget the carry fits leaves no diagnostic.
    assert verify_graph(graphs()[0], device_memory_bytes=1 << 30).by_code("KV308") == []


def test_cycle_is_kv401_and_linearize_raises():
    def cyclic(scale):
        graph = scale(2.0).to_pipeline().then(scale(3.0)).then(scale(4.0)).graph
        nodes = sorted(graph.nodes)
        return graph.set_dependencies(nodes[0], [nodes[2]])

    graph = cyclic(Scale)
    with pytest.raises(GraphCycleError) as err:
        linearize_whole(graph)
    assert len(err.value.cycle) >= 3 and err.value.cycle[0] == err.value.cycle[-1]
    report = verify_graph(graph)
    assert [d.code for d in report.errors()] == ["KV401"]
    assert report.annotations == []  # propagation never ran
    jreport = jverify.verify_graph(cyclic(JScale))
    assert _summary(report) == _summary(jreport)
    assert report.diagnostics[0].message == jreport.diagnostics[0].message


def test_estimator_without_out_spec_is_kv402():
    report = verify_pipeline(NoSpecEstimator().with_data(ArrayDataset(np.zeros((16, 4), np.float32), device=CPU)))
    kv402 = [d for d in report.by_code("KV402") if "NoSpecEstimator" in d.message]
    assert len(kv402) == 1 and kv402[0].severity == INFO
    assert report.ok
    jreport = jverify.verify_pipeline(JNoSpecEstimator().with_data(JArrayDataset(np.zeros((16, 4), np.float32))))
    assert _summary(report) == _summary(jreport)


def test_broken_out_spec_never_kills_planning():
    class Broken(Scale):
        def out_spec(self, in_specs):
            raise RuntimeError("boom")

    class JBroken(JScale):
        def out_spec(self, in_specs):
            raise RuntimeError("boom")

    report = verify_pipeline(Broken(1.0).to_pipeline(), TensorSpec((4, 4)))
    assert report.ok
    assert any("out_spec failed" in d.message for d in report.by_code("KV402"))
    assert _summary(report) == _summary(jverify.verify_pipeline(JBroken(1.0).to_pipeline(), _jspec((4, 4))))


# -------------------------------------------------------- zero device work


def test_verification_launches_and_allocates_nothing():
    """Verification touches no kernel: the ELL wrapper's and the
    binding's counters, the cost observatory's facts and the fused
    chains' first-application counter all stay where they were, on plans
    whose nodes run products through both wrappers on ``meta``."""
    from keystone_tpu_torch.obs import cost
    from keystone_tpu_torch.serving.synthetic import synthetic_chain_pipeline

    fused = _names.metric(_names.FUSION_COMPILES)
    before = (blocksparse.ell_matmul.launches, dict(gemm.launches), fused.value())
    cost.set_cost_observatory(True)
    try:
        frame = cost.push_frame("verify-test")
        pipeline = synthetic_chain_pipeline(num_nodes=4, d=64, device=CPU)
        r1 = verify_pipeline(pipeline, TensorSpec((16, 63)))
        r2 = verify_pipeline(_linear_pair(n=128, rows_y=64)[0])
        r3 = verify_pipeline(BindingProduct(np.ones((8, 3), np.float32)).to_pipeline(), TensorSpec((16, 8)))
        notes = cost.pop_frame(frame)
    finally:
        cost.set_cost_observatory(False)
        cost.reset_cost_observatory()
    assert not r1.ok and not r2.ok and r3.ok
    assert [a.spec for a in r3.annotations] == ["(16, 3):float32"]
    assert (blocksparse.ell_matmul.launches, dict(gemm.launches), fused.value()) == before
    assert not getattr(notes, "launches", None)
    assert r1.seconds < 5.0 and r2.seconds < 1.0


class BindingProduct(BatchTransformer):
    """x @ w through the solver binding (``linalg.mm``) and back through
    the ELL wrapper's dense twin: a product on ``meta`` goes through both
    wrappers' shape rules."""

    def __init__(self, w):
        self.w = torch.from_numpy(w)

    def apply_arrays(self, x):
        from keystone_tpu_torch.parallel import linalg

        return linalg.mm(x, self.w)


# ------------------------------------------------------------- out_spec lib


def test_dense_fit_spec_contract():
    x, y = TensorSpec((100, 8)), TensorSpec((100, 3))
    ts = dense_fit_spec([x.meta(), y.meta()], "T")
    out = ts.apply_spec(spec_leaf((7, 8)))
    assert tuple(out.shape) == (7, 3) and out.dtype == torch.float32
    with pytest.raises(SpecMismatch):
        ts.apply_spec(spec_leaf((7, 9)))
    with pytest.raises(SpecMismatch):
        dense_fit_spec([spec_leaf((100,)), y.meta()], "T")
    with pytest.raises(SpecMismatch):
        dense_fit_spec([x.meta(), spec_leaf((99, 3))], "T")


def test_projection_and_elementwise_fit_specs():
    ts = projection_fit_spec([spec_leaf((10, 21, 128))], "PCA", dims=64)
    assert tuple(ts.apply_spec(spec_leaf((5, 33, 128))).shape) == (5, 33, 64)
    with pytest.raises(SpecMismatch):
        ts.apply_spec(spec_leaf((5, 127)))
    ts = elementwise_fit_spec([spec_leaf((10, 16))], "Scaler")
    assert tuple(ts.apply_spec(spec_leaf((3, 16))).shape) == (3, 16)
    with pytest.raises(SpecMismatch):
        ts.apply_spec(spec_leaf((3, 17)))


def _family():
    """(name, port estimator, JAX estimator, labels width or None): every
    estimator with an ``out_spec`` in the JAX package."""
    import keystone_tpu.ops.learning as jl
    import keystone_tpu_torch.ops.learning as tl
    from keystone_tpu.ops.stats.core import StandardScaler as JStandardScaler
    from keystone_tpu.sketch.solvers import SketchedLeastSquaresEstimator as JSketched
    from keystone_tpu_torch.ops.stats.core import StandardScaler
    from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator

    def pair(module, name, *args, **kw):
        import importlib

        t = getattr(importlib.import_module(f"keystone_tpu_torch.ops.learning.{module}"), name)
        j = getattr(importlib.import_module(f"keystone_tpu.ops.learning.{module}"), name)
        return t(*args, **kw), j(*args, **kw)

    del jl, tl
    return {
        "StandardScaler": ((StandardScaler(), JStandardScaler()), None),
        "NaiveBayesEstimator": (pair("naive_bayes", "NaiveBayesEstimator", 5), 1),
        "ZCAWhitenerEstimator": (pair("zca", "ZCAWhitenerEstimator"), None),
        "KMeansPlusPlusEstimator": (pair("kmeans", "KMeansPlusPlusEstimator", 5, 3), None),
        "LogisticRegressionEstimator": (pair("logistic", "LogisticRegressionEstimator", 4), 1),
        "PCAEstimator": (pair("pca", "PCAEstimator", 3), None),
        "DistributedPCAEstimator": (pair("pca", "DistributedPCAEstimator", 3), None),
        "ApproximatePCAEstimator": (pair("pca", "ApproximatePCAEstimator", 3), None),
        "LocalColumnPCAEstimator": (pair("pca", "LocalColumnPCAEstimator", 3), None),
        "DistributedColumnPCAEstimator": (pair("pca", "DistributedColumnPCAEstimator", 3), None),
        "ColumnPCAEstimator": (pair("pca", "ColumnPCAEstimator", 3), None),
        "BlockWeightedLeastSquaresEstimator": (pair("weighted", "BlockWeightedLeastSquaresEstimator", 4, 1, 1e-3, 0.5), 6),
        "PerClassWeightedLeastSquaresEstimator": (
            pair("weighted", "PerClassWeightedLeastSquaresEstimator", 4, 1, 1e-3, 0.5), 6),
        "LeastSquaresEstimator": (pair("least_squares", "LeastSquaresEstimator", 1e-3), 6),
        "GaussianMixtureModelEstimator": (pair("gmm", "GaussianMixtureModelEstimator", 4), None),
        "BlockLeastSquaresEstimator": (pair("block", "BlockLeastSquaresEstimator", 4), 6),
        "LinearMapEstimator": (pair("linear", "LinearMapEstimator"), 6),
        "LocalLeastSquaresEstimator": (pair("linear", "LocalLeastSquaresEstimator", 1e-3), 6),
        "KernelRidgeRegression": (pair("kernel", "KernelRidgeRegression", None, 1e-3, 4, 1), 6),
        "SketchedLeastSquaresEstimator": ((SketchedLeastSquaresEstimator(), JSketched()), 6),
    }


FAMILY = [
    "StandardScaler", "NaiveBayesEstimator", "ZCAWhitenerEstimator", "KMeansPlusPlusEstimator",
    "LogisticRegressionEstimator", "PCAEstimator", "DistributedPCAEstimator", "ApproximatePCAEstimator",
    "LocalColumnPCAEstimator", "DistributedColumnPCAEstimator", "ColumnPCAEstimator",
    "BlockWeightedLeastSquaresEstimator", "PerClassWeightedLeastSquaresEstimator", "LeastSquaresEstimator",
    "GaussianMixtureModelEstimator", "BlockLeastSquaresEstimator", "LinearMapEstimator",
    "LocalLeastSquaresEstimator", "KernelRidgeRegression", "SketchedLeastSquaresEstimator",
]


@pytest.mark.parametrize("name", FAMILY)
def test_operator_family_out_specs(name):
    """Each ported estimator's declared fitted-transformer spec maps apply
    inputs as the JAX package's does: the same rendering, the same
    refusals."""
    from keystone_tpu_torch.workflow.verify import _render_spec

    (est, jest), label_width = _family()[name]
    in_specs = [spec_leaf((100, 8))]
    jin = [_jspec((100, 8))]
    if label_width is not None:
        in_specs.append(spec_leaf((100, label_width)))
        jin.append(_jspec((100, label_width)))
    ts, jts = est.out_spec(in_specs), jest.out_spec(jin)
    assert isinstance(ts, TransformerSpec) and ts.label == jts.label
    for shape in ((7, 8), (7, 33, 8)):
        got = _render_spec(ts.apply_spec(spec_leaf(shape)))
        assert got == jverify._render_spec(jts.apply_spec(_jspec(shape)))
    with pytest.raises(SpecMismatch):
        ts.apply_spec(spec_leaf((7, 9)))
    with pytest.raises(jverify.SpecMismatch):
        jts.apply_spec(_jspec((7, 9)))


def test_transformer_spec_unknown_fn_propagates_unknown():
    assert TransformerSpec(None).apply_spec(object()) is UNKNOWN


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8", "bool", "complex64"])
def test_rendered_spec_equals_the_jax_packages(dtype):
    from keystone_tpu_torch.workflow.verify import _render_spec, spec_bytes

    spec = {"a": spec_leaf((8, 4), dtype), "b": TensorSpec((3,), np.dtype(dtype)).meta()}
    jspec = {"a": _jspec((8, 4), dtype), "b": _jspec((3,), dtype)}
    assert _render_spec(spec) == jverify._render_spec(jspec)
    assert spec_bytes(spec) == jverify.spec_bytes(jspec)


# ------------------------------------------------------------ KV101 / KV402


class MetaProbe(BatchTransformer):
    """One op of each kind the meta tracer meets."""

    def __init__(self, kind):
        self.kind = kind
        self.w = torch.ones(5, 3)

    @property
    def label(self):
        return f"MetaProbe[{self.kind}]"

    def apply_arrays(self, x):
        from keystone_tpu_torch.ops.cuda import gemm as g

        if self.kind == "size-mismatch":
            return x @ self.w  # 8-wide input against a 5-row weight
        if self.kind == "wrapper-shape":
            return g.gemm(x, self.w)
        if self.kind == "wrapper-dtype":
            return g.gemm(x, self.w.double())
        if self.kind == "rank":
            return x.sum(dim=3)
        if self.kind == "no-meta-kernel":
            return torch.bincount(x.long().reshape(-1)).float()
        if self.kind == "item":
            return x / float(x.abs().max())
        if self.kind == "nonzero":
            return x[x > 0]
        if self.kind == "host-numpy":
            return torch.from_numpy(np.asarray(x) * 2)
        if self.kind == "host-copy":
            return x.cpu() * 2
        raise AssertionError(self.kind)


KV101_KINDS = ["size-mismatch", "wrapper-shape", "wrapper-dtype", "rank"]
KV402_KINDS = ["no-meta-kernel", "item", "nonzero", "host-numpy", "host-copy"]


@pytest.mark.parametrize("kind", KV101_KINDS + KV402_KINDS)
def test_meta_tracer_tells_a_mismatch_from_a_step_it_cannot_run(kind, monkeypatch):
    """Only a shape or dtype rejection is KV101; an op the tracer cannot
    run on ``meta`` is KV402 (info), so strict mode never refuses a plan
    for what the verifier cannot see."""
    report = verify_pipeline(MetaProbe(kind).to_pipeline(), TensorSpec((4, 8)))
    want = "KV101" if kind in KV101_KINDS else "KV402"
    assert _codes(report) == [want], report.render()
    assert report.ok is (want == "KV402")
    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    if want == "KV402":
        assert verify_and_enforce(MetaProbe(kind).to_pipeline().graph, context="t").ok
    assert blocksparse.ell_matmul.launches == 0 or True


def test_shape_error_classifier():
    from keystone_tpu_torch.ops.cuda._build import DtypeMismatch

    assert is_shape_error(SpecMismatch("x"))
    assert is_shape_error(ValueError("gemm: shapes (4, 8) @ (7, 3) do not chain"))
    assert is_shape_error(DtypeMismatch("operands differ in type"))
    assert is_shape_error(RuntimeError("The size of tensor a (63) must match the size of tensor b (64)"))
    assert not is_shape_error(RuntimeError("Tensor.item() cannot be called on meta tensors"))
    assert not is_shape_error(ValueError("gemm needs its tensors on one device; got ['meta', 'cpu']"))
    assert not is_shape_error(NotImplementedError("no meta kernel"))
    assert not is_shape_error(TypeError("can't convert meta device type tensor to numpy"))
    assert not is_shape_error(RuntimeError("CUDA error: an illegal memory access was encountered"))


# ------------------------------------------------------- wrappers on meta


def _meta(a):
    return torch.empty_like(a, device="meta")


WRAPPER_CASES = {
    "gemm": (lambda a, b: gemm.gemm(a, b), ((6, 5), (5, 3)), ((6, 5), (4, 3))),
    "gemm_tn_chunked": (lambda a, b: gemm.gemm_tn_chunked(a, b, rows=4), ((9, 5), (9, 3)), ((9, 5), (8, 3))),
    "gemm_batched": (lambda a, b: gemm.gemm_batched(a, b), ((2, 6, 5), (2, 5, 3)), ((2, 6, 5), (2, 4, 3))),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CASES))
def test_binding_wrappers_take_meta_as_a_shape_rule(name):
    from keystone_tpu_torch.obs import cost

    fn, good, bad = WRAPPER_CASES[name]
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in good)
    want = fn(a, b)  # the CPU tensor still takes the plain version
    assert want.device.type == "cpu" and torch.isfinite(want).all()
    before = dict(gemm.launches)
    cost.set_cost_observatory(True)
    try:
        frame = cost.push_frame("meta")
        got = fn(_meta(a), _meta(b))
        notes = cost.pop_frame(frame)
    finally:
        cost.set_cost_observatory(False)
        cost.reset_cost_observatory()
    assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
    assert dict(gemm.launches) == before and not getattr(notes, "launches", None)
    a2, b2 = (torch.zeros(s) for s in bad)
    with pytest.raises(ValueError) as cpu_err:
        fn(a2, b2)
    with pytest.raises(ValueError) as meta_err:
        fn(_meta(a2), _meta(b2))
    assert str(meta_err.value) == str(cpu_err.value)
    with pytest.raises(TypeError):
        fn(_meta(a), _meta(b).double())
    with pytest.raises(ValueError, match="one device"):
        fn(_meta(a), b)


@pytest.mark.parametrize("with_counts", [False, True])
def test_ell_wrapper_takes_meta_as_a_shape_rule(with_counts):
    rng = np.random.default_rng(1)
    nbr, slots, bm, bn, n = 4, 3, 8, 16, 5
    idx = torch.from_numpy(rng.integers(0, 4, (nbr, slots)).astype(np.int32))
    blocks = torch.from_numpy(rng.standard_normal((nbr, slots, bm, bn)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4 * bn, n)).astype(np.float32))
    counts = torch.tensor([3, 1, 0, 2], dtype=torch.int32) if with_counts else None
    want = blocksparse.ell_matmul(idx, blocks, b, counts)
    assert want.device.type == "cpu"
    before = blocksparse.ell_matmul.launches
    meta_counts = None if counts is None else _meta(counts)
    got = blocksparse.ell_matmul(_meta(idx), _meta(blocks), _meta(b), meta_counts)
    assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
    assert blocksparse.ell_matmul.launches == before
    with pytest.raises(ValueError) as cpu_err:
        blocksparse.ell_matmul(idx, blocks, b[:-1], counts)
    with pytest.raises(ValueError) as meta_err:
        blocksparse.ell_matmul(_meta(idx), _meta(blocks), _meta(b[:-1]), meta_counts)
    assert str(meta_err.value) == str(cpu_err.value)
    with pytest.raises(TypeError):
        blocksparse.ell_matmul(_meta(idx).long(), _meta(blocks), _meta(b), meta_counts)
    with pytest.raises(ValueError, match="tiles"):
        big = torch.empty(nbr, slots, 8, 256, device="meta")
        blocksparse.ell_matmul(_meta(idx), big, torch.empty(4 * 256, n, device="meta"), meta_counts)


# ------------------------------------------------------------- enforcement


def test_mode_parsing(monkeypatch):
    for raw, want in [
        ("", "warn"), ("warn", "warn"), ("strict", "strict"),
        ("off", "off"), ("0", "off"), ("STRICT", "strict"),
    ]:
        monkeypatch.setenv("KEYSTONE_VERIFY", raw)
        assert verification_mode() == want


def test_enforce_warn_vs_strict_vs_off(monkeypatch):
    graph = _linear_pair(n=64, rows_y=32)[0].graph

    monkeypatch.setenv("KEYSTONE_VERIFY", "warn")
    report = verify_and_enforce(graph, context="t")
    assert report is not None and not report.ok  # logged, not raised

    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    with pytest.raises(VerificationError) as err:
        verify_and_enforce(graph, context="t")
    assert "KV101" in str(err.value)

    monkeypatch.setenv("KEYSTONE_VERIFY", "off")
    assert verify_and_enforce(graph, context="t") is None


def test_strict_mode_raises_at_fit_before_any_fit(monkeypatch):
    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    fits = []
    monkeypatch.setattr(LinearMapEstimator, "fit", lambda self, *a: fits.append(1))
    with pytest.raises(VerificationError):
        _linear_pair(n=64, rows_y=32)[0].fit()
    assert fits == []


def test_fit_proceeds_under_warn(monkeypatch, caplog):
    monkeypatch.setenv("KEYSTONE_VERIFY", "warn")
    rng = np.random.default_rng(0)
    x = ArrayDataset(rng.standard_normal((64, 4)).astype(np.float32), device=CPU)
    y = ArrayDataset(rng.standard_normal((64, 2)).astype(np.float32), device=CPU)
    runs = _names.metric(_names.VERIFY_RUNS)
    before = runs.value(context="fit")
    fitted = LinearMapEstimator(device=CPU).with_data(x, y).fit()
    out = fitted.apply(np.zeros((5, 4), dtype=np.float32))
    out = getattr(out, "get", lambda: out)()
    assert tuple(getattr(out, "data", out).shape) == (5, 2)
    assert runs.value(context="fit") == before + 1


def test_fit_hook_off_skips_verification(monkeypatch):
    monkeypatch.setenv("KEYSTONE_VERIFY", "off")
    runs = _names.metric(_names.VERIFY_RUNS)
    before = runs.value(context="fit")
    rng = np.random.default_rng(1)
    x = ArrayDataset(rng.standard_normal((32, 4)).astype(np.float32), device=CPU)
    y = ArrayDataset(rng.standard_normal((32, 2)).astype(np.float32), device=CPU)
    LinearMapEstimator(device=CPU).with_data(x, y).fit()
    assert runs.value(context="fit") == before


def test_internal_verifier_failure_is_swallowed(monkeypatch, caplog):
    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    import keystone_tpu_torch.workflow.verify as verify_mod

    def boom(*a, **k):
        raise RuntimeError("verifier bug")

    monkeypatch.setattr(verify_mod, "verify_graph", boom)
    graph = _linear_pair(n=16, d=4, k=2)[0].graph
    with caplog.at_level(logging.WARNING):
        assert verify_mod.verify_and_enforce(graph, context="t") is None
    assert "failed internally" in caplog.text


def _saved(tmp_path):
    from keystone_tpu_torch.serving.synthetic import synthetic_fitted_pipeline

    path = str(tmp_path / "model.pt")
    synthetic_fitted_pipeline(d=16, depth=1, device=CPU).save(path)
    return path


def test_strict_load_fitted_raises_on_bucket_mismatch(tmp_path, monkeypatch):
    from keystone_tpu_torch.serving.registry import ModelRegistry

    path = _saved(tmp_path)
    registry = ModelRegistry()
    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    with pytest.raises(VerificationError):
        registry.load_fitted("m", path, device=CPU, buckets=[8, 32], warmed_buckets=[8])
    assert registry.names() == []
    entry = registry.load_fitted("m", path, device=CPU, buckets=[8, 32], warmed_buckets=[8, 32])
    assert entry is not None


def test_strict_load_fitted_refuses_a_mis_sized_example(tmp_path, monkeypatch):
    from keystone_tpu_torch.serving.registry import ModelRegistry

    path = _saved(tmp_path)
    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    with pytest.raises(VerificationError, match="KV101"):
        ModelRegistry().load_fitted("m", path, device=CPU, example=np.zeros(15, np.float32))
    assert ModelRegistry().load_fitted("m", path, device=CPU, example=np.zeros(16, np.float32)) is not None


def test_load_fitted_unconvertible_example_still_publishes(tmp_path, monkeypatch):
    """Spec-building from a weird example must degrade to an unbound
    verify, never crash publication (the warn contract)."""
    from keystone_tpu_torch.serving.registry import ModelRegistry

    path = _saved(tmp_path)
    monkeypatch.setenv("KEYSTONE_VERIFY", "warn")

    class Unconvertible:
        def __array__(self, *a, **k):
            raise ValueError("no dice")

    assert ModelRegistry().load_fitted("m", path, device=CPU, example=Unconvertible()) is not None


def test_load_fitted_example_reads_dtype_from_metadata(tmp_path, monkeypatch):
    """A card-like example leaf must never be copied to the host just to
    read its dtype."""
    from keystone_tpu_torch.serving.registry import ModelRegistry

    path = _saved(tmp_path)
    monkeypatch.setenv("KEYSTONE_VERIFY", "warn")

    class DeviceLeaf:
        shape = (16,)
        dtype = torch.float32

        def __array__(self, *a, **k):  # pragma: no cover - must not run
            raise AssertionError("host copy just to read metadata")

    runs = _names.metric(_names.VERIFY_DIAGNOSTICS)
    before = runs.value(code="KV101", severity=ERROR)
    assert ModelRegistry().load_fitted("m", path, device=CPU, example=DeviceLeaf()) is not None
    assert runs.value(code="KV101", severity=ERROR) == before


# ------------------------------------------------------------------ metrics


def test_verify_publishes_metrics():
    runs = _names.metric(_names.VERIFY_RUNS)
    diags = _names.metric(_names.VERIFY_DIAGNOSTICS)
    nodes = _names.metric(_names.VERIFY_NODES)
    before = (runs.value(context="metrics-test"), diags.value(code="KV101", severity=ERROR), nodes.value())
    verify_pipeline(_linear_pair(n=64, rows_y=32)[0], context="metrics-test")
    assert runs.value(context="metrics-test") == before[0] + 1
    assert diags.value(code="KV101", severity=ERROR) == before[1] + 1
    assert nodes.value() == before[2] + 4


def test_every_code_has_severity_and_title():
    for code, (severity, title) in CODES.items():
        assert severity in (ERROR, WARNING, INFO)
        assert title
        assert code.startswith("KV") and code[2:].isdigit()


def test_code_tables_equal_the_jax_packages():
    from keystone_tpu.lint import CONCURRENCY_CODES as J_CONC
    from keystone_tpu.lint import LINT_CODES as J_LINT
    from keystone_tpu_torch.lint import CONCURRENCY_CODES, LINT_CODES

    assert {c: s for c, (s, _t) in CODES.items()} == {c: s for c, (s, _t) in jverify.CODES.items()}
    assert set(LINT_CODES) == set(J_LINT) - {"KV505"}
    assert CONCURRENCY_CODES == J_CONC


def test_report_json_roundtrip():
    report = _on_8_shards(verify_pipeline, _linear_pair(n=64, rows_y=32)[0])
    payload = report.to_json()
    assert payload["ok"] is False
    assert any(d["code"] == "KV101" for d in payload["diagnostics"])
    assert all({"node", "label", "spec"} <= set(n) for n in payload["nodes"])
    jpayload = jverify.verify_pipeline(_linear_pair(n=64, rows_y=32)[1]).to_json()
    for key in ("ok", "diagnostics", "nodes"):
        assert payload[key] == jpayload[key]


# --------------------------------------------------- whole plans, both packages


def test_streamed_plan_casts_to_float_before_the_chain():
    """A StreamFit node over uint8 records: the featurized spec is the
    chain's output after the chunk step's cast to float32, and it sets
    the Gram check's width, as in the JAX package."""
    from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JBlock
    from keystone_tpu.workflow.streaming import StreamingFitOperator as JStreamingFitOperator
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.workflow.streaming import StreamingFitOperator

    class Widen(Scale):
        def apply_arrays(self, x):
            return torch.cat([x, x], dim=1) * self.c

    class JWiden(JScale):
        def apply_arrays(self, x):
            import jax.numpy as jnp

            return jnp.concatenate([x, x], axis=1) * self.c

    x = np.zeros((32, 64), np.uint8)
    y = np.zeros((32, 4), np.float32)
    pipe = BlockLeastSquaresEstimator(16, device=CPU).with_data(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    jpipe = JBlock(16).with_data(JArrayDataset(x), JArrayDataset(y))

    def streamed(p, streaming, widen):
        graph = p.graph
        node = next(n for n in graph.nodes if hasattr(graph.get_operator(n), "out_spec"))
        return graph.set_operator(node, streaming(graph.get_operator(node), members=(widen(2.0),)))

    report = verify_graph(streamed(pipe, StreamingFitOperator, Widen), device_memory_bytes=10_000)
    jreport = jverify.verify_graph(streamed(jpipe, JStreamingFitOperator, JWiden), device_memory_bytes=10_000)
    kv303 = report.by_code("KV303")
    assert len(kv303) == 1 and kv303[0].details["d"] == 128
    assert _summary(report) == _summary(jreport)


def _mnist_pair(rows):
    from keystone_tpu.pipelines.mnist_random_fft import MnistRandomFFTConfig as JConfig
    from keystone_tpu.pipelines.mnist_random_fft import build_pipeline as jbuild
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_pipeline

    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, 784)).astype(np.float32)
    labels = rng.integers(0, 10, rows).astype(np.int32)
    kw = dict(num_ffts=2, block_size=512)
    return (
        build_pipeline(MnistRandomFFTConfig(**kw), _labeled(x, labels), device=CPU),
        jbuild(JConfig(**kw), _jlabeled(x, labels)),
    )


def _labeled(x, labels):
    from keystone_tpu_torch.data.loaders.csv import LabeledData

    return LabeledData(labels=ArrayDataset(labels, device=CPU), data=ArrayDataset(x, device=CPU))


def _jlabeled(x, labels):
    from keystone_tpu.data.loaders.csv import LabeledData

    return LabeledData(labels=JArrayDataset(labels), data=JArrayDataset(x))


def test_mnist_plan_verifies_clean_and_as_the_jax_package_reads_it():
    """The README's MNIST random-FFT plan, optimized as ``fit`` sees it:
    no error, every node analyzable (the random-FFT branches on meta),
    and the JAX package's codes and specs node for node."""
    from keystone_tpu.workflow.executor import PipelineEnv as JPipelineEnv

    pipe, jpipe = _mnist_pair(256)
    graph, _ = PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    jgraph, _ = JPipelineEnv.get_or_create().optimizer.execute(jpipe.graph)
    report = verify_graph(graph, context="fit")
    jreport = jverify.verify_graph(jgraph, context="fit")
    assert report.ok, report.render()
    branches = [a.spec for a in report.annotations if a.label.startswith("Fused[")]
    # The fit side's two branches run on meta; the apply side's read an
    # unbound source (unknown), in both packages.
    assert branches.count("(256, 512):float32") == 2 and branches.count("unknown") == 2
    assert _summary(report) == _summary(jreport)


def test_mnist_plan_with_a_783_wide_source_is_refused_under_strict(monkeypatch):
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_pipeline

    rng = np.random.default_rng(0)
    train = _labeled(rng.standard_normal((256, 783)).astype(np.float32), rng.integers(0, 10, 256).astype(np.int32))
    pipe = build_pipeline(MnistRandomFFTConfig(num_ffts=2, block_size=512), train, device=CPU)
    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    with pytest.raises(VerificationError, match="KV101"):
        pipe.fit()


def test_hashing_tf_slice_plan_reads_documents_as_unknown_on_the_fit_path():
    """The hashing-TF → block-sparse slice: its documents are an
    ObjectDataset, UNKNOWN on the fit path (nothing is decoded), and the
    block-sparse estimator's out_spec still gives the fitted map's edge
    its label width; probing (the CLI path) reads one document."""
    from keystone_tpu_torch.data.dataset import ObjectDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.nlp.text import HashingTF, LowerCase, Tokenizer, Trim
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators

    docs = ObjectDataset([f"word{i % 7} other{i % 3}" for i in range(64)])
    labels = ClassLabelIndicators(4)(ArrayDataset(np.arange(64, dtype=np.int32) % 4, device=CPU)).get()
    feat = Trim().to_pipeline().then(LowerCase()).then(Tokenizer()).then(HashingTF(256))
    pipe = feat.then_label_estimator(BlockLeastSquaresEstimator(64, device=CPU), docs, labels)
    graph, _ = PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    report = verify_graph(graph, context="fit")
    assert report.ok, report.render()
    specs = [(a.label, a.spec) for a in report.annotations]
    assert ("Dataset[n=64]", "unknown") in specs and ("Dataset[n=64]", "(64, 4):float32") in specs
    assert any(s == "TransformerSpec[BlockLeastSquaresEstimator(d=None,k=4)]" for _label, s in specs)
