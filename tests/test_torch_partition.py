"""The port's partitioner and the paths that use it, on the CPU, held
against the JAX package on the conftest's 8 virtual devices (the port on
8 CPU shards): every decision and reason key field for field (the cases
of ``tests/parallel/test_partitioner.py``, ``tests/workflow/
test_partition.py`` and the non-recovery half of ``tests/workflow/
test_partition2d.py``), the partition batch's pins and the executor's
decisions, sharded ``fit_stream`` in 1-D and 2-D (predictions ≤ 1e-5
from the JAX package's and from the port's 1-shard fit; finish bytes and
per-shard state equal to the JAX package's plan-pure numbers), the
in-core fits over a mesh, KV203 / KV304, and the refusal of a sharded
durable fold."""

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JBlock
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinear
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu.parallel import partitioner as jpart
from keystone_tpu.workflow import streaming as jstreaming
from keystone_tpu.workflow.executor import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.pipeline import BatchTransformer as JBatchTransformer
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import names as _names
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSEstimator
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.ops.learning.logistic import LogisticRegressionEstimator
from keystone_tpu_torch.parallel import mesh as tmesh
from keystone_tpu_torch.parallel import partitioner as tpart
from keystone_tpu_torch.parallel.collectives import Sharded
from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator
from keystone_tpu_torch.workflow import streaming as tstreaming
from keystone_tpu_torch.workflow.executor import GraphExecutor, PipelineEnv
from keystone_tpu_torch.workflow.pipeline import BatchTransformer

CPU = torch.device("cpu")
N, D, K, CHUNK = 512, 16, 3, 64
TOL = 1e-5


class Scale(BatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    def apply_arrays(self, a):
        return a * self.c


class JScale(JBatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    def apply_arrays(self, a):
        return a * self.c


@pytest.fixture(autouse=True)
def _fresh():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


@pytest.fixture
def mesh8():
    mesh = tmesh.make_mesh(devices=[CPU] * 8)
    with tmesh.use_mesh(mesh):
        yield mesh


def _data(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, K)).astype(np.float32)
    y = (x @ w + 0.01 * rng.normal(size=(n, K))).astype(np.float32)
    return x, y


def _pipe(x, y, est=None):
    est = est or BlockLeastSquaresEstimator(8, num_iter=1, reg=1e-3, device=CPU)
    return Scale(2.0).to_pipeline().then_label_estimator(
        est, ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)
    )


def _jpipe(x, y, est=None):
    est = est or JBlock(8, num_iter=1, reg=1e-3)
    return JScale(2.0).to_pipeline().then_label_estimator(est, JArrayDataset(x), JArrayDataset(y))


def _preds(fitted, x):
    return np.asarray(fitted.apply_batch(ArrayDataset(x, device=CPU)).data)


def _jpreds(fitted, x):
    return np.asarray(fitted.apply_batch(JArrayDataset(x)).data)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------- decisions

DECISIONS = [
    # (mesh shape, kind, args, env)
    ((8,), "fit", dict(rows=4096), {}),
    ((8,), "fit", dict(rows=None), {}),
    ((8,), "fit", dict(rows=-1), {}),
    ((8,), "fit", dict(rows=7), {}),
    ((8,), "fit", dict(rows=128), {"KEYSTONE_PARTITION_MIN_ROWS": "100"}),
    ((8,), "fit", dict(rows=4096, opt_out=True), {}),
    ((1,), "fit", dict(rows=4096), {}),
    ((8,), "stream", dict(chunk_rows=100), {}),
    ((8,), "stream", dict(chunk_rows=4), {}),
    ((8,), "stream", dict(chunk_rows=64, rows=8), {}),
    ((8,), "stream", dict(chunk_rows=64, rows=N, width=D, model_ok=True),
     {"KEYSTONE_PARTITION_MODEL_SHARDS": "4", "KEYSTONE_PARTITION_MIN_WIDTH": "2"}),
    ((8,), "stream", dict(chunk_rows=64, rows=N, width=64, model_ok=True),
     {"KEYSTONE_PARTITION_MODEL_SHARDS": "4", "KEYSTONE_PARTITION_MIN_WIDTH": "512"}),
    ((8,), "stream", dict(chunk_rows=64, rows=N, width=62, model_ok=True),
     {"KEYSTONE_PARTITION_MODEL_SHARDS": "4", "KEYSTONE_PARTITION_MIN_WIDTH": "8"}),
    ((8,), "stream", dict(chunk_rows=64, rows=N, width=66, model_ok=True),
     {"KEYSTONE_PARTITION_MODEL_SHARDS": "3", "KEYSTONE_PARTITION_MIN_WIDTH": "8"}),
    ((8,), "stream", dict(chunk_rows=64, rows=N, width=64, model_ok=False),
     {"KEYSTONE_PARTITION_MODEL_SHARDS": "4", "KEYSTONE_PARTITION_MIN_WIDTH": "8"}),
    ((8,), "stream", dict(chunk_rows=64, rows=N, width=None, model_ok=True),
     {"KEYSTONE_PARTITION_MODEL_SHARDS": "8"}),
    ((8,), "fit", dict(rows=N, width=None, model_ok=True), {"KEYSTONE_PARTITION_MODEL_SHARDS": "2"}),
    ((8,), "fit", dict(rows=N, width=1024, model_ok=True), {"KEYSTONE_PARTITION_MODEL_SHARDS": "2"}),
    ((4, 2), "fit", dict(rows=N, width=2048, model_ok=True), {}),
    ((2, 4), "stream", dict(chunk_rows=100, rows=N, width=4096, model_ok=True), {}),
    ((8,), "serve", dict(buckets=[1, 2, 4, 8]), {}),
    ((8,), "serve", dict(buckets=[1, 2, 4]), {}),
    ((1,), "serve", dict(buckets=[8, 16]), {}),
]


def _decide(partitioner_mod, mesh, kind, args):
    p = partitioner_mod.Partitioner(mesh=mesh)
    if kind == "fit":
        return p.decide_fit("est", record=False, **args)
    if kind == "stream":
        return p.decide_stream("sf", record=False, **args)
    return p.decide_serve("m", record=False, **args)


@pytest.mark.parametrize("shape,kind,args,env", DECISIONS, ids=[str(i) for i in range(len(DECISIONS))])
def test_decision_equals_the_jax_packages_field_for_field(shape, kind, args, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    axes = ("data",) if len(shape) == 1 else ("data", "model")
    mesh = tmesh.make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))
    jm = jmesh.make_mesh(shape, axes, devices=jax.devices()[: int(np.prod(shape))])
    got, want = _decide(tpart, mesh, kind, args), _decide(jpart, jm, kind, args)
    assert got.to_json() == want.to_json()
    assert (got.carry_axes, got.total_shards) == (want.carry_axes, want.total_shards)
    assert (got.mesh is None) == (want.mesh is None)
    if got.mesh is not None:
        assert got.mesh.shape == dict(want.mesh.shape)


def test_disabled_and_reason_keys_equal_the_jax_packages(mesh8):
    assert tpart.ALL_REASON_KEYS == jpart.ALL_REASON_KEYS
    with tpart.partition_disabled(), jpart.partition_disabled():
        got = tpart.Partitioner().decide_fit("est", 4096, record=False)
        want = jpart.Partitioner().decide_fit("est", 4096, record=False)
    assert got.to_json() == want.to_json() and got.reason == tpart.R_DISABLED


def test_demote_model_axis_equals_the_jax_packages(monkeypatch):
    monkeypatch.setenv("KEYSTONE_PARTITION_MIN_WIDTH", "8")
    for p_m in ("4", "8"):
        monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", p_m)
        args = dict(chunk_rows=CHUNK, rows=N, width=64, model_ok=True)
        got = _decide(tpart, tmesh.make_mesh(devices=[CPU] * 8), "stream", args)
        want = _decide(jpart, jmesh.make_mesh(devices=jax.devices()[:8]), "stream", args)
        dgot = tpart.demote_model_axis(got, tpart.R_MODEL_INDIVISIBLE, "test")
        dwant = jpart.demote_model_axis(want, jpart.R_MODEL_INDIVISIBLE, "test")
        assert dgot.to_json() == dwant.to_json()
        assert dgot.eligible == (p_m == "4")


def test_report_metrics_and_shard_rows(mesh8):
    tpart.reset_partition_report()
    g0 = tpart.partition_report_generation()
    decisions = _names.metric(_names.PARTITION_DECISIONS)
    before = decisions.value(kind="fit", eligible="1")
    d = tpart.Partitioner().decide_fit("est", 4096)
    assert decisions.value(kind="fit", eligible="1") == before + 1
    assert [r.to_json() for r in tpart.last_partition_report()] == [d.to_json()]
    tpart.Partitioner().decide_fit("est", 4096, record=False)
    assert len(tpart.last_partition_report()) == 1
    tpart.reset_partition_report()
    assert tpart.partition_report_generation() == g0 + 1 and tpart.last_partition_report() == []
    placed = tpart.shard_rows(d, {"a": np.zeros((16, 3), np.float32), "b": np.zeros((6, 3), np.float32)})
    assert isinstance(placed["a"], Sharded) and len(placed["a"].shards) == 8
    assert isinstance(placed["b"], np.ndarray)
    assert tpart.fit_mesh(type("Op", (), {"partition": d})()) is mesh8


# ------------------------------------------------ the partition batch, 1-D


def test_partition_batch_pins_decision_on_streaming_operator(mesh8, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    x, y = _data()
    executor = GraphExecutor(_pipe(x, y).graph)
    ops = [executor.graph.get_operator(n) for n in executor.graph.nodes]
    ops = [op for op in ops if isinstance(op, tstreaming.StreamingFitOperator)]
    assert len(ops) == 1
    decision = ops[0].partition
    assert decision.eligible and decision.shards == 8 and decision.chunk_rows == CHUNK
    assert ops[0].chunk_rows == decision.chunk_rows
    assert any(d.eligible for d in executor.partition_decisions)


@pytest.mark.parametrize("est", ["block", "exact"])
def test_sharded_fit_stream_parity_and_finish_reduce(mesh8, monkeypatch, est):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    x, y = _data()
    make = {
        "block": (lambda: BlockLeastSquaresEstimator(8, num_iter=1, reg=1e-3, device=CPU),
                  lambda: JBlock(8, num_iter=1, reg=1e-3)),
        "exact": (lambda: LinearMapEstimator(reg=1e-3, device=CPU), lambda: JLinear(reg=1e-3)),
    }[est]
    fitted = _pipe(x, y, make[0]()).fit()
    rep = tstreaming.last_stream_report()
    assert (rep.shards, rep.mesh_shape, rep.compiles_steady_state) == (8, (8,), 0)
    carry_bytes = 4 * (D * D + D * K + D + K)
    assert rep.collective_bytes == rep.collective_bytes_data == carry_bytes * 7
    assert rep.state_bytes_per_device == carry_bytes
    preds = _preds(fitted, x[:32])

    jfitted = _jpipe(x, y, make[1]()).fit()
    jrep = jstreaming.last_stream_report()
    for field in ("shards", "model_shards", "mesh_shape", "chunk_rows", "collective_bytes",
                  "collective_bytes_data", "collective_bytes_model", "state_bytes_per_device"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert _rel(preds, _jpreds(jfitted, x[:32])) <= TOL

    PipelineEnv.reset()
    with tpart.partition_disabled():
        fitted1 = _pipe(x, y, make[0]()).fit()
        assert tstreaming.last_stream_report().shards == 1
    assert _rel(preds, _preds(fitted1, x[:32])) <= TOL


def test_chunk_rows_rounded_up_to_shard_multiple(mesh8, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", "100")
    x, y = _data()
    _pipe(x, y).fit()
    rep = tstreaming.last_stream_report()
    assert rep.shards == 8 and rep.chunk_rows == 104


def test_in_core_fit_pins_partition_mesh(mesh8):
    """Below the streaming floor the fit stays in-core; the pinned fit
    decision's mesh shards it, with 1-vs-8 and port-vs-JAX parity."""
    x, y = _data()
    fitted = _pipe(x, y).fit()
    decisions = [d for d in tpart.last_partition_report() if d.eligible]
    assert decisions and decisions[0].kind == "fit" and decisions[0].shards == 8
    preds8 = _preds(fitted, x[:32])
    assert _rel(preds8, _jpreds(_jpipe(x, y).fit(), x[:32])) <= TOL
    PipelineEnv.reset()
    with tmesh.use_mesh(tmesh.make_mesh(devices=[CPU])):
        preds1 = _preds(_pipe(x, y).fit(), x[:32])
        assert [d.reason for d in tpart.last_partition_report()] == ["single-shard-mesh"]
    assert _rel(preds8, preds1) <= TOL


def test_ineligible_chunk_falls_back_to_single_device_plan(mesh8, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", "4")
    monkeypatch.setenv("KEYSTONE_STREAM_MIN_ROWS", "1")
    x, y = _data()
    fitted = _pipe(x, y).fit()
    assert tstreaming.last_stream_report().shards == 1
    assert "chunk-below-shard-count" in {d.reason for d in tpart.last_partition_report()}
    assert np.isfinite(_preds(fitted, x[:16])).all()


def test_partitionable_false_respected_through_streaming_wrap(mesh8, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    x, y = _data()
    est = BlockLeastSquaresEstimator(8, num_iter=1, reg=1e-3, device=CPU)
    est.partitionable = False
    _pipe(x, y, est).fit()
    assert tstreaming.last_stream_report().shards == 1
    decisions = tpart.last_partition_report()
    assert decisions[0].reason == "operator-opt-out" and decisions[0].kind == "fit_stream"


def test_partition_disabled_records_empty_report(mesh8, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    x, y = _data()
    with tpart.partition_disabled():
        _pipe(x, y).fit()
    assert tpart.last_partition_report() == []
    assert tstreaming.last_stream_report().shards == 1


def test_default_mesh_keeps_the_single_device_plan(monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    x, y = _data()
    _pipe(x, y).fit()
    rep = tstreaming.last_stream_report()
    assert (rep.shards, rep.mesh_shape, rep.collective_bytes) == (1, (), 0)
    assert [d.reason for d in tpart.last_partition_report()] == ["single-shard-mesh"]


def test_a_sharded_durable_fold_commits_merged_snapshots_as_the_jax_package(mesh8, monkeypatch, tmp_path):
    """A checkpoint store under a sharded plan: the fold commits the
    shard-merged carry with the plan's mesh fields in its cursor, retires
    the entry at completion, and predicts as the JAX package's durable
    sharded fold on its 8 virtual devices."""
    from keystone_tpu.reliability import enable_checkpointing as j_enable_checkpointing
    from keystone_tpu_torch.reliability import enable_checkpointing
    from keystone_tpu_torch.reliability.recovery import get_recovery_log, reset_recovery_log

    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    monkeypatch.setenv("KEYSTONE_STREAM_CKPT_CHUNKS", "2")
    reset_recovery_log()
    x, y = _data()
    probe = np.random.default_rng(3).normal(size=(32, D)).astype(np.float32)
    JPipelineEnv.reset()
    j_enable_checkpointing(str(tmp_path / "jax"))
    jfit = _jpipe(x, y).fit()
    jrep = jstreaming.last_stream_report()
    enable_checkpointing(str(tmp_path / "port"), device=CPU)
    fitted = _pipe(x, y).fit()
    rep = tstreaming.last_stream_report()
    assert (rep.shards, rep.checkpoints) == (jrep.shards, jrep.checkpoints) == (8, 3)
    commits = get_recovery_log().events("stream_checkpoint")
    assert [e.detail["chunk_index"] for e in commits] == [2, 4, 6]
    assert _rel(_preds(fitted, probe), _jpreds(jfit, probe)) <= TOL
    JPipelineEnv.reset()


# ------------------------------------------------------------------- 2-D

X2, Y2 = _data(n=N, d=64, seed=11)
PROBE2 = np.random.default_rng(12).normal(size=(32, 64)).astype(np.float32)


@pytest.fixture
def grid2d(monkeypatch, mesh8):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", "4")
    monkeypatch.setenv("KEYSTONE_PARTITION_MIN_WIDTH", "8")


@pytest.fixture
def reference2d(grid2d):
    with tpart.partition_disabled():
        out = _preds(_pipe(X2, Y2, LinearMapEstimator(reg=1e-3, device=CPU)).fit(), PROBE2)
    PipelineEnv.reset()
    return out


@pytest.mark.parametrize("model_shards,mesh_shape", [(4, (2, 4)), (2, (4, 2)), (8, (1, 8))])
def test_2d_fit_stream_parity_and_axis_accounting(reference2d, monkeypatch, model_shards, mesh_shape):
    monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", str(model_shards))
    fitted = _pipe(X2, Y2, LinearMapEstimator(reg=1e-3, device=CPU)).fit()
    rep = tstreaming.last_stream_report()
    assert rep.mesh_shape == mesh_shape and (rep.shards, rep.model_shards) == mesh_shape
    assert rep.compiles_steady_state == 0
    b_f, b_r = 4 * (64 * 64 + 64 * K + 64), 4 * K
    p_d, p_m = mesh_shape
    assert rep.collective_bytes_data == (b_f + p_m * b_r) * (p_d - 1)
    assert rep.collective_bytes_model == (b_f // p_m + b_r) * (p_m - 1)
    assert rep.state_bytes_per_device == b_f // p_m + b_r
    preds = _preds(fitted, PROBE2)
    assert _rel(preds, reference2d) <= TOL
    jfitted = _jpipe(X2, Y2, JLinear(reg=1e-3)).fit()
    jrep = jstreaming.last_stream_report()
    assert (jrep.mesh_shape, jrep.collective_bytes, jrep.state_bytes_per_device) == (
        rep.mesh_shape, rep.collective_bytes, rep.state_bytes_per_device)
    assert _rel(preds, _jpreds(jfitted, PROBE2)) <= TOL


def test_per_device_state_shrinks_with_model_shards(grid2d, monkeypatch):
    state = {}
    for p_m in (1, 2, 4):
        monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", str(p_m))
        PipelineEnv.reset()
        _pipe(X2, Y2, LinearMapEstimator(reg=1e-3, device=CPU)).fit()
        state[p_m] = tstreaming.last_stream_report().state_bytes_per_device
    assert state[1] > 1.9 * state[2] and state[2] > 1.9 * state[4]


@pytest.mark.parametrize("variant", ["countsketch", "srht"])
def test_sketched_rung_2d_blocked_carry_parity(grid2d, variant):
    """The sketch steps' blocked protocol: the 2×4 fold's SA/Σx blocks
    reassemble to the single-device carry."""
    def fit():
        est = SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=256, variant=variant, device=CPU)
        return _preds(_pipe(X2, Y2, est).fit(), PROBE2)

    got = fit()
    rep = tstreaming.last_stream_report()
    assert (rep.shards, rep.model_shards) == (2, 4) and rep.compiles_steady_state == 0
    PipelineEnv.reset()
    with tpart.partition_disabled():
        assert _rel(got, fit()) <= TOL


def test_rung_pricing_scales_sketch_floor_per_shard(monkeypatch):
    from keystone_tpu.ops.learning.least_squares import LeastSquaresEstimator as JLS
    from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator

    monkeypatch.setenv("KEYSTONE_SKETCH_MIN_WIDTH", "32")
    est, jest = LeastSquaresEstimator(reg=1e-3, device=CPU), JLS(reg=1e-3)
    for width, p_m in ((64, 1), (64, 4), (128, 4)):
        got = type(est._stream_solver(width, model_shards=p_m)).__name__
        assert got == type(jest._stream_solver(width, model_shards=p_m)).__name__


def test_plan_report_carries_model_fallback(grid2d):
    x = np.ascontiguousarray(X2[:, :62])
    fitted = _pipe(x, Y2, LinearMapEstimator(reg=1e-3, device=CPU)).fit()
    rep = tstreaming.last_stream_report()
    assert rep.shards == 8 and rep.model_shards == 1
    decisions = [d for d in tpart.last_partition_report() if d.eligible]
    assert decisions[0].model_fallback == "model-axis-indivisible"
    assert np.isfinite(_preds(fitted, np.ascontiguousarray(PROBE2[:, :62]))).all()


def test_fold_demotes_a_step_without_the_blocked_protocol(grid2d, monkeypatch):
    """The raw width (16) grants 4 model shards; the fold finds the real
    featurized width (30, not divisible by 4) and demotes to row-only on
    the same 2×4 mesh."""
    x = np.ascontiguousarray(X2[:, :16])
    monkeypatch.setenv("KEYSTONE_PARTITION_MIN_WIDTH", "1")

    class Widen(BatchTransformer):
        def apply_arrays(self, a):
            return torch.cat([a, a], dim=1)[:, :30]

    pipe = Widen().to_pipeline().then_label_estimator(
        LinearMapEstimator(reg=1e-3, device=CPU), ArrayDataset(x, device=CPU),
        ArrayDataset(Y2, device=CPU))
    fallbacks = _names.metric(_names.PARTITION_FALLBACKS)
    before = fallbacks.value(reason="model-axis-indivisible")
    pipe.fit()
    rep = tstreaming.last_stream_report()
    assert (rep.shards, rep.model_shards, rep.mesh_shape) == (2, 1, (2, 4))
    assert fallbacks.value(reason="model-axis-indivisible") == before + 1


# ----------------------------------------------------------- in-core fits


@pytest.mark.parametrize("shape", [(8,), (4, 2)])
def test_block_in_core_fit_over_a_mesh_equals_jax(shape):
    x, y = _data(n=256, d=32, seed=4)
    axes = ("data",) if len(shape) == 1 else ("data", "model")
    mesh = tmesh.make_mesh(shape, axes, devices=[CPU] * 8)
    jm = jmesh.make_mesh(shape, axes, devices=jax.devices()[:8])
    est = BlockLeastSquaresEstimator(8, num_iter=3, reg=1e-2, device=CPU)
    with tmesh.use_mesh(mesh):
        got = _preds(est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)), x[:32])
    with jmesh.use_mesh(jm):
        want = _jpreds(JBlock(8, num_iter=3, reg=1e-2).fit(JArrayDataset(x), JArrayDataset(y)), x[:32])
    one = _preds(est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)), x[:32])
    assert _rel(got, want) <= TOL
    if len(shape) == 1:  # the 2-D block order is a permutation of the 1-D one
        assert _rel(got, one) <= TOL


@pytest.mark.parametrize("which", ["exact", "lbfgs", "logistic"])
def test_other_in_core_fits_over_8_shards_equal_one_shard(mesh8, which):
    x, y = _data(n=100, d=12, seed=5)
    labels = np.argmax(y, axis=1).astype(np.int32)
    make = {
        "exact": (lambda: LinearMapEstimator(reg=1e-3, device=CPU), y),
        "lbfgs": (lambda: DenseLBFGSEstimator(reg=1e-3, num_iterations=20, device=CPU), y),
        "logistic": (lambda: LogisticRegressionEstimator(3, reg=1e-2, num_iterations=20, device=CPU), labels),
    }[which]
    got = _preds(make[0]().fit(ArrayDataset(x, device=CPU), ArrayDataset(make[1], device=CPU)), x[:16])
    with tmesh.use_mesh(tmesh.make_mesh(devices=[CPU])):
        one = _preds(make[0]().fit(ArrayDataset(x, device=CPU), ArrayDataset(make[1], device=CPU)), x[:16])
    assert _rel(got, one) <= TOL


def test_exact_in_core_fit_over_8_shards_equals_jax(mesh8):
    x, y = _data(n=100, d=12, seed=6)
    got = _preds(LinearMapEstimator(reg=1e-3, device=CPU).fit(ArrayDataset(x, device=CPU),
                                                               ArrayDataset(y, device=CPU)), x[:16])
    want = _jpreds(JLinear(reg=1e-3).fit(JArrayDataset(x), JArrayDataset(y)), x[:16])
    assert _rel(got, want) <= TOL


def test_array_dataset_shard_equals_the_jax_packages(mesh8):
    x = np.arange(30, dtype=np.float64).reshape(10, 3)
    ds = ArrayDataset(x, device=CPU).shard(mesh8)
    jds = JArrayDataset(x).shard(jmesh.make_mesh(devices=jax.devices()[:8]))
    assert ds.physical_rows == jds.physical_rows == 16 and len(ds) == len(jds) == 10
    assert ds.num_shards == jds.num_shards == 8
    assert str(ds.data.dtype).split(".")[-1] == str(np.asarray(jds.data).dtype)
    np.testing.assert_array_equal(ds.data.numpy(), np.asarray(jds.data))
    views = ds.shard_views()
    assert [tuple(s.shape) for s in views.shards] == [(2, 3)] * 8


# -------------------------------------------------------------- verifier


def _verify(pipe, **kw):
    from keystone_tpu_torch.workflow.verify import verify_graph

    return verify_graph(pipe.graph, context="test", **kw)


def _jverify(pipe, **kw):
    from keystone_tpu.workflow.verify import verify_graph

    return verify_graph(pipe.graph, context="test", **kw)


def _partition_codes(report):
    return [(d.code, d.severity, d.details.get("reason"), d.details.get("shards"),
             d.details.get("model_shards")) for d in report.diagnostics if d.code in ("KV203", "KV304")]


def test_verify_emits_kv203_with_partitioner_reason(mesh8):
    x, y = _data()
    report = _verify(_pipe(x[:8], y[:8]))  # 8 rows < 8 shards × 2
    jreport = _jverify(_jpipe(x[:8], y[:8]))
    assert any(d.details.get("reason") == "below-rows-floor" for d in report.by_code("KV203"))
    assert _partition_codes(report) == _partition_codes(jreport)
    assert report.partition == jreport.partition
    assert any(not p["eligible"] for p in report.partition)


@pytest.mark.parametrize("budget,fires", [(64, True), (int(1e12), False)])
def test_verify_kv304_where_the_jax_package_fires(mesh8, budget, fires):
    x, y = _data()
    report = _verify(_pipe(x, y), device_memory_bytes=budget)
    jreport = _jverify(_jpipe(x, y), device_memory_bytes=budget)
    assert bool(report.by_code("KV304")) == bool(jreport.by_code("KV304")) == fires
    assert _partition_codes(report) == _partition_codes(jreport)
    assert report.partition == jreport.partition and any(p["eligible"] for p in report.partition)
    if fires:
        err = report.by_code("KV304")[0]
        assert err.severity == "error" and err.details["shards"] == 8
        assert err.details["shards_per_card"] == 8  # eight shards on one CPU


def test_kv304_accounts_model_axis_blocking(grid2d):
    report = _verify(_pipe(X2, Y2, LinearMapEstimator(reg=1e-3, device=CPU)), device_memory_bytes=64)
    errors = report.by_code("KV304")
    assert errors and errors[0].details["model_shards"] == 4
    assert any(p.get("model_shards") == 4 for p in report.partition)
    jreport = _jverify(_jpipe(X2, Y2, JLinear(reg=1e-3)), device_memory_bytes=64)
    assert _partition_codes(report) == _partition_codes(jreport)


def test_verify_reports_the_serving_decision(mesh8):
    x, y = _data()
    report = _verify(_pipe(x, y), buckets=[8, 16], warmed_buckets=[8, 16])
    jreport = _jverify(_jpipe(x, y), buckets=[8, 16], warmed_buckets=[8, 16])
    assert report.partition[-1] == jreport.partition[-1]
    assert report.partition[-1]["kind"] == "serve" and report.partition[-1]["eligible"]


def test_explain_provenance_names_the_partition_decision(mesh8):
    """``explain``'s provenance carries the plan's decision for the node
    it names, as the JAX package's does."""
    from keystone_tpu.workflow.explain import _provenance as jprovenance
    from keystone_tpu_torch.workflow.explain import _provenance

    entry = type("Entry", (), {"node": "StreamFit[x]", "predicted_model": None, "predicted_candidates": (),
                               "kinds": ()})()
    got = tpart.Partitioner().decide_stream("StreamFit[x]", CHUNK, rows=N, record=False)
    want = jpart.Partitioner(mesh=jmesh.make_mesh(devices=jax.devices()[:8])).decide_stream(
        "StreamFit[x]", CHUNK, rows=N, record=False)
    assert _provenance(entry, {"StreamFit[x]": got}) == jprovenance(entry, {"StreamFit[x]": want}) == {
        "partition": {"eligible": True, "reason": "sharded", "shards": 8}}
    assert _provenance(entry) == {}
