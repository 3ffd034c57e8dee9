"""The least-squares family of the port on the CPU, held to the JAX
package on the same seeded numpy inputs: the cost model and the
meta-solver (``ops/learning/cost.py``, ``least_squares.py``), dense and
sparse L-BFGS (``lbfgs.py``), logistic regression, naive Bayes,
``LocalLeastSquaresEstimator``, ``SparseLinearMapper``,
``VectorSplitter`` and ``Densify``'s float32 cast.

Both packages get ``num_machines`` explicitly (the JAX conftest gives the
JAX package 8 CPU devices; the port runs on one).

Bounds, each with the value measured on the CPU:

- cost classes: bit for bit (equal floats);
- the meta-solver's pipeline against the JAX pipeline's: predictions
  ≤ 1e-5 relative (measured 9.9e-8 on the exact rung, 2.9e-7 on dense
  L-BFGS);
- dense L-BFGS against the JAX package (optax): weights ≤ 1e-5 relative
  (measured 3.5e-8–6.4e-8); the objective over the first 5 iterations
  ≤ 1e-6 relative of optax's (measured ≤ 2.2e-7; the line search's
  scalar arithmetic is float64 here, float32 in optax); against
  closed-form ridge ≤ 1e-5 relative (measured 2.4e-7);
- logistic regression against the JAX package: weights ≤ 1e-5 relative
  at λ = 0.1 (measured 9.4e-8–2.3e-7), ≤ 5e-5 unregularised (measured
  1.5e-5–2.4e-5 with different CPU thread counts;
  ``UNREG_LOGISTIC_TOL`` says why); the objective over the first 5
  iterations ≤ 1e-6 relative of optax's;
- sparse L-BFGS (measured 0.0: both are the same scipy run; also with
  the port fed one CSR block and the JAX package the same rows), naive
  Bayes, ``LocalLeastSquaresEstimator``, ``SparseLinearMapper`` and
  ``VectorSplitter``: ≤ 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import optax

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.data.dataset import ObjectDataset as JObjectDataset
from keystone_tpu.ops.learning import cost as jcost
from keystone_tpu.ops.learning import least_squares as jls
from keystone_tpu.ops.learning.lbfgs import DenseLBFGSEstimator as JDense
from keystone_tpu.ops.learning.lbfgs import SparseLBFGSEstimator as JSparse
from keystone_tpu.ops.learning.linear import LocalLeastSquaresEstimator as JLocal
from keystone_tpu.ops.learning.linear import SparseLinearMapper as JSparseMapper
from keystone_tpu.ops.learning.logistic import LogisticRegressionEstimator as JLogistic
from keystone_tpu.ops.learning.naive_bayes import NaiveBayesEstimator as JNB
from keystone_tpu.ops.util.vectors import VectorSplitter as JSplitter
from keystone_tpu.reliability import FaultSpec as JFaultSpec
from keystone_tpu.reliability import injected as jinjected
from keystone_tpu.workflow import executor as jexec
from keystone_tpu.workflow.optimize import DataStats as JDataStats
from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
from keystone_tpu_torch.ops.learning import cost as tcost
from keystone_tpu_torch.ops.learning import least_squares as tls
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSEstimator, SparseLBFGSEstimator
from keystone_tpu_torch.ops.learning.linear import (
    LinearMapEstimator,
    LocalLeastSquaresEstimator,
    SparseLinearMapper,
)
from keystone_tpu_torch.ops.learning.logistic import LogisticRegressionEstimator
from keystone_tpu_torch.ops.learning.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.ops.util.vectors import Densify, VectorSplitter
from keystone_tpu_torch.reliability import FaultSpec, injected
from keystone_tpu_torch.workflow import executor as texec
from keystone_tpu_torch.workflow.optimize import DataStats
from keystone_tpu_torch.workflow.streaming import ChunkStream

CPU = torch.device("cpu")
PARITY_TOL = 1e-5
TRACE_TOL = 1e-6
RIDGE_TOL = 1e-5
#: Unregularised softmax after 20 iterations: no minimum pins the weights,
#: which keep growing along the separating directions, so the float64
#: line-search arithmetic here and optax's float32 part by more than
#: 1e-5 (measured 1.5e-5–2.4e-5).
UNREG_LOGISTIC_TOL = 5e-5


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "profile-store.jsonl"))
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()
    yield
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def ridge_problem(n=256, d=12, k=3, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = (x @ w + noise * rng.normal(size=(n, k))).astype(np.float32)
    return x, y


def _t(a):
    return ArrayDataset(a, device=CPU)


# ------------------------------------------------------------ cost model

COST_GRID = [
    (n, d, k, s, m)
    for n in (1_000, 2_200_000, 65_000_000)
    for d in (8, 1024, 4096, 16_384)
    for k in (2, 138)
    for s in (1.0, 0.005)
    for m in (1, 8)
]


@pytest.mark.parametrize("name", ["_DenseLBFGSCost", "_SparseLBFGSCost", "_BlockSolveCost", "_ExactCost", "_SketchCost"])
def test_cost_classes_equal_the_jax_ones_bit_for_bit(name):
    jw = jcost.DEFAULT_COST_WEIGHTS
    tw = tcost.CostWeights(jw.cpu, jw.mem, jw.network)
    assert tw == tcost.DEFAULT_COST_WEIGHTS
    make = (lambda mod: getattr(mod, name)(4096)) if name == "_SketchCost" else (
        lambda mod: getattr(mod, name)())
    jmodel, tmodel = make(jls), make(tls)
    for n, d, k, s, m in COST_GRID:
        assert float(tmodel.cost(n, d, k, s, m, tw)) == float(jmodel.cost(n, d, k, s, m, jw)), (n, d, k, s, m)


def test_block_cost_with_its_parameters_equals_jax():
    jw = jcost.DEFAULT_COST_WEIGHTS
    for b, it in ((512, 1), (1000, 3), (4096, 5)):
        for n, d, k, s, m in COST_GRID[::7]:
            assert tls._BlockSolveCost(b, it).cost(n, d, k, s, m) == jls._BlockSolveCost(b, it).cost(n, d, k, s, m, jw)


def test_cuda_weights_come_from_the_card_peaks():
    w = tcost.cuda_weights("NVIDIA H100 80GB HBM3")
    assert w == tcost.CostWeights(cpu=1e3 / 67e12, mem=4e3 / 3.35e12, network=4e3 / 900e9)
    with pytest.raises(ValueError, match="weights="):
        tcost.cuda_weights("NVIDIA A100-SXM4-40GB")


def test_no_tpu_constant_is_read_on_cuda(monkeypatch):
    """On a CUDA device the default weights are the card's own, never the
    JAX package's TPU constants (first-principles or measured)."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "NVIDIA H100 80GB HBM3")
    got = tcost.default_cost_weights("cuda")
    assert got == tcost.cuda_weights("NVIDIA H100 80GB HBM3")
    tpu = [jcost.tpu_weights(), jcost.measured_tpu_weights()]
    for w in filter(None, tpu):
        assert (got.cpu, got.mem, got.network) != (w.cpu, w.mem, w.network)
    assert not hasattr(tcost, "tpu_weights") and not hasattr(tcost, "measured_tpu_weights")
    assert tcost.default_cost_weights("cpu") == tcost.DEFAULT_COST_WEIGHTS
    # The estimator resolves the same weights for its device.
    est = tls.LeastSquaresEstimator(reg=0.1, num_machines=1, device="cuda")
    costs = {name: c for name, c, _, _ in est.candidates(10_000, 8, 2, 1.0)}
    assert costs["exact"] == tls._ExactCost().cost(10_000, 8, 2, 1.0, 1, got)


# ----------------------------------------------------------- meta-solver


def _choice(package, est_kw, x, y, stats_kw):
    if package == "jax":
        est = jls.LeastSquaresEstimator(**est_kw)
        return est.optimize([JArrayDataset(x) if not isinstance(x, list) else JObjectDataset(x),
                             JArrayDataset(y)], JDataStats(**stats_kw))
    if "weights" in est_kw:
        w = est_kw["weights"]
        est_kw = dict(est_kw, weights=tcost.CostWeights(w.cpu, w.mem, w.network))
    est = tls.LeastSquaresEstimator(device=CPU, **est_kw)
    return est.optimize([_t(x) if not isinstance(x, list) else ObjectDataset(x), _t(y)],
                        DataStats(**stats_kw))


RUNG_OF = {
    "LinearMapEstimator": "exact", "BlockLeastSquaresEstimator": "block",
    "DenseLBFGSEstimator": "dense_lbfgs", "SparseLBFGSEstimator": "sparse_lbfgs",
    "SketchedLeastSquaresEstimator": "sketched",
}


def _meta_cases():
    """The JAX cases of ``tests/ops/test_learning_supervised.py``'s
    meta-solver tests: (label, estimator kwargs, x, y, stats kwargs)."""
    rng = np.random.default_rng(0)
    cases = [(
        "small_dense", dict(reg=0.1, num_machines=8),
        np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32),
        np.random.default_rng(1).normal(size=(100, 2)).astype(np.float32),
        dict(n_total=100_000, num_shards=8, n_per_shard=[12500] * 8),
    )]
    rows = [sp.csr_matrix((rng.random((1, 20000)) < 0.004) * 1.0) for _ in range(50)]
    cases.append(("sparse", dict(reg=0.1, num_machines=8), rows,
                  rng.normal(size=(50, 2)).astype(np.float32),
                  dict(n_total=65_000_000, num_shards=8, n_per_shard=[1] * 8)))
    y = rng.normal(size=(64, 2)).astype(np.float32)
    for d in (1024, 4096, 16384):
        cases.append((
            f"crossover_d{d}", dict(reg=0.1, weights=jcost.tpu_weights(), num_machines=8),
            rng.normal(size=(64, d)).astype(np.float32), y,
            dict(n_total=2_200_000, num_shards=8, n_per_shard=[275_000] * 8),
        ))
    return cases


@pytest.mark.parametrize("case", _meta_cases(), ids=lambda c: c[0])
def test_optimize_picks_the_jax_rung(case):
    _, est_kw, x, y, stats_kw = case
    jchosen = _choice("jax", est_kw, x, y, stats_kw)
    want = RUNG_OF[type(jchosen).__name__]
    tchosen = _choice("port", est_kw, x, y, stats_kw)
    assert RUNG_OF[type(tchosen).__name__] == want
    # The same provenance: every candidate, its price and its reason.
    jc = jchosen.predicted_cost.candidates
    tc = tchosen.predicted_cost.candidates
    assert [c[0] for c in tc] == [c[0] for c in jc]
    assert [c[1] for c in tc] == [c[1] for c in jc]
    assert [c[2] for c in tc] == [c[2] for c in jc]
    assert tchosen.predicted_cost.seconds == jchosen.predicted_cost.seconds
    assert tchosen.predicted_cost.shape == jchosen.predicted_cost.shape


def test_a_csr_block_is_priced_as_the_jax_package_prices_its_rows():
    """One ``ObjectDataset`` item holding a block of CSR rows (the JAX
    sweep's form) gets the density, pick and prices that the JAX package
    gives the same rows one per item."""
    rng = np.random.default_rng(0)
    rows = [sp.csr_matrix((rng.random((1, 20000)) < 0.004) * 1.0) for _ in range(32)]
    y = rng.normal(size=(32, 2)).astype(np.float32)
    block = ObjectDataset([sp.vstack(rows, format="csr")])
    assert tls._sample_shape_stats(block, _t(y)) == jls._sample_shape_stats(
        JObjectDataset(rows), JArrayDataset(y))
    est_kw = dict(reg=0.1, num_machines=8)
    stats_kw = dict(n_total=65_000_000, num_shards=8, n_per_shard=[1] * 8)
    jchosen = _choice("jax", est_kw, rows, y, stats_kw)
    tchosen = tls.LeastSquaresEstimator(device=CPU, **est_kw).optimize(
        [block, _t(y)], DataStats(**stats_kw))
    assert RUNG_OF[type(tchosen).__name__] == RUNG_OF[type(jchosen).__name__] == "sparse_lbfgs"
    assert tchosen.predicted_cost.candidates == jchosen.predicted_cost.candidates


def test_meta_solver_pipeline_on_a_csr_block_matches_jax_on_its_rows():
    """The meta-solver's pipeline fed one CSR block picks sparse L-BFGS
    and predicts as the JAX pipeline fed the same rows one per item."""
    rng = np.random.default_rng(0)
    x = sp.random(2048, 1024, density=0.002, format="csr", random_state=1, dtype=np.float32)
    y = rng.normal(size=(2048, 2)).astype(np.float32)
    rows = [x[i] for i in range(x.shape[0])]
    kw = dict(reg=0.1, num_machines=1)
    tpipe = tls.LeastSquaresEstimator(device=CPU, **kw).with_data(ObjectDataset([x]), _t(y))
    optimized, _ = texec.PipelineEnv.get_or_create().optimizer.execute(tpipe.graph)
    picked = [type(op).__name__ for op in optimized.operators.values()]
    assert "SparseLBFGSEstimator" in picked
    jpipe = jls.LeastSquaresEstimator(**kw).with_data(JObjectDataset(rows), JArrayDataset(y))
    got = tpipe(ObjectDataset([x[:64]])).get().data.numpy()[:64]
    want = np.asarray(jpipe(JObjectDataset(rows[:64])).get().data)[:64]
    assert _rel(got, want) <= PARITY_TOL


def test_sketch_pricing_follows_the_environment(monkeypatch):
    """KEYSTONE_SKETCH_MIN_WIDTH and KEYSTONE_SKETCH_SIZE price the
    sketched rung as they do in the JAX package."""
    monkeypatch.setenv("KEYSTONE_SKETCH_MIN_WIDTH", "1024")
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", "256")
    w = jcost.tpu_weights()
    tw = tcost.CostWeights(w.cpu, w.mem, w.network)
    t = {c[0]: c[1] for c in tls.LeastSquaresEstimator(weights=tw, num_machines=8, device=CPU)
         .candidates(2_200_000, 2048, 2, 1.0)}
    from keystone_tpu.sketch.solvers import SketchedLeastSquaresEstimator

    s = SketchedLeastSquaresEstimator(reg=0.0)._resolve_sketch_size(2048)
    assert s == 256
    assert t["sketched"] == jls._SketchCost(s).cost(2_200_000, 2048, 2, 1.0, 8, w)


def test_stream_solver_raises_at_the_sketch_width():
    """The streamed width dispatch: exact, then block, then — from
    ``KEYSTONE_SKETCH_MIN_WIDTH`` on — the sketched rung (ported: it no
    longer raises), on the meta-solver's device; the refit state methods
    answer instead of raising."""
    from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator

    est = tls.LeastSquaresEstimator(reg=0.1, device=CPU)
    assert isinstance(est._stream_solver(512), LinearMapEstimator)
    assert isinstance(est._stream_solver(4096), BlockLeastSquaresEstimator)
    sketched = est._stream_solver(8192)
    assert isinstance(sketched, SketchedLeastSquaresEstimator)
    assert sketched.reg == 0.1 and sketched.device == CPU
    assert est.export_stream_state() is None
    x, y = ridge_problem(n=256, d=12, k=3)
    states = []
    for rows in (slice(0, 128), slice(128, 256)):
        part = LinearMapEstimator(reg=0.1, device=CPU)
        part.fit_stream(ChunkStream(_t(x[rows]), _t(y[rows]), (), chunk_rows=64, device=CPU))
        states.append(part.export_stream_state())
    merged = est.merge_stream_state(*states)
    assert merged.num_examples == 256
    whole = LinearMapEstimator(reg=0.1, device=CPU).fit(_t(x), _t(y))
    xt = torch.as_tensor(x)
    assert _rel(est.finish_from_state(merged).apply_arrays(xt).numpy(),
                whole.apply_arrays(xt).numpy()) <= PARITY_TOL


def test_num_machines_none_resolves_to_one():
    est = tls.LeastSquaresEstimator(device=CPU)
    one = tls.LeastSquaresEstimator(num_machines=1, device=CPU)
    assert est.candidates(10_000, 64, 2, 1.0)[1][1] == one.candidates(10_000, 64, 2, 1.0)[1][1]


def _pipeline_predictions(package, x, y, xt, est_kw):
    if package == "jax":
        est = jls.LeastSquaresEstimator(**est_kw)
        pipe = est.with_data(JArrayDataset(x), JArrayDataset(y))
        return np.asarray(pipe(JArrayDataset(xt)).get().data)
    kw = dict(est_kw)
    if "weights" in kw:
        kw["weights"] = tcost.CostWeights(kw["weights"].cpu, kw["weights"].mem, kw["weights"].network)
    est = tls.LeastSquaresEstimator(device=CPU, **kw)
    pipe = est.with_data(_t(x), _t(y))
    return pipe(_t(xt)).get().data.numpy()


@pytest.mark.parametrize("d,weights,rung", [
    (16, None, "exact"),
    # flops priced alone: 20 L-BFGS passes (3.9e6 flops) undercut the
    # exact solve's Gram and factor (1.1e7) at d = 128.
    (128, jcost.CostWeights(cpu=1.0, mem=1e-12, network=1e-12), "dense_lbfgs"),
])
def test_pipeline_with_the_meta_solver_matches_jax(d, weights, rung):
    """Node-level optimization swaps the meta-solver for its rung in both
    packages; the fitted pipelines' predictions agree."""
    x, y = ridge_problem(n=512, d=d, k=3)
    xt, _ = ridge_problem(n=64, d=d, k=3, seed=5)
    kw = dict(reg=0.1, num_machines=1)
    if weights is not None:
        kw["weights"] = weights
    jp = _pipeline_predictions("jax", x, y, xt, kw)
    tp = _pipeline_predictions("port", x, y, xt, kw)
    assert _rel(tp, jp) <= PARITY_TOL
    # Which rung ran: the port's optimizer replaced the node with it.
    est = tls.LeastSquaresEstimator(device=CPU, **{k: v for k, v in kw.items() if k != "weights"},
                                    weights=None if weights is None else tcost.CostWeights(
                                        weights.cpu, weights.mem, weights.network))
    chosen = est.optimize([_t(x[:100]), _t(y[:100])], DataStats(512, 1, [512]))
    assert RUNG_OF[type(chosen).__name__] == rung


def test_a_sketched_pick_fails_the_plan_instead_of_falling_back(monkeypatch):
    """The cost model picks the sketched rung in both packages; the port's
    plan fits through it (no fallback, no failure: the rung is ported)
    and its predictions match the JAX pipeline's (measured 4.4e-7). Both
    packages read ``KEYSTONE_SKETCH_REFINE``: 32 PCG iterations converge
    at the default s = 2d, where the default 16 stop short and fp32
    round-off parts the packages by 1.8e-5."""
    monkeypatch.setenv("KEYSTONE_SKETCH_MIN_WIDTH", "16")
    monkeypatch.setenv("KEYSTONE_SKETCH_REFINE", "32")
    x, y = ridge_problem(n=4096, d=64, k=2)
    kw = dict(reg=0.1, num_machines=1)
    weights = (1.0, 1.0, 1.0)
    est = tls.LeastSquaresEstimator(device=CPU, weights=tcost.CostWeights(*weights), **kw)
    pipe = est.with_data(_t(x), _t(y))
    optimized, _ = texec.PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    picked = [type(getattr(op, "estimator", op)).__name__ for op in optimized.operators.values()]
    assert "SketchedLeastSquaresEstimator" in picked
    got = pipe(_t(x[:64])).get().data.numpy()[:64]
    jpipe = jls.LeastSquaresEstimator(weights=jcost.CostWeights(*weights), **kw).with_data(
        JArrayDataset(x), JArrayDataset(y))
    want = np.asarray(jpipe(JArrayDataset(x[:64])).get().data)[:64]
    assert _rel(got, want) <= PARITY_TOL


def _fit_ladder(package, spec):
    x, y = ridge_problem(n=256, d=24, k=2)
    if package == "jax":
        est = jls.LeastSquaresEstimator(reg=0.1, block_size=8, block_iters=2)
        with jinjected(JFaultSpec(**spec)):
            return est.fit(JArrayDataset(x), JArrayDataset(y))
    est = tls.LeastSquaresEstimator(reg=0.1, block_size=8, block_iters=2, device=CPU)
    with injected(FaultSpec(**spec)):
        return est.fit(_t(x), _t(y))


@pytest.mark.parametrize("spec", [
    dict(match="LeastSquaresEstimator.solve", kind="oom", first_n=1),
    dict(match="BlockLeastSquaresEstimator.solve", kind="oom", first_n=1),
])
def test_fit_ladder_records_the_same_degradation_as_jax(spec):
    """An OOM at the first rung steps down to ``block``; an OOM in the
    block solver only (after the L-BFGS rung held) degrades nothing."""
    jm, tm = _fit_ladder("jax", spec), _fit_ladder("port", spec)
    jd, td = getattr(jm, "degradation", None), getattr(tm, "degradation", None)
    assert td == jd
    x, _ = ridge_problem(n=32, d=24, k=2, seed=3)
    assert _rel(tm.apply_arrays(torch.as_tensor(x)).numpy(), np.asarray(jm.apply_arrays(jnp.asarray(x)))) <= PARITY_TOL


def test_fit_ladder_nests_the_block_solvers_own_degradation():
    spec = [dict(match="LeastSquaresEstimator.solve", kind="oom", first_n=1),
            dict(match="BlockLeastSquaresEstimator.solve", kind="oom", first_n=1)]
    x, y = ridge_problem(n=256, d=24, k=2)
    with jinjected(*[JFaultSpec(**s) for s in spec]):
        jm = jls.LeastSquaresEstimator(reg=0.1, block_size=8, block_iters=2).fit(JArrayDataset(x), JArrayDataset(y))
    with injected(*[FaultSpec(**s) for s in spec]):
        tm = tls.LeastSquaresEstimator(reg=0.1, block_size=8, block_iters=2, device=CPU).fit(_t(x), _t(y))
    assert tm.degradation == jm.degradation
    assert tm.degradation["inner"]["rung"] == 4


# ---------------------------------------------------------------- L-BFGS


@pytest.mark.parametrize("reg,iters", [(0.5, 80), (1e-3, 20), (0.0, 100)])
def test_dense_lbfgs_weights_match_jax(reg, iters):
    x, y = ridge_problem()
    jm = JDense(reg=reg, num_iterations=iters).fit(JArrayDataset(x), JArrayDataset(y))
    tm = DenseLBFGSEstimator(reg=reg, num_iterations=iters, device=CPU).fit(_t(x), _t(y))
    assert _rel(tm.weights, jm.weights) <= PARITY_TOL
    assert _rel(tm.intercept, jm.intercept) <= PARITY_TOL
    assert _rel(tm.feature_mean, jm.feature_mean) <= PARITY_TOL


def test_dense_lbfgs_matches_closed_form_ridge():
    x, y = ridge_problem()
    reg, n = 0.5, len(x)
    xc, yc = x - x.mean(0), y - y.mean(0)
    expected = np.linalg.solve(xc.T @ xc / n + reg * np.eye(x.shape[1]), xc.T @ yc / n)
    model = DenseLBFGSEstimator(reg=reg, num_iterations=80, device=CPU).fit(_t(x), _t(y))
    assert _rel(model.weights, expected) <= RIDGE_TOL


def _optax_objective(loss, w0, iterations):
    """optax.lbfgs(memory_size=10) driven as the JAX package's loop drives
    it; the objective at each iterate."""
    solver = optax.lbfgs(memory_size=10)
    value_and_grad = optax.value_and_grad_from_state(loss)
    w, state = w0, solver.init(w0)
    values = [float(loss(w))]
    for _ in range(iterations):
        value, grad = value_and_grad(w, state=state)
        updates, state = solver.update(grad, state, w, value=value, grad=grad, value_fn=loss)
        w = optax.apply_updates(w, updates)
        values.append(float(loss(w)))
    return np.asarray(values)


@pytest.mark.parametrize("reg", [0.5, 1e-3])
def test_dense_lbfgs_objective_follows_optax(reg):
    x, y = ridge_problem()
    n = len(x)
    xc, yc = jnp.asarray(x - x.mean(0)), jnp.asarray(y - y.mean(0))

    def loss(w):
        r = xc @ w - yc
        return 0.5 * jnp.sum(r * r) / n + 0.5 * reg * jnp.sum(w * w)

    want = _optax_objective(loss, jnp.zeros((x.shape[1], y.shape[1])), 5)
    model = DenseLBFGSEstimator(reg=reg, num_iterations=5, device=CPU).fit(_t(x), _t(y))
    got = np.asarray(model.lbfgs["objective"])
    assert model.lbfgs["iterations"] == 5 and len(got) == 6
    assert np.max(np.abs(got - want) / np.abs(want)) <= TRACE_TOL


def test_lbfgs_stops_at_the_gradient_tolerance_as_jax_does():
    """A large tol stops after the first step (the norm tested is the
    gradient the previous step started from)."""
    x, y = ridge_problem()
    model = DenseLBFGSEstimator(reg=0.5, num_iterations=50, tol=1e9, device=CPU).fit(_t(x), _t(y))
    jm = JDense(reg=0.5, num_iterations=50, tol=1e9).fit(JArrayDataset(x), JArrayDataset(y))
    assert model.lbfgs["iterations"] == 1
    assert _rel(model.weights, jm.weights) <= PARITY_TOL


def _logistic_problem(n=300, d=10, classes=3, seed=4):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, classes, size=n)
    x = (rng.normal(size=(classes, d))[cls] * 2 + rng.normal(size=(n, d))).astype(np.float32)
    return x, cls.astype(np.int32)


@pytest.mark.parametrize("reg,iters,tol", [(0.1, 50, PARITY_TOL), (0.0, 20, UNREG_LOGISTIC_TOL)])
def test_logistic_weights_match_jax(reg, iters, tol):
    x, y = _logistic_problem()
    jm = JLogistic(3, reg=reg, num_iterations=iters).fit(JArrayDataset(x), JArrayDataset(y))
    tm = LogisticRegressionEstimator(3, reg=reg, num_iterations=iters, device=CPU).fit(_t(x), _t(y))
    assert _rel(tm.weights, jm.weights) <= tol
    assert (tm.apply_arrays(torch.as_tensor(x)).argmax(1).numpy() == y).mean() > 0.9


def test_logistic_objective_follows_optax():
    x, y = _logistic_problem()
    n, reg = len(x), 0.1
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss(w):
        logp = jnp.asarray(xj @ w)
        logp = logp - jnp.log(jnp.sum(jnp.exp(logp - logp.max(1, keepdims=True)), 1, keepdims=True)) - logp.max(1, keepdims=True)
        return -jnp.sum(jnp.take_along_axis(logp, yj[:, None], 1)) / n + 0.5 * reg * jnp.sum(w * w)

    want = _optax_objective(loss, jnp.zeros((x.shape[1], 3)), 5)
    model = LogisticRegressionEstimator(3, reg=reg, num_iterations=5, device=CPU).fit(_t(x), _t(y))
    got = np.asarray(model.lbfgs["objective"])
    assert np.max(np.abs(got - want) / np.abs(want)) <= TRACE_TOL


def _sparse_rows(n=200, d=300, density=0.02, seed=7):
    rng = np.random.default_rng(seed)
    mat = sp.random(n, d, density=density, random_state=seed, format="csr", dtype=np.float64)
    y = rng.normal(size=(n, 2)).astype(np.float32)
    return [mat[i] for i in range(n)], y


def test_sparse_lbfgs_matches_jax():
    rows, y = _sparse_rows()
    jm = JSparse(reg=1e-3, num_iterations=30).fit(JObjectDataset(rows), JArrayDataset(y))
    tm = SparseLBFGSEstimator(reg=1e-3, num_iterations=30, device=CPU).fit(ObjectDataset(rows), _t(y))
    assert isinstance(tm, SparseLinearMapper)
    assert _rel(tm.weights, jm.weights) <= PARITY_TOL
    jp = np.asarray(jm.apply_batch(JObjectDataset(rows)).data)
    tp = tm.apply_batch(ObjectDataset(rows)).data.numpy()
    assert _rel(tp, jp) <= PARITY_TOL
    assert _rel(tm.apply(rows[3]).numpy(), np.asarray(jm.apply(rows[3]))) <= PARITY_TOL


def test_sparse_lbfgs_stops_at_the_gradient_norm():
    rows, y = _sparse_rows()
    jm = JSparse(reg=1e-3, num_iterations=30, tol=1e-2).fit(JObjectDataset(rows), JArrayDataset(y))
    tm = SparseLBFGSEstimator(reg=1e-3, num_iterations=30, tol=1e-2, device=CPU).fit(ObjectDataset(rows), _t(y))
    assert _rel(tm.weights, jm.weights) <= PARITY_TOL


def test_sparse_linear_mapper_with_intercept_matches_jax():
    rows, _ = _sparse_rows(n=20)
    w = np.random.default_rng(1).normal(size=(300, 3)).astype(np.float32)
    b = np.asarray([0.5, -1.0, 2.0], np.float32)
    jm = JSparseMapper(w, intercept=b)
    tm = SparseLinearMapper(torch.as_tensor(w), intercept=torch.as_tensor(b))
    assert _rel(tm.apply_batch(ObjectDataset(rows)).data.numpy(),
                np.asarray(jm.apply_batch(JObjectDataset(rows)).data)) <= PARITY_TOL
    dense = np.stack([r.toarray().ravel() for r in rows]).astype(np.float32)
    assert _rel(tm.apply_batch(_t(dense)).data.numpy(),
                np.asarray(jm.apply_batch(JArrayDataset(dense)).data)) <= PARITY_TOL


@pytest.mark.parametrize("reg", [0.0, 0.5])
def test_local_least_squares_matches_jax(reg):
    x, y = ridge_problem(n=128, d=10, k=2)
    jm = JLocal(reg=reg).fit(JArrayDataset(x), JArrayDataset(y))
    tm = LocalLeastSquaresEstimator(reg=reg, device=CPU).fit(_t(x), _t(y))
    assert tm.weights.device == CPU and tm.weights.dtype == torch.float32
    assert _rel(tm.weights, jm.weights) <= PARITY_TOL
    xt, _ = ridge_problem(n=16, d=10, k=2, seed=9)
    assert _rel(tm.apply_arrays(torch.as_tensor(xt)).numpy(), np.asarray(jm.apply_arrays(jnp.asarray(xt)))) <= PARITY_TOL


# ----------------------------------------------------------- naive Bayes


@pytest.mark.parametrize("smoothing", [1.0, 0.25])
def test_naive_bayes_matches_jax(smoothing):
    rng = np.random.default_rng(2)
    x = rng.poisson(0.3, size=(120, 40)).astype(np.float32)
    y = rng.integers(0, 5, size=120).astype(np.int32)
    jm = JNB(5, smoothing=smoothing).fit(JArrayDataset(x), JArrayDataset(y))
    tm = NaiveBayesEstimator(5, smoothing=smoothing, device=CPU).fit(_t(x), _t(y))
    assert np.max(np.abs(tm.pi.numpy() - np.asarray(jm.pi))) <= PARITY_TOL
    assert np.max(np.abs(tm.theta.numpy() - np.asarray(jm.theta))) <= PARITY_TOL
    xt = rng.poisson(0.3, size=(10, 40)).astype(np.float32)
    assert _rel(tm.apply_arrays(torch.as_tensor(xt)).numpy(), np.asarray(jm.apply_arrays(jnp.asarray(xt)))) <= PARITY_TOL


def test_naive_bayes_from_integer_labels_in_an_object_dataset():
    rng = np.random.default_rng(3)
    x = rng.poisson(0.5, size=(60, 12)).astype(np.float32)
    labels = [int(v) for v in rng.integers(0, 3, size=60)]
    jm = JNB(3).fit(JArrayDataset(x), JObjectDataset(labels))
    tm = NaiveBayesEstimator(3, device=CPU).fit(_t(x), ObjectDataset(labels))
    assert np.max(np.abs(tm.theta.numpy() - np.asarray(jm.theta))) <= PARITY_TOL


# ------------------------------------------------------------- vectors


@pytest.mark.parametrize("d,block", [(10, 4), (12, 4), (5, 8)])
def test_vector_splitter_matches_jax(d, block):
    x = np.arange(6 * d, dtype=np.float32).reshape(6, d)
    jb = JSplitter(block).split(JArrayDataset(x))
    src = _t(x)
    tb = VectorSplitter(block).split(src)
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        assert t.data.data_ptr() >= src.data.data_ptr()  # a view, not a copy
        assert t.data.untyped_storage().data_ptr() == src.data.untyped_storage().data_ptr()
    assert [np.asarray(v).tolist() for v in VectorSplitter(block).apply(x[0])] == \
        [np.asarray(v).tolist() for v in JSplitter(block).apply(x[0])]
    assert len(VectorSplitter(block).apply_batch(src)) == len(jb)


def test_densify_casts_before_densifying_with_equal_values():
    """The float32 cast now happens on the CSR rows: the dense matrix is
    bitwise the one the float64 densify-then-cast made."""
    from keystone_tpu_torch.utils.sparse import csr_row

    rng = np.random.default_rng(0)
    rows = [csr_row({int(j): 1.0 for j in rng.choice(500, size=9, replace=False)}, 500) for _ in range(40)]
    rows.append(csr_row({3: 2.0, 7: 0.1}, 500))
    old = sp.vstack(rows).toarray().astype(np.float32)
    got = Densify(device=CPU).apply_batch(ObjectDataset(rows)).data
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), old)


@pytest.mark.parametrize("d,rung", [(24, LinearMapEstimator), (48, BlockLeastSquaresEstimator)])
def test_fit_stream_dispatches_by_width_as_jax(d, rung):
    """The streamed fit picks exact (width ≤ block) or Gram-BCD (wider)
    and matches the JAX meta-solver's streamed fit."""
    from keystone_tpu.workflow.streaming import ChunkStream as JChunkStream
    from keystone_tpu_torch.workflow.streaming import ChunkStream

    x, y = ridge_problem(n=512, d=d, k=3, seed=4)
    est = tls.LeastSquaresEstimator(reg=1e-2, block_size=32, block_iters=3, device=CPU)
    assert isinstance(est._stream_solver(d), rung)
    ours = est.fit_stream(ChunkStream(_t(x), _t(y), (), chunk_rows=128, device=CPU))
    ref = jls.LeastSquaresEstimator(reg=1e-2, block_size=32, block_iters=3).fit_stream(
        JChunkStream(JArrayDataset(x), JArrayDataset(y), (), chunk_rows=128))
    assert _rel(ours.apply_arrays(torch.as_tensor(x)).numpy(), np.asarray(ref.apply_arrays(jnp.asarray(x)))) <= PARITY_TOL
