"""The TIMIT path of the port (``keystone_tpu_torch/pipelines/timit.py``,
``data/loaders/timit.py``) and its solvers on the CPU: mirrors of
``tests/pipelines/test_timit.py``, parity with the JAX pipeline on the same
seeded inputs, the exact-solver and host-streaming cases of
``tests/ops/test_learning_linear.py`` and ``tests/parallel/test_linalg.py``
against the JAX package, and the ``timit`` CLI workload.

Bounds, each with the value measured on the CPU:

- ``synthetic_timit`` and the random-feature weights: exact;
- the small pipeline (2 × 256 cosine features, λ = 5, one epoch): test
  features ≤ 1e-6 (measured 4.4e-7), scores ≤ 1e-4 relative (measured
  1.7e-7; the block solve rounds in another order in XLA on 8 shards
  than in PyTorch's BLAS/LAPACK, as ``tests/test_torch_slice.py``
  bounds it), predictions equal on ≥ 99% of rows (measured 100%);
- ``LinearMapEstimator`` against the JAX package: weights ≤ 1e-5
  (measured 4.0e-8 unregularised, 3.3e-8 at λ = 1);
- host-streamed against in-core BCD: ≤ 1e-5 absolute on predictions, the
  JAX test's bound.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JBlock
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinear
from keystone_tpu.pipelines import timit as jt
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.ops.learning import block as tblock
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.pipelines import timit as t
from keystone_tpu_torch.workflow.executor import PipelineEnv

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SCORE_TOL, PRED_SHARE = 1e-4, 0.99


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def small_config(module=t, **kw):
    defaults = dict(num_cosines=2, num_cosine_features=256, reg=5.0, num_epochs=1)
    defaults.update(kw)
    return module.TimitConfig(**defaults)


# ------------------------------------------------- mirrors of test_timit.py


def test_end_to_end_synthetic():
    config = small_config()
    train = t.synthetic_timit(1024, seed=0, device=CPU)
    pipeline = t.build_pipeline(config, train, device=CPU)
    metrics = MulticlassClassifierEvaluator(t.NUM_CLASSES).evaluate(pipeline(train.data), train.labels)
    # 147 classes → chance error ≈ 99.3%; features must do much better.
    assert metrics.total_error < 0.8, metrics.summary()


def test_featurizer_output_width():
    config = small_config(num_cosines=3)
    train = t.synthetic_timit(64, seed=1, device=CPU)
    feats = t.build_featurizer(config, device=CPU)(train.data).get()
    assert tuple(feats.data.shape) == (64, 3 * 256)


def test_cauchy_variant_runs():
    config = small_config(rf_type="cauchy")
    train = t.synthetic_timit(256, seed=2, device=CPU)
    preds = t.build_pipeline(config, train, device=CPU)(train.data).get()
    assert len(preds.data) >= 256


def _write_timit_fixture(tmp_path):
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        n = 6 if split == "train" else 4
        np.savetxt(tmp_path / f"{split}.csv", rng.normal(size=(n, 5)), delimiter=",")
        lines = [f"{i + 1} {(i % 3) + 1}" for i in range(n)]
        (tmp_path / f"{split}.lab").write_text("\n".join(lines) + "\n")
    return [str(tmp_path / f) for f in ("train.csv", "train.lab", "test.csv", "test.lab")]


def test_timit_loader(tmp_path):
    """Features CSV + 1-indexed sparse label files
    (reference: TimitFeaturesDataLoader.scala:326-390), as the JAX loader
    reads them."""
    paths = _write_timit_fixture(tmp_path)
    data = t.load_timit(*paths, device=CPU)
    assert len(data.train.data) == 6 and len(data.test.data) == 4
    np.testing.assert_array_equal(data.train.labels.data.numpy(), np.array([0, 1, 2, 0, 1, 2]))
    jdata = jt.load_timit(*paths)
    np.testing.assert_array_equal(data.test.data.data.numpy(), np.asarray(jdata.test.data.data))
    np.testing.assert_array_equal(data.test.labels.data.numpy(), np.asarray(jdata.test.labels.data))


# ---------------------------------------------------- parity with the JAX run


def test_synthetic_timit_draws_the_jax_arrays():
    for n, seed in ((64, 0), (32, 124)):
        got, want = t.synthetic_timit(n, seed=seed, device=CPU), jt.synthetic_timit(n, seed=seed)
        np.testing.assert_array_equal(got.data.data.numpy(), np.asarray(want.data.data))
        np.testing.assert_array_equal(got.labels.data.numpy(), np.asarray(want.labels.data))


def test_small_pipeline_matches_the_jax_pipeline():
    train, test = t.synthetic_timit(1024, seed=0, device=CPU), t.synthetic_timit(256, seed=1, device=CPU)
    jtrain, jtest = jt.synthetic_timit(1024, seed=0), jt.synthetic_timit(256, seed=1)
    pred = t.build_pipeline(small_config(), train, device=CPU)(test.data).get().data.numpy()
    jpred = np.asarray(jt.build_pipeline(small_config(jt), jtrain)(jtest.data).get().data)
    assert np.mean(pred[: len(jpred)] == jpred[: len(pred)]) >= PRED_SHARE

    # Scores before the argmax: the same featurizer and estimator fitted
    # directly, applied to the test rows.
    from keystone_tpu.ops.util.labels import ClassLabelIndicators as JIndicators
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators

    feat = t.build_featurizer(small_config(), device=CPU)
    jfeat = jt.build_featurizer(small_config(jt))
    x, xt = feat(train.data).get(), feat(test.data).get().data
    jx, jxt = jfeat(jtrain.data).get(), jfeat(jtest.data).get().data
    assert _rel(xt, jxt) <= 1e-6
    y = ClassLabelIndicators(t.NUM_CLASSES)(train.labels).get()
    jy = JIndicators(jt.NUM_CLASSES)(jtrain.labels).get()
    model = BlockLeastSquaresEstimator(256, num_iter=1, reg=5.0, device=CPU).fit(x, y)
    jmodel = JBlock(256, num_iter=1, reg=5.0).fit(jx, jy)
    assert _rel(model.apply_arrays(xt), jmodel.apply_arrays(jxt)) <= SCORE_TOL


def test_timit_cli_on_the_cpu():
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "timit", "--num-cosines", "1",
           "--num-cosine-features", "256", "--num-epochs", "1", "--reg", "5", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["workload"] == "timit" and 0.0 <= line["train_error"] < 0.9
    assert 0.0 <= line["test_error"] <= 1.0 and line["seconds"] > 0


def test_timit_cli_lists_the_workload():
    from keystone_tpu_torch.cli import WORKLOADS

    assert WORKLOADS["timit"][:3] == ("timit", "TimitConfig", "run")


# --------------------------------- exact solver: test_learning_linear parity


def make_problem(n=256, d=16, k=4, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    b = rng.normal(size=(k,)).astype(np.float32)
    y = x @ w + b + noise * rng.normal(size=(n, k)).astype(np.float32)
    return x, y, w, b


def closed_form(x, y, reg=0.0):
    mu_a, mu_b = x.mean(0), y.mean(0)
    xc, yc = x - mu_a, y - mu_b
    return np.linalg.solve(xc.T @ xc + reg * np.eye(x.shape[1]), xc.T @ yc), mu_a, mu_b


def _fit_both(x, y, reg):
    model = LinearMapEstimator(reg=reg, device=CPU).fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    jmodel = JLinear(reg=reg).fit(JArrayDataset(x), JArrayDataset(y))
    return model, jmodel


def test_linear_map_estimator_recovers_model():
    x, y, w_true, _ = make_problem()
    model, jmodel = _fit_both(x, y, None)
    pred = model.apply_batch(ArrayDataset(x, device=CPU)).data.numpy()
    np.testing.assert_allclose(pred, y, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(model.weights.numpy(), w_true, rtol=1e-2, atol=1e-2)
    assert _rel(model.weights, jmodel.weights) <= 1e-5


@pytest.mark.parametrize("mode", ["refine", "highest", "high", "default"])
def test_linear_map_estimator_ridge_in_every_mode(mode, monkeypatch):
    """Each mode (read at fit time) matches the closed form and the JAX
    package's fit under the same mode."""
    monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", mode)
    x, y, _, _ = make_problem(noise=0.3, seed=7)
    w_exp, _, mu_b = closed_form(x, y, 1.0)
    checks = tlinalg.centered_solve_refined.guard_checks
    model, jmodel = _fit_both(x, y, 1.0)
    # Only refine takes a fast Gram and refinement steps, so only refine
    # reaches the guard's decision.
    assert tlinalg.centered_solve_refined.guard_checks == checks + (mode == "refine")
    np.testing.assert_allclose(model.weights.numpy(), w_exp, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(model.intercept.numpy(), mu_b, atol=1e-4)
    assert _rel(model.weights, jmodel.weights) <= 1e-5


def test_linear_map_single_datum():
    x, y, _, _ = make_problem()
    model = LinearMapEstimator(device=CPU).fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    np.testing.assert_allclose(model.apply(x[0]).numpy(), y[0], rtol=5e-2, atol=5e-2)


def test_exact_solver_singular_without_reg_raises():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(32, 64)).astype(np.float32)  # rank < d
    y = rng.normal(size=(32, 3)).astype(np.float32)
    with pytest.raises((FloatingPointError, torch.linalg.LinAlgError)):
        LinearMapEstimator(device=CPU).fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))


# ----------------------------------------------------- host-streamed BCD


@pytest.mark.parametrize("d,block", [(24, 8), (10, 4)])
def test_host_streamed_block_least_squares_matches_jax(d, block):
    """``host_streaming=True`` on both packages (test_learning_linear's
    converge and feature-padding problems): predictions to the JAX
    package's, and to the port's in-core fit."""
    x, y, _, _ = make_problem(n=512 if d == 24 else 128, d=d, k=3 if d == 24 else 2, noise=0.1)
    reg, epochs = (0.5, 40) if d == 24 else (0.1, 30)
    data, labels = ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)
    streamed = BlockLeastSquaresEstimator(block, num_iter=epochs, reg=reg, device=CPU, host_streaming=True).fit(data, labels)
    in_core = BlockLeastSquaresEstimator(block, num_iter=epochs, reg=reg, device=CPU).fit(data, labels)
    jmodel = JBlock(block, num_iter=epochs, reg=reg, host_streaming=True).fit(JArrayDataset(x), JArrayDataset(y))
    p = streamed.apply_arrays(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(p, in_core.apply_arrays(torch.from_numpy(x)).numpy(), atol=1e-5)
    np.testing.assert_allclose(p, np.asarray(jmodel.apply_arrays(jnp.asarray(x))), atol=1e-5)
    w_exp, mu_a, mu_b = closed_form(x, y, reg)
    np.testing.assert_allclose(p, (x - mu_a) @ w_exp + mu_b, rtol=5e-2, atol=5e-2)


def test_host_streaming_auto_rule(monkeypatch):
    """None streams exactly when a CPU-tensor matrix above
    ``KEYSTONE_STREAM_BYTES`` (default 4e9) is fitted on a card."""
    cuda = torch.device("cuda")
    x = torch.zeros(100, 10)  # 4,000 bytes
    monkeypatch.delenv("KEYSTONE_STREAM_BYTES", raising=False)
    assert tblock._host_streaming_threshold_bytes() == int(4e9)
    assert not tblock._auto_host_streaming(x, cuda)
    monkeypatch.setenv("KEYSTONE_STREAM_BYTES", "3999")
    assert tblock._auto_host_streaming(x, cuda)
    assert not tblock._auto_host_streaming(x, CPU)  # a CPU fit never streams by itself


def test_host_streaming_underdetermined_without_reg_still_learns():
    """test_learning_linear's λ-floor case through the streamed fit."""
    rng = np.random.default_rng(11)
    n, d, k = 128, 512, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = x @ rng.normal(size=(d, k)).astype(np.float32)
    model = BlockLeastSquaresEstimator(256, num_iter=3, reg=0.0, device=CPU, host_streaming=True).fit(
        ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)
    )
    pred = model.apply_arrays(torch.from_numpy(x)).numpy()
    assert np.isfinite(pred).all() and np.linalg.norm(pred - y) / np.linalg.norm(y) < 0.05


def test_timit_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry_point in (
        lambda: t.synthetic_timit(4),
        lambda: t.run(small_config(num_cosines=1)),
        lambda: tlinalg.block_coordinate_descent_streaming(np.ones((4, 2), np.float32), np.ones((4, 1)), 0.1, 1, 2),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()
