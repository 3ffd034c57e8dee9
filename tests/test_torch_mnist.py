"""Port parity for the MNIST random-FFT path: ``keystone_tpu_torch`` on
the CPU against ``keystone_tpu`` on the same seeded numpy inputs.

Bounds (relative Frobenius unless a line says "exact"), each with the
value measured on the CPU:

- sign, ReLU, clip, the combiner, the sampler and the CSV loader: exact;
- ``PaddedFFT`` ≤ 1e-5 (measured 1.4e-7: XLA's FFT and PyTorch's sum
  in another order);
- ``CosineRandomFeatures`` (Gaussian), ``NormalizeRows``,
  ``SignedHellingerMapper`` and the ``StandardScaler`` fit ≤ 1e-6
  (measured 5.5e-7, 6.1e-8, 7.1e-9, 1.1e-7); the Cauchy case is held as
  its test says;
- the whole slice's scores ≤ ``SOLVE_TOL`` = 1e-4 (measured 3.4e-6), for
  the reason in ``tests/test_torch_slice.py``: the dense in-core solve
  rounds in another order in XLA than in PyTorch's BLAS/LAPACK;
- a JAX-fitted pipeline carried across: predictions equal, scores ≤ 1e-5
  (measured 3.4e-7; no solve);
- train and test errors of ``run`` within 0.002 of the JAX run (measured
  equal: 0.117431640625 and 0.60986328125).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.data.loaders.csv import load_labeled_csv as j_load_labeled_csv
from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JEstimator
from keystone_tpu.ops.stats import core as jcore
from keystone_tpu.ops.util.labels import ClassLabelIndicators as JIndicators
from keystone_tpu.ops.util.labels import MaxClassifier as JMax
from keystone_tpu.ops.util.vectors import VectorCombiner as JCombiner
from keystone_tpu.pipelines import mnist_random_fft as jm
from keystone_tpu_torch.convert import mnist_pipeline_from_numpy
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.data.loaders.csv import load_labeled_csv
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.stats import core as tcore
from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators
from keystone_tpu_torch.ops.util.vectors import VectorCombiner
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline
from keystone_tpu_torch.workflow.tracing import trace

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FFT_TOL, FEATURE_TOL, SOLVE_TOL, CARRY_TOL, ERROR_TOL = 1e-5, 1e-6, 1e-4, 1e-5, 0.002
SMALL = dict(num_ffts=2, block_size=512, reg=10.0)


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _x(n=64, d=784, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _both(j_op, t_op, x):
    want = np.asarray(j_op.apply_arrays(x))
    got = t_op.apply_arrays(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


# ----------------------------------------------------------------- featurizers


@pytest.mark.parametrize("seed", [0, 3])
def test_random_sign_node_draws_the_same_signs(seed):
    j, t = jcore.RandomSignNode.create(784, seed=seed), tcore.RandomSignNode.create(
        784, seed=seed, device=CPU
    )
    np.testing.assert_array_equal(t.signs.numpy(), np.asarray(j.signs))
    got, want = _both(j, t, _x())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [784, 512, 5])
def test_padded_fft(d):
    got, want = _both(jcore.PaddedFFT(), tcore.PaddedFFT(), _x(d=d))
    assert got.shape[-1] == tcore.next_power_of_two(d) // 2
    assert _rel(got, want) <= FFT_TOL


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.LinearRectifier(0.0),
        lambda m: m.LinearRectifier(0.5, alpha=0.25),
        lambda m: m.Clipper(-0.5, 0.75),
    ],
)
def test_elementwise_featurizers_exact(make):
    got, want = _both(make(jcore), make(tcore), _x())
    np.testing.assert_array_equal(got, want)


def _kw(module):
    """The port's random features take ``device=``; the JAX ones do not."""
    return {"device": CPU} if module is tcore else {}


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.CosineRandomFeatures.create(784, 64, gamma=0.05, seed=2, **_kw(m)),
        lambda m: m.NormalizeRows(),
        lambda m: m.SignedHellingerMapper(),
    ],
)
def test_float_featurizers(make):
    x = _x()
    x[3] = 0.0  # a zero row stays zero under NormalizeRows
    got, want = _both(make(jcore), make(tcore), x)
    assert _rel(got, want) <= FEATURE_TOL


def test_cauchy_cosine_features_agree_to_their_argument():
    """Cauchy weights put arguments of cos up to ~1e4, where one fp32 ulp
    of the argument moves cos by ~1e-3: the outputs differ by 1.5e-4
    relative. So this case holds W and b exact, the argument x·Wᵀ + b to
    ``FEATURE_TOL``, and each cos to within its argument's difference
    (|cos a − cos b| ≤ |a − b|)."""
    j = jcore.CosineRandomFeatures.create(784, 64, gamma=0.05, dist="cauchy", seed=2)
    t = tcore.CosineRandomFeatures.create(784, 64, gamma=0.05, dist="cauchy", seed=2, device=CPU)
    np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
    x = _x()
    arg_j = np.asarray(x @ j.w.T + j.b)
    arg_t = (torch.from_numpy(x) @ t.w.T + t.b).numpy()
    assert _rel(arg_t, arg_j) <= FEATURE_TOL
    got, want = _both(j, t, x)
    assert np.all(np.abs(got - want) <= np.abs(arg_t - arg_j) + 1e-6)


def test_vector_combiner_exact():
    parts = (_x(d=3), _x(d=5, seed=1))
    want = np.asarray(JCombiner().apply_arrays(parts))
    got = VectorCombiner().apply_arrays(tuple(torch.from_numpy(p) for p in parts)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        VectorCombiner().apply([p[0] for p in parts]).numpy(), want[0]
    )


@pytest.mark.parametrize("normalize", [True, False])
def test_standard_scaler_fit(normalize):
    x = _x(n=50, d=12) * np.linspace(0.1, 3, 12, dtype=np.float32) + 2.0
    x[:, 4] = 1.5  # a constant column: std guard → 1
    j = jcore.StandardScaler(normalize_std_dev=normalize).fit(JArrayDataset(x))
    t = tcore.StandardScaler(normalize_std_dev=normalize).fit(ArrayDataset(x, device=CPU))
    assert _rel(t.mean.numpy(), np.asarray(j.mean)) <= FEATURE_TOL
    if normalize:
        assert _rel(t.std.numpy(), np.asarray(j.std)) <= FEATURE_TOL
        assert float(t.std[4]) == 1.0
    else:
        assert t.std is None and j.std is None
    got, want = _both(j, t, x)
    assert _rel(got, want) <= FEATURE_TOL


def test_sampler_picks_the_same_rows():
    x = _x(n=40, d=3)
    j = jcore.Sampler(7, seed=5).apply_batch(JArrayDataset(x))
    t = tcore.Sampler(7, seed=5).apply_batch(ArrayDataset(x, device=CPU))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data)[: len(j)])


# ------------------------------------------------------------------- loaders


def test_load_labeled_csv_exact(tmp_path):
    rows = ["3,0.5,1.25,2", "1,4,5,6", "bad,row,here,x", "2,7,8", "10,1e-3,-2.5,0  # comment", ""]
    path = tmp_path / "mnist.csv"
    path.write_text("\n".join(rows) + "\n")
    j = j_load_labeled_csv(str(path), label_offset=-1)
    t = load_labeled_csv(str(path), label_offset=-1, device="cpu")
    np.testing.assert_array_equal(t.labels.data.numpy(), np.asarray(j.labels.data))
    np.testing.assert_array_equal(t.data.data.numpy(), np.asarray(j.data.data))
    assert t.labels.data.dtype == torch.int32 and t.data.data.dtype == torch.float32
    from keystone_tpu.data.loaders.csv import load_csv as j_load_csv
    from keystone_tpu_torch.data.loaders.csv import load_csv

    assert load_csv(str(path), device="cpu").quarantine == j_load_csv(str(path)).quarantine


# --------------------------------------------------------------- the slice


def _scores_both(config_kw, n_train=1024, n_test=256):
    cfg_j = jm.MnistRandomFFTConfig(**config_kw)
    cfg_t = tm.MnistRandomFFTConfig(**config_kw)
    j_train, j_test = jm.synthetic_mnist(n_train, seed=0), jm.synthetic_mnist(n_test, seed=1)
    t_train = tm.synthetic_mnist(n_train, seed=0, device=CPU)
    t_test = tm.synthetic_mnist(n_test, seed=1, device=CPU)
    j_pipe = jm.build_featurizer(cfg_j).then_label_estimator(
        JEstimator(cfg_j.block_size, num_iter=1, reg=cfg_j.reg or 0.0),
        j_train.data, JIndicators(10)(j_train.labels),
    )
    t_pipe = tm.build_featurizer(cfg_t, device=CPU).then_label_estimator(
        BlockLeastSquaresEstimator(cfg_t.block_size, num_iter=1, reg=cfg_t.reg or 0.0, device=CPU),
        t_train.data, ClassLabelIndicators(10)(t_train.labels),
    )
    j_scores = np.asarray(j_pipe(j_test.data).get().data)[:n_test]
    t_scores = t_pipe(t_test.data).get().data.numpy()
    return t_scores, j_scores, t_pipe, t_train, t_test


def test_slice_scores_match_jax():
    t_scores, j_scores, *_ = _scores_both(SMALL)
    assert t_scores.shape == (256, 10)
    assert _rel(t_scores, j_scores) <= SOLVE_TOL
    np.testing.assert_array_equal(t_scores.argmax(1), j_scores.argmax(1))


def test_slice_semantics_featurize_once_fit_once_fit_leaves_no_estimator(tmp_path):
    cfg = tm.MnistRandomFFTConfig(**SMALL)
    train = tm.synthetic_mnist(1024, seed=0, device=CPU)
    test = tm.synthetic_mnist(256, seed=1, device=CPU)
    pipe = tm.build_pipeline(cfg, train, device=CPU)
    with trace() as t_train:
        train_pred = pipe(train.data).get().data
    with trace() as t_test:
        test_pred = pipe(test.data).get().data
    labels = [t.label for t in t_train.timings]
    # CSE: one featurize pass, each branch one fused node
    assert labels.count("Fused[RandomSignNode+PaddedFFT+LinearRectifier]") == cfg.num_ffts
    assert labels.count("BlockLeastSquaresEstimator") == 1
    assert "BlockLeastSquaresEstimator" not in [t.label for t in t_test.timings]
    fitted = pipe.fit()
    kinds = {type(op).__name__ for op in fitted.graph.operators.values()}
    assert "BlockLeastSquaresEstimator" not in kinds and "DelegatingOperator" not in kinds
    assert "DatasetOperator" not in kinds
    assert torch.equal(fitted.apply_batch(test.data).data, test_pred)
    assert torch.equal(fitted.apply_batch(train.data).data, train_pred)
    assert int(fitted.apply(test.data.data[5].numpy())) == int(test_pred[5])
    path = str(tmp_path / "mnist.pt")
    fitted.save(path)
    assert torch.equal(FittedPipeline.load(path, device="cpu").apply_batch(test.data).data, test_pred)


def test_run_matches_jax_run():
    j = jm.run(jm.MnistRandomFFTConfig())
    t = tm.run(tm.MnistRandomFFTConfig(), device="cpu")
    assert abs(t["train_error"] - j["train_error"]) <= ERROR_TOL
    assert abs(t["test_error"] - j["test_error"]) <= ERROR_TOL


def test_jax_fitted_pipeline_carried_across():
    cfg = jm.MnistRandomFFTConfig(**SMALL)
    train, test = jm.synthetic_mnist(1024, seed=0), jm.synthetic_mnist(256, seed=1)
    featurizer = jm.build_featurizer(cfg)
    model = JEstimator(cfg.block_size, num_iter=1, reg=cfg.reg).fit(
        featurizer(train.data).get(), JIndicators(10)(train.labels).get()
    )
    signs = [np.asarray(jcore.RandomSignNode.create(784, seed=cfg.seed + i).signs)
             for i in range(cfg.num_ffts)]
    carried = mnist_pipeline_from_numpy(
        signs, np.asarray(model.weights), model.block_size,
        intercept=np.asarray(model.intercept), feature_mean=np.asarray(model.feature_mean),
        device=CPU,
    )
    x = np.asarray(test.data.data)[:256]
    j_scores = np.asarray((featurizer >> model)(JArrayDataset(x)).get().data)[:256]
    j_pred = np.asarray((featurizer >> model >> JMax())(JArrayDataset(x)).get().data)[:256]
    t_pred = carried.apply_batch(ArrayDataset(x, device=CPU)).data.numpy()
    np.testing.assert_array_equal(t_pred, j_pred)
    ops = carried.graph.operators.values()
    members = [m for op in ops for m in getattr(op, "members", (op,))]  # fit() fuses chains
    mapper = next(m for m in members if hasattr(m, "weights"))
    combiner_out = tm.build_featurizer(cfg, device=CPU)(ArrayDataset(x, device=CPU)).get()
    t_scores = mapper.apply_arrays(combiner_out.data).numpy()
    assert _rel(t_scores, j_scores) <= CARRY_TOL


@pytest.mark.parametrize("device_args", [["--device", "cpu"], []])
def test_cli(device_args):
    # The child sees no card, so the default device (CUDA) must raise,
    # whatever the machine running the tests holds.
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "mnist-random-fft",
         "--num-ffts", "2", "--block-size", "512", *device_args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    if device_args:  # asked for the CPU: runs and prints the workload line
        assert proc.returncode == 0, proc.stderr
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["workload"] == "mnist-random-fft"
        assert 0.0 <= line["train_error"] <= line["test_error"] <= 1.0
    else:  # default device is CUDA, and the child sees none
        assert proc.returncode != 0
        assert "device='cpu'" in proc.stderr
