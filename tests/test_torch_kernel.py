"""Kernel ridge regression in the port (``keystone_tpu_torch/ops/learning/kernel.py``)
on the CPU, held to the JAX package (``keystone_tpu/ops/learning/kernel.py``)
on the same seeded numpy inputs: the Gaussian panel, the Gauss-Seidel
duals and the mapper's predictions (with and without ``block_permuter``),
the Nyström rung, the OOM ladder, and a JAX-fitted mapper carried across
by ``convert.kernel_mapper_from_numpy`` — plus mirrors of
``tests/ops/test_kernel.py`` (its single-device cases).

The JAX package runs on the test configuration's 8-device CPU mesh, so
its row padding rounds to the device count too: duals are compared on
the real rows, and pad rows' duals are zero in both.

Bounds, each with the value measured on the CPU: the Gaussian panel
≤ 1e-6 relative; KRR duals on the real rows and predictions, the
Nyström predictions, and a carried-across mapper's scores ≤ 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning import kernel as jkernel
from keystone_tpu.reliability import FaultSpec as JFaultSpec
from keystone_tpu.reliability import injected as jinjected
from keystone_tpu_torch.convert import kernel_mapper_from_numpy
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import names as tnames
from keystone_tpu_torch.ops.learning.kernel import (
    BlockKernelMatrix,
    GaussianKernelGenerator,
    KernelBlockLinearMapper,
    KernelRidgeRegression,
    gaussian_kernel_block,
)
from keystone_tpu_torch.reliability import FaultSpec, injected

CPU = torch.device("cpu")
PANEL_TOL = 1e-6
MODEL_TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return ArrayDataset(a, device="cpu")


def np_gaussian_kernel(a, b, gamma):
    sq = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-gamma * sq)


def _problem(n=200, d=6, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sin(x @ rng.normal(size=(d, k))).astype(np.float32)
    return x, y


def _fit_both(x, y, gamma, reg, bs, epochs, permuter=None):
    tm = KernelRidgeRegression(GaussianKernelGenerator(gamma, device=CPU), reg, bs, epochs,
                               block_permuter=permuter).fit(_t(x), _t(y))
    jm = jkernel.KernelRidgeRegression(jkernel.GaussianKernelGenerator(gamma), reg, bs, epochs,
                                       block_permuter=permuter).fit(JArrayDataset(x), JArrayDataset(y))
    return tm, jm


def test_kernel_block_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(37, 9)).astype(np.float32)
    b = rng.normal(size=(23, 9)).astype(np.float32)
    got = gaussian_kernel_block(torch.from_numpy(a), torch.from_numpy(b), 0.3).numpy()
    want = np.asarray(jkernel.gaussian_kernel_block(jnp.asarray(a), jnp.asarray(b), 0.3))
    assert _rel(got, want) <= PANEL_TOL
    np.testing.assert_allclose(got, np_gaussian_kernel(a, b, 0.3), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("permuter", [None, 12334])
def test_krr_duals_and_predictions_match_jax(permuter):
    """Two epochs over 16-row blocks of 200 rows (a short last block):
    the duals on the real rows and the predictions on held-out rows."""
    x, y = _problem()
    xt, _ = _problem(n=50, seed=1)
    tm, jm = _fit_both(x, y, gamma=0.2, reg=0.1, bs=16, epochs=2, permuter=permuter)
    n = x.shape[0]
    assert _rel(tm.duals[:n].numpy(), np.asarray(jm.duals)[:n]) <= MODEL_TOL
    assert (tm.duals[n:] == 0).all() and (np.asarray(jm.duals)[n:] == 0).all()
    got = tm.apply_batch(_t(xt)).data.numpy()[:50]
    want = np.asarray(jm.apply_batch(JArrayDataset(xt)).data)[:50]
    assert _rel(got, want) <= MODEL_TOL


def test_permuted_order_differs_from_the_natural_one():
    x, y = _problem(n=96)
    plain, _ = _fit_both(x, y, 0.2, 0.1, 16, 1)
    permuted, _ = _fit_both(x, y, 0.2, 0.1, 16, 1, permuter=7)
    assert not np.allclose(plain.duals.numpy(), permuted.duals.numpy())


def test_nystrom_landmarks_and_predictions_match_jax(monkeypatch):
    monkeypatch.setenv("KEYSTONE_KERNEL_NYSTROM", "48")
    monkeypatch.setenv("KEYSTONE_SKETCH_SEED", "5")
    x, y = _problem(n=160)
    xt, _ = _problem(n=40, seed=2)
    fits = tnames.metric(tnames.SKETCH_FITS)
    before = fits.value(variant="nystrom")
    tm, jm = _fit_both(x, y, gamma=0.2, reg=1e-2, bs=32, epochs=1)
    assert fits.value(variant="nystrom") - before == 1
    assert tm.num_train == jm.num_train == 48 and tm.block_size == jm.block_size == 32
    np.testing.assert_array_equal(tm.train.numpy(), np.asarray(jm.train))  # the landmark rows
    got = tm.apply_batch(_t(xt)).data.numpy()[:40]
    want = np.asarray(jm.apply_batch(JArrayDataset(xt)).data)[:40]
    assert _rel(got, want) <= MODEL_TOL


def test_injected_oom_halves_the_block_like_jax():
    x, y = _problem(n=128)
    xt, _ = _problem(n=32, seed=3)
    spec = dict(match="KernelRidgeRegression.solve", kind="oom", first_n=1)
    with injected(FaultSpec(**spec)):
        tm = KernelRidgeRegression(GaussianKernelGenerator(0.2, device=CPU), 0.1, 32, 2).fit(_t(x), _t(y))
    with jinjected(JFaultSpec(**spec)):
        jm = jkernel.KernelRidgeRegression(jkernel.GaussianKernelGenerator(0.2), 0.1, 32, 2).fit(
            JArrayDataset(x), JArrayDataset(y))
    assert tm.block_size == 16 and tm.degradation == jm.degradation
    assert tm.degradation["rung"] == 16 and tm.degradation["first_rung"] == 32
    direct = KernelRidgeRegression(GaussianKernelGenerator(0.2, device=CPU), 0.1, 16, 2).fit(_t(x), _t(y))
    xtt = torch.from_numpy(xt)
    assert _rel(tm.apply_arrays(xtt).numpy(), direct.apply_arrays(xtt).numpy()) <= MODEL_TOL


def test_kernel_mapper_from_numpy_scores_a_jax_model():
    x, y = _problem(n=120)
    xt, _ = _problem(n=30, seed=4)
    jm = jkernel.KernelRidgeRegression(jkernel.GaussianKernelGenerator(0.3), 0.05, 16, 3,
                                       block_permuter=1).fit(JArrayDataset(x), JArrayDataset(y))
    mapper = kernel_mapper_from_numpy(np.asarray(jm.train), np.asarray(jm.duals), jm.gamma,
                                      jm.num_train, jm.block_size, device="cpu")
    got = mapper.apply_arrays(torch.from_numpy(xt)).numpy()
    assert _rel(got, np.asarray(jm.apply_arrays(jnp.asarray(xt)))) <= MODEL_TOL


# ------------------------------------------------------- JAX-test mirrors


def test_krr_learns_xor():
    """reference: KernelModelSuite.scala:14-38"""
    x = np.array([[-1, -1], [-1, 1], [1, -1], [1, 1]], dtype=np.float32)
    y = np.array([[1, -1], [-1, 1], [-1, 1], [1, -1]], dtype=np.float32)
    est = KernelRidgeRegression(GaussianKernelGenerator(1.0, device=CPU), reg=0.01, block_size=2, num_epochs=40)
    pred = est.fit(_t(x), _t(y)).apply_batch(_t(x)).data.numpy()
    assert (np.sign(pred) == np.sign(y)).all()
    assert (pred.argmax(1) == y.argmax(1)).all()


def test_krr_converges_to_exact_dual():
    rng = np.random.default_rng(1)
    n, d, k, gamma, lam = 60, 3, 2, 0.5, 0.1
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    alpha_exact = np.linalg.solve(np_gaussian_kernel(x, x, gamma) + lam * np.eye(n), y)
    model = KernelRidgeRegression(GaussianKernelGenerator(gamma, device=CPU), reg=lam, block_size=16,
                                  num_epochs=300, block_permuter=7).fit(_t(x), _t(y))
    np.testing.assert_allclose(model.duals.numpy()[:n], alpha_exact, rtol=5e-2, atol=5e-3)
    xt = rng.normal(size=(13, d)).astype(np.float32)
    pred = model.apply_batch(_t(xt)).data.numpy()
    np.testing.assert_allclose(pred, np_gaussian_kernel(xt, x, gamma) @ alpha_exact, rtol=5e-2, atol=5e-3)


def test_krr_with_row_padding():
    rng = np.random.default_rng(2)
    n, gamma, lam = 50, 1.0, 0.5
    x = rng.normal(size=(n, 2)).astype(np.float32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    model = KernelRidgeRegression(GaussianKernelGenerator(gamma, device=CPU), reg=lam, block_size=16,
                                  num_epochs=50).fit(_t(x), _t(y))
    alpha_exact = np.linalg.solve(np_gaussian_kernel(x, x, gamma) + lam * np.eye(n), y)
    np.testing.assert_allclose(model.duals.numpy()[:n], alpha_exact, rtol=5e-2, atol=5e-3)
    assert model.duals.shape[0] == 64 and np.abs(model.duals.numpy()[n:]).max() == 0.0


def test_kernel_generator_and_block_matrix():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    transformer = GaussianKernelGenerator(0.4, device=CPU).fit(_t(x))
    assert transformer.num_train == 20
    matrix = BlockKernelMatrix(transformer)
    block = matrix(4, 8)
    assert block is matrix(4, 8)  # cached
    np.testing.assert_allclose(block.numpy(), np_gaussian_kernel(x, x[4:12], 0.4), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(matrix.diag_block(4, 8).numpy(), np_gaussian_kernel(x[4:12], x[4:12], 0.4),
                               rtol=1e-4, atol=1e-5)
    matrix.unpersist()
    assert matrix(4, 8) is not block


def test_mapper_is_not_fusable_and_blocks_sum_to_the_whole():
    rng = np.random.default_rng(4)
    train = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    duals = torch.from_numpy(rng.normal(size=(40, 2)).astype(np.float32))
    xt = torch.from_numpy(rng.normal(size=(9, 3)).astype(np.float32))
    assert not KernelBlockLinearMapper.fusable
    whole = gaussian_kernel_block(xt, train, 0.7) @ duals
    got = KernelBlockLinearMapper(train, duals, 0.7, num_train=40, block_size=16).apply_arrays(xt)
    assert _rel(got.numpy(), whole.numpy()) <= PANEL_TOL
