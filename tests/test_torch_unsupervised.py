"""The port's unsupervised fits and encoders (``ops/learning/kmeans.py``,
``gmm.py``, ``pca.py``, ``ops/images/fisher.py`` and their ``convert.py``
carriers) held to the JAX package on the CPU, on the same seeded numpy
inputs.

Bounds, each with the value read on the CPU:

- k-means++ seeds bit-equal (host numpy in both packages); Lloyd centres
  ≤ 1e-5 relative (read 7.3e-8), with equal assignments;
- GMM posteriors ≤ 1e-5 (read 7.0e-7); EM makes the same number of
  updates as the JAX loop (JAX's count is found as the ``max_iterations``
  at which its result stops changing) and its parameters lie ≤ 1e-4
  from the JAX package's (read ≤ 2.0e-6); a whole fit at a fixed five
  iterations (``stop_tolerance=0``) ≤ 1e-4 (read ≤ 1.0e-5, the
  variances; the initial moments are taken on the device here and in
  host numpy there); the random initialization ≤ 1e-4 (read 1.7e-7);
  the Fisher-vector estimator's fit and encoding ≤ 1e-4 (read ≤ 4.1e-5);
- PCA components per column ≤ 1e-4 where the eigengap is clear (the
  data's column scales are 1..d apart; read ≤ 1.5e-6), signs included;
  the randomized estimator with the JAX package's Ω ≤ 1e-4 (read
  ≤ 5.9e-6), with its own Ω ≤ 1e-3 (read ≤ 3.2e-6);
  ``ColumnPCAEstimator.optimize`` picks the JAX package's estimator;
- Fisher vectors ≤ 1e-5 from the JAX package (read 1.3e-7) and ≤ 1e-5
  from the formula evaluated in float64 on the same posteriors (read
  ≤ 1.7e-7);
- the ``convert.py`` carriers apply as the JAX models they hold
  (≤ 1e-6; read ≤ 2.6e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.images import fisher as jfisher
from keystone_tpu.ops.learning import gmm as jgmm
from keystone_tpu.ops.learning import kmeans as jkmeans
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.workflow.optimize import DataStats as JDataStats
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs.spans import tracing_session
from keystone_tpu_torch.ops.images import fisher as tfisher
from keystone_tpu_torch.ops.learning import gmm as tgmm
from keystone_tpu_torch.ops.learning import kmeans as tkmeans
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.workflow.optimize import DataStats

CPU = torch.device("cpu")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _blobs(n=3000, d=8, k=6, seed=0, spread=0.6):
    """Points around k well-separated centres."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 4.0
    labels = rng.integers(0, k, n)
    return (centres[labels] + spread * rng.normal(size=(n, d))).astype(np.float32)


# -------------------------------------------------------------------- k-means


def test_kmeanspp_seeds_are_bit_equal():
    x = _blobs(seed=1)
    np.testing.assert_array_equal(tkmeans._kmeanspp_init(x, 12, 5), jkmeans._kmeanspp_init(x, 12, 5))


def test_kmeanspp_seeds_are_bit_equal_over_many_rows():
    """At 200,000 rows one row holds ~5e-6 of the D² weights: the draw
    without ``rng.choice``'s checks still takes the JAX package's rows."""
    x = _blobs(n=200_000, d=16, k=40, seed=13)
    np.testing.assert_array_equal(tkmeans._kmeanspp_init(x, 48, 17), jkmeans._kmeanspp_init(x, 48, 17))


def test_lloyd_centres_and_assignments_match_the_jax_package():
    x = _blobs(seed=2)
    jm = jkmeans.KMeansPlusPlusEstimator(6, 20, seed=3).fit(JArrayDataset(x))
    tm = tkmeans.KMeansPlusPlusEstimator(6, 20, seed=3).fit(ArrayDataset(x, device=CPU))
    assert _rel(tm.means.numpy(), np.asarray(jm.means)) <= 1e-5
    np.testing.assert_array_equal(tm.apply_arrays(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.apply_arrays(jnp.asarray(x))))


# ------------------------------------------------------------------------ GMM


def _gmm_params(d=8, k=6, seed=4):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(k, d)).astype(np.float32) * 4.0
    variances = rng.uniform(0.5, 1.5, size=(k, d)).astype(np.float32)
    weights = rng.uniform(0.5, 1.0, size=k).astype(np.float32)
    return means, variances, (weights / weights.sum()).astype(np.float32)


def test_posteriors_match_the_jax_package():
    x = _blobs(n=500)
    m, v, w = _gmm_params()
    want = np.asarray(jgmm._gmm_posteriors(jnp.asarray(x), m, v, w, jnp.float32(1e-4)))
    got = tgmm._gmm_posteriors(torch.from_numpy(x), *(torch.from_numpy(a) for a in (m, v, w)), 1e-4)
    assert _rel(got.numpy(), want) <= 1e-5


def test_em_makes_the_jax_loops_number_of_updates():
    x = _blobs(seed=5)
    # Start near the blobs: means are data points, variances and weights flat.
    m = x[np.random.default_rng(6).choice(len(x), 6, replace=False)]
    v = np.ones_like(m)
    w = np.full(6, 1 / 6, np.float32)
    var_lb = np.maximum(1e-2 * x.var(axis=0), 1e-9).astype(np.float32)

    def jax_em(iters):
        out = jgmm._gmm_em(jnp.asarray(x), jnp.asarray(m), jnp.asarray(v), jnp.asarray(w),
                           jnp.asarray(var_lb), iters, jnp.float32(1e-4), jnp.float32(1e-4),
                           jnp.float32(40))
        return [np.asarray(a) for a in out]

    tm, tv, tw, iterations, updates = tgmm._gmm_em(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in (m, v, w)), torch.from_numpy(var_lb),
        100, 1e-4, 1e-4, 40,
    )
    assert 2 <= updates < iterations <= 100
    full = jax_em(100)
    # JAX made exactly `updates` updates: stopping it there changes nothing,
    # one update earlier does.
    assert all(np.array_equal(a, b) for a, b in zip(jax_em(updates), full))
    assert not all(np.array_equal(a, b) for a, b in zip(jax_em(updates - 1), full))
    for got, want in zip((tm, tv, tw), full):
        assert _rel(got.numpy(), want) <= 1e-4


def test_gmm_fit_at_a_fixed_iteration_count_matches_the_jax_package():
    x = _blobs(seed=7)
    kw = dict(max_iterations=5, stop_tolerance=-1.0, seed=2)
    jm = jgmm.GaussianMixtureModelEstimator(6, **kw).fit(JArrayDataset(x))
    with tracing_session() as session:
        tm = tgmm.GaussianMixtureModelEstimator(6, **kw).fit(ArrayDataset(x, device=CPU))
    em = session.find("gmm:em")[0]
    assert em.attributes["iterations"] == 5
    for got, want in ((tm.means, jm.means), (tm.variances, jm.variances), (tm.weights, jm.weights)):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-4
    assert _rel(tm.apply_arrays(torch.from_numpy(x)).numpy(),
                np.asarray(jm.apply_arrays(jnp.asarray(x)))) <= 1e-4


def test_random_initialization_matches_the_jax_package():
    x = _blobs(n=1200, seed=8)
    kw = dict(max_iterations=3, stop_tolerance=0.0, initialization_method="random", seed=1)
    jm = jgmm.GaussianMixtureModelEstimator(4, **kw).fit(JArrayDataset(x))
    tm = tgmm.GaussianMixtureModelEstimator(4, **kw).fit(ArrayDataset(x, device=CPU))
    assert _rel(tm.means.numpy(), np.asarray(jm.means)) <= 1e-4


def test_gmm_csv_load_and_carrier_apply_as_the_jax_model(tmp_path):
    m, v, w = _gmm_params(d=5, k=3)
    paths = [str(tmp_path / f"{name}.csv") for name in ("m", "v", "w")]
    for path, a in zip(paths, (m.T, v.T, w)):
        np.savetxt(path, a, delimiter=",")
    x = torch.from_numpy(_blobs(n=200, d=5, k=3))
    want = np.asarray(jgmm.GaussianMixtureModel.load(*paths).apply_arrays(jnp.asarray(x.numpy())))
    loaded = tgmm.GaussianMixtureModel.load(*paths, device=CPU)
    carried = convert.gmm_from_numpy(m.T, v.T, w, device=CPU)
    assert _rel(loaded.apply_arrays(x).numpy(), want) <= 1e-6
    assert _rel(carried.apply_arrays(x).numpy(), want) <= 1e-6


# ------------------------------------------------------------------------ PCA


def _pca_data(n=2000, d=12, seed=9):
    """Columns at scales 1..d, then a random rotation: eigenvalues ~ i²,
    every eigengap clear."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)) * np.arange(1, d + 1)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return (z @ q.T + rng.normal(size=d)).astype(np.float32)


@pytest.mark.parametrize("name", ["PCAEstimator", "DistributedPCAEstimator"])
def test_pca_components_match_the_jax_package(name):
    x = _pca_data()
    want = np.asarray(getattr(jpca, name)(5).fit(JArrayDataset(x)).components)
    got = getattr(tpca, name)(5).fit(ArrayDataset(x, device=CPU)).components.numpy()
    for col in range(5):
        assert _rel(got[:, col], want[:, col]) <= 1e-4


def test_approximate_pca_with_the_jax_packages_omega():
    x = _pca_data(seed=10)
    l, q, seed = 5 + 5, 10, 3
    want = np.asarray(jpca._approximate_pca(jnp.asarray(x), l, q, seed))
    omega = np.array(jax.random.normal(jax.random.PRNGKey(seed), (x.shape[1], l), dtype=jnp.float32))
    got = tpca.approximate_pca(torch.from_numpy(x), l, q, omega=torch.from_numpy(omega)).numpy()
    for col in range(5):
        assert _rel(got[:, col], want[:, col]) <= 1e-4
    # The port's own Ω finds the same leading subspace.
    own = tpca.ApproximatePCAEstimator(5).fit(ArrayDataset(x, device=CPU)).components.numpy()
    for col in range(5):
        assert _rel(own[:, col], want[:, col]) <= 1e-3


def test_sign_convention_matches_the_jax_package():
    c = np.random.default_rng(11).normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_array_equal(tpca.enforce_sign_convention(torch.from_numpy(c)).numpy(),
                                  np.asarray(jpca.enforce_sign_convention(jnp.asarray(c))))


def test_column_pca_and_its_carrier_project_as_the_jax_package():
    x = _pca_data(n=40 * 30, d=12).reshape(40, 30, 12)
    jt = jpca.ColumnPCAEstimator(4).fit(JArrayDataset(x))
    tt = tpca.ColumnPCAEstimator(4).fit(ArrayDataset(x, device=CPU))
    for col in range(4):
        assert _rel(tt.components[:, col].numpy(), np.asarray(jt.components)[:, col]) <= 1e-4
    want = np.asarray(jt.apply_batch(JArrayDataset(x)).data)
    carried = convert.pca_from_numpy(np.asarray(jt.components), device=CPU)
    assert _rel(carried.apply_batch(ArrayDataset(x, device=CPU)).data.numpy(), want) <= 1e-6
    assert _rel(carried.apply(torch.from_numpy(x[0])).numpy(), want[0]) <= 1e-6


@pytest.mark.parametrize("n_total,machines,items", [(100, 1, "matrix"), (10**6, 1, "matrix"),
                                                     (10**6, 16, "matrix"), (50, 16, "vector")])
def test_column_pca_optimize_picks_the_jax_packages_estimator(n_total, machines, items):
    rng = np.random.default_rng(12)
    sample = rng.normal(size=(8, 30, 16) if items == "matrix" else (8, 16)).astype(np.float32)
    jpick = jpca.ColumnPCAEstimator(4, num_machines=machines).optimize(
        [JArrayDataset(sample)], JDataStats(n_total, 1, [n_total]))
    tpick = tpca.ColumnPCAEstimator(4, num_machines=machines).optimize(
        [ArrayDataset(sample, device=CPU)], DataStats(n_total, 1, [n_total]))
    assert type(tpick).__name__ == type(jpick).__name__


# --------------------------------------------------------------- Fisher vectors


def test_fisher_vectors_match_the_jax_package_and_the_formula():
    d, k = 6, 5
    m, v, w = _gmm_params(d=d, k=k, seed=13)
    x = (np.random.default_rng(14).normal(size=(3, 70, d)) * 3.0).astype(np.float32)
    jg = jgmm.GaussianMixtureModel(m.T, v.T, w)
    want = np.asarray(jfisher.FisherVector(jg).apply_arrays(jnp.asarray(x)))
    tg = convert.gmm_from_numpy(m.T, v.T, w, device=CPU)
    fv = tfisher.FisherVector(tg)
    fv.image_chunk = 2  # two chunks, the second ragged
    got = fv.apply_arrays(torch.from_numpy(x)).numpy()
    assert got.shape == (3, d, 2 * k)
    assert _rel(got, want) <= 1e-5

    means, variances, weights = (a.astype(np.float64) for a in (m.T, v.T, w))
    for i in range(3):
        q = tg.apply_arrays(torch.from_numpy(x[i])).numpy().astype(np.float64)
        xi = x[i].astype(np.float64)
        s0, s1, s2 = q.mean(axis=0), xi.T @ q / 70, (xi.T**2) @ q / 70
        fv1 = (s1 - means * s0) / (np.sqrt(variances) * np.sqrt(weights))
        fv2 = (s2 - 2 * means * s1 + (means**2 - variances) * s0) / (variances * np.sqrt(2 * weights))
        assert _rel(got[i], np.concatenate([fv1, fv2], axis=1)) <= 1e-5


def test_gmm_fisher_vector_estimator_fits_on_pooled_descriptors():
    x = _blobs(n=40 * 50, d=6, k=4, seed=15).reshape(40, 50, 6)
    jm = jfisher.GMMFisherVectorEstimator(4).fit(JArrayDataset(x))
    tm = tfisher.GMMFisherVectorEstimator(4).fit(ArrayDataset(x, device=CPU))
    assert _rel(tm.gmm.means.numpy(), np.asarray(jm.gmm.means)) <= 1e-4
    assert _rel(tm.apply_arrays(torch.from_numpy(x[:4])).numpy(),
                np.asarray(jm.apply_arrays(jnp.asarray(x[:4])))) <= 1e-4
