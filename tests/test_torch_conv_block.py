"""The rematerializing conv-block solver in the port
(``keystone_tpu_torch/ops/learning/conv_block.py``) on the CPU, held to
the JAX package (``keystone_tpu/ops/learning/conv_block.py``, on the test
configuration's 8-device CPU mesh) on the same seeded numpy inputs, and to
the port's own explicit featurize → standardize → BCD path — plus the two
``convert.py`` functions that carry a JAX-fitted whitener and conv-block
model across.

Bounds, each with the value measured on the CPU: predictions ≤ 1e-5
relative (read ≤ 2.7e-6, standardize on and off, padded filters,
reg = 0); the permutation exactly equal; ``ConvBlockModel.apply`` against
the mapper applied to ``FusedConvFeaturizer`` output ≤ 1e-5. A carried
JAX-fitted model: its mapper on the JAX package's features and its
featurizer each ≤ 1e-5 (the conversion is exact), the whole model applied
in the port ≤ ``CARRIED_TOL`` = 2e-4 from the JAX package's scores (read
5.4e-5): the features agree to 2.8e-7 overall, but the model folds 1/σ
into its weights and some pooled columns have σ ≈ 0.008 around a mean
of 0.002, so their round-off is multiplied ~100× (the same weights in
float64 on the two packages' features part by the same 5.4e-5, while
two fits, each on its own features, agree to 3.4e-6). Weights are not
compared: the blocks have more features than the problem has rows, so
fp32 round-off moves the weights along directions the rows do not see
(they differ by ~1e-5) while the predictions agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.learning.conv_block import ConvBlockLeastSquaresEstimator as JConvBlock
from keystone_tpu.ops.learning.zca import ZCAWhitenerEstimator as JZCA
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch.convert import conv_block_model_from_numpy, zca_whitener_from_numpy
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator, ConvBlockModel
from keystone_tpu_torch.parallel import linalg

CPU = torch.device("cpu")
TOL = 1e-5
CARRIED_TOL = 2e-4
FPF = 2 * 2 * 2  # 2×2 pool cells, symmetric rectifier doubles channels


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _filters(num_filters, seed=0):
    return np.random.default_rng(seed).normal(size=(num_filters, 6 * 6 * 3)).astype(np.float32) * 0.1


def _featurizers(num_filters, filter_block=4, seed=0):
    f = _filters(num_filters, seed)
    j = jcore.FusedConvFeaturizer(jcore.Convolver(f, 3, normalize_patches=True),
                                  jcore.SymmetricRectifier(alpha=0.25),
                                  jcore.Pooler(13, 14, None, "sum"), filter_block=filter_block)
    t = tcore.FusedConvFeaturizer(tcore.Convolver(f, 3, normalize_patches=True, device=CPU),
                                  tcore.SymmetricRectifier(alpha=0.25),
                                  tcore.Pooler(13, 14, None, "sum"), filter_block=filter_block)
    return j, t


def _problem(n=48, k=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.random((n, 32, 32, 3)).astype(np.float32), rng.normal(size=(n, k)).astype(np.float32)


def _fit_both(num_filters, block_filters, images, y, **kw):
    j, t = _featurizers(num_filters, seed=kw.pop("seed", 0))
    mesh = make_mesh(devices=jax.devices()[:8])
    with use_mesh(mesh):
        jm = JConvBlock(j, block_size=FPF * block_filters, **kw).fit(JArrayDataset(images), JArrayDataset(y))
        jp = np.asarray(jm.apply_arrays(jnp.asarray(images)))
    tm = ConvBlockLeastSquaresEstimator(t, block_size=FPF * block_filters, device=CPU, **kw).fit(
        ArrayDataset(images, device=CPU), ArrayDataset(y, device=CPU)
    )
    return jm, jp, tm, tm.apply_arrays(torch.from_numpy(images)).numpy()


@pytest.mark.parametrize("num_filters,block_filters", [(12, 4), (10, 4)])
@pytest.mark.parametrize("standardize", [True, False])
def test_conv_block_fit_matches_jax(num_filters, block_filters, standardize):
    """(10, 4): the last block holds two padded filters, dropped from the model."""
    images, y = _problem()
    jm, jp, tm, tp = _fit_both(num_filters, block_filters, images, y, num_iter=2, reg=0.1,
                               standardize=standardize, image_chunk=6)
    assert tp.shape == jp.shape == (48, 3)
    assert _rel(tp, jp) <= TOL
    assert tuple(tm.weights.shape) == np.asarray(jm.weights).shape == (FPF * num_filters, 3)
    assert _rel(tm.linear.feature_mean.numpy(), np.asarray(jm.linear.feature_mean)) <= TOL
    assert _rel(tm.linear.intercept.numpy(), np.asarray(jm.linear.intercept)) <= TOL


@pytest.mark.parametrize("standardize", [True, False])
def test_conv_block_reg0_rank_deficient_stays_finite_and_matches_jax(standardize):
    """reg = 0 with more features per block (32) than rows (8): the
    scale-aware λ floor keeps the block Cholesky finite."""
    images, y = _problem(n=8, k=2, seed=5)
    _, jp, _, tp = _fit_both(16, 4, images, y, num_iter=2, reg=0.0, standardize=standardize,
                             image_chunk=4, seed=4)
    assert np.isfinite(tp).all()
    assert _rel(tp, y) < 0.2  # interpolating regime: fits the rows closely
    assert _rel(tp, jp) <= TOL


def test_permutation_equals_jax_and_model_applies_to_featurizer_output():
    j, t = _featurizers(10)
    for px, py, fb, nb in ((2, 2, 4, 3), (1, 1, 5, 2), (2, 3, 1, 4)):
        np.testing.assert_array_equal(
            ConvBlockLeastSquaresEstimator(t)._standard_permutation(px, py, fb, nb),
            JConvBlock(j)._standard_permutation(px, py, fb, nb),
        )
    images, y = _problem()
    model = ConvBlockLeastSquaresEstimator(t, block_size=FPF * 4, reg=0.1, image_chunk=5,
                                           device=CPU).fit(ArrayDataset(images, device=CPU),
                                                           ArrayDataset(y, device=CPU))
    assert isinstance(model, ConvBlockModel) and model.image_chunk == 5
    x = torch.from_numpy(images)
    direct = model.linear.apply_arrays(t.apply_arrays(x))
    assert _rel(model.apply_arrays(x).numpy(), direct.numpy()) <= TOL


def test_conv_block_matches_the_explicit_standardized_bcd():
    """The port's fit against featurize → standardize → permute to
    block-major → ``linalg.block_coordinate_descent`` in the port."""
    _, t = _featurizers(10)
    images, y = _problem()
    n, nb, fb = 48, 3, 4
    est = ConvBlockLeastSquaresEstimator(t, block_size=FPF * fb, num_iter=1, reg=0.1,
                                         image_chunk=6, device=CPU)
    model = est.fit(ArrayDataset(images, device=CPU), ArrayDataset(y, device=CPU))
    feats = t.apply_arrays(torch.from_numpy(images)).double().numpy()
    mu, sd = feats.mean(axis=0), feats.std(axis=0, ddof=1)
    feats_std = (feats - mu) * np.where(sd < 1e-8, 1.0, 1.0 / sd)
    perm = est._standard_permutation(2, 2, fb, nb)
    f_pad = nb * fb
    keep = np.arange(FPF * f_pad) % (2 * f_pad) % f_pad < 10
    padded = np.zeros((n, FPF * f_pad))
    padded[:, keep] = feats_std
    a_bm = torch.from_numpy(padded[:, perm])
    yc = torch.from_numpy((y - y.mean(axis=0)).astype(np.float64))
    w = linalg.block_coordinate_descent(a_bm, yc, reg=0.1, num_epochs=1, block_size=FPF * fb)
    want = (a_bm @ w).numpy() + y.mean(axis=0)
    assert _rel(model.apply_arrays(torch.from_numpy(images)).numpy(), want) <= TOL


def test_geometry_rejects_partial_filter_blocks_and_auto_picks_4096():
    _, t = _featurizers(600)
    with pytest.raises(ValueError, match="not divisible"):
        ConvBlockLeastSquaresEstimator(t, block_size=12)._geometry((32, 32))
    fpf, fb, nb, px, py = ConvBlockLeastSquaresEstimator(t, block_size=None)._geometry((32, 32))
    assert (fpf, fb, nb, px, py) == (8, 512, 2, 2, 2)
    assert ConvBlockLeastSquaresEstimator(t, block_size=None)._geometry((24, 24))[:3] == (2, 2048, 1)


def test_converted_jax_models_apply_equal_in_the_port():
    rng = np.random.default_rng(9)
    patches = rng.normal(size=(300, 108)).astype(np.float32)
    jw = JZCA(eps=0.1).fit_single(patches)
    tw = zca_whitener_from_numpy(np.asarray(jw.whitener), np.asarray(jw.means), device=CPU)
    assert _rel(tw.apply(patches[:10]).numpy(), np.asarray(jw.apply(patches[:10]))) <= TOL

    filters = _filters(10)
    j = jcore.FusedConvFeaturizer(jcore.Convolver(filters, 3, whitener=jw),
                                  jcore.SymmetricRectifier(alpha=0.25),
                                  jcore.Pooler(13, 14, None, "sum"), filter_block=4)
    images, y = _problem()
    with use_mesh(make_mesh(devices=jax.devices()[:8])):
        jm = JConvBlock(j, block_size=FPF * 4, reg=0.1, image_chunk=6).fit(
            JArrayDataset(images), JArrayDataset(y))
        want = np.asarray(jm.apply_arrays(jnp.asarray(images)))
    tm = conv_block_model_from_numpy(
        filters, np.asarray(jm.weights), np.asarray(jm.linear.feature_mean),
        np.asarray(jm.linear.intercept), whitener_means=np.asarray(jw.means),
        filter_block=4, block_size=FPF * 4, image_chunk=6, device=CPU,
    )
    assert isinstance(tm.linear, BlockLinearMapper)
    jfeats = np.array(j.apply_arrays(jnp.asarray(images)))
    assert _rel(tm.featurizer.apply_arrays(torch.from_numpy(images)).numpy(), jfeats) <= TOL
    assert _rel(tm.linear.apply_arrays(torch.from_numpy(jfeats)).numpy(),
                np.asarray(jm.linear.apply_arrays(jnp.asarray(jfeats)))) <= TOL
    assert _rel(tm.apply_arrays(torch.from_numpy(images)).numpy(), want) <= CARRIED_TOL
