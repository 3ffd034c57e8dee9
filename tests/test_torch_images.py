"""Image operators and ZCA whitening in the port
(``keystone_tpu_torch/ops/images/core.py``, ``utils/image.py``,
``ops/learning/zca.py``) on the CPU, held to the JAX package
(``keystone_tpu/ops/images/core.py``) on the same seeded numpy inputs.

Bounds, each with the value measured on the CPU: every batched operator
≤ 1e-5 relative (Frobenius) — the convolver read ≤ 2e-7, the fused
featurizer ≤ 1e-7, the pooler 0.0; the host operators (``Windower``,
``RandomPatcher``, ``CenterCornerPatcher``, ``RandomImageTransformer``,
the ``utils/image.py`` helpers) exactly equal; the ZCA whitener W ≤ 1e-5
relative at ε = 0.1 and ε = 1e-5 (W does not depend on the SVD's signs,
so U and V are not compared); rows whitened by it ≤ 1e-5 at ε = 0.1 and
≤ ``ZCA_ROWS_TOL_SMALL_EPS`` = 1e-4 at ε = 1e-5 (read 2.6e-5): the rows
are row-normalized, so their component along the all-ones direction is
fp32 round-off, which W at ε = 1e-5 multiplies by (ε)^-½ ≈ 316.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.learning import zca as jzca
from keystone_tpu.utils import image as jimage
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.learning import zca as tzca
from keystone_tpu_torch.utils import image as timage
from keystone_tpu_torch.workflow.executor import PipelineEnv

CPU = torch.device("cpu")
TOL = 1e-5
ZCA_ROWS_TOL_SMALL_EPS = 1e-4


@pytest.fixture(autouse=True)
def _fresh_port_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _whiteners(d, seed=2, eps=0.1):
    samples = np.random.default_rng(seed).normal(size=(200, d)).astype(np.float32)
    jw = jzca.ZCAWhitenerEstimator(eps=eps).fit_single(samples)
    tw = tzca.ZCAWhitenerEstimator(eps=eps, device=CPU).fit_single(samples)
    return jw, tw


# ------------------------------------------------------------- host helpers


def test_host_image_helpers_equal_the_jax_package():
    rng = np.random.default_rng(6)
    img = rng.normal(size=(4, 5, 3))
    batch = rng.normal(size=(2, 4, 5, 3))
    meta = timage.ImageMetadata.of(img)
    assert meta == timage.ImageMetadata(*jimage.ImageMetadata.of(img).__dict__.values())
    for fn in ("vectorize", "to_grayscale", "flip_horizontal", "flip_image"):
        for x in (img, batch):
            np.testing.assert_array_equal(getattr(timage, fn)(x), getattr(jimage, fn)(x))
    np.testing.assert_array_equal(timage.unvectorize(timage.vectorize(img), meta), img)
    np.testing.assert_array_equal(timage.crop(img, 1, 0, 3, 4), jimage.crop(img, 1, 0, 3, 4))
    with pytest.raises(ValueError):
        timage.crop(img, 0, 0, 9, 1)
    for a, b in zip(timage.split_channels(img), jimage.split_channels(img)):
        np.testing.assert_array_equal(a, b)
    fx, fy = np.array([1.0, 2.0, 1.0]), np.array([0.5, -1.0])
    np.testing.assert_array_equal(timage.conv2d_separable(img, fx, fy),
                                  jimage.conv2d_separable(img, fx, fy))
    two = rng.normal(size=(3, 3, 2))
    np.testing.assert_array_equal(timage.to_grayscale(two), jimage.to_grayscale(two))


# ------------------------------------------------------- batched operators


@pytest.mark.parametrize("channels", [3, 2])
def test_grayscale_pixel_scaler_vectorizer_rectifier_cropper(channels):
    rng = np.random.default_rng(0)
    x = (rng.random((3, 7, 5, channels)) * 255).astype(np.float32)
    ops = [
        (jcore.GrayScaler(), tcore.GrayScaler()),
        (jcore.PixelScaler(), tcore.PixelScaler()),
        (jcore.ImageVectorizer(), tcore.ImageVectorizer()),
        (jcore.SymmetricRectifier(alpha=40.0), tcore.SymmetricRectifier(alpha=40.0)),
        (jcore.SymmetricRectifier(max_val=3.0, alpha=-1.0), tcore.SymmetricRectifier(max_val=3.0, alpha=-1.0)),
        (jcore.Cropper(1, 2, 6, 4), tcore.Cropper(1, 2, 6, 4)),
    ]
    for j, t in ops:
        want = np.asarray(j.apply_arrays(jnp.asarray(x)))
        got = t.apply_arrays(_t(x)).numpy()
        assert _rel(got, want) <= TOL, type(t).__name__


def test_pack_filters_and_patch_matrix_layout():
    """The packed filter index and the patch row index are both
    c + x·C + y·C·s, so one patch row dotted with one packed row is the
    valid convolution at that location."""
    rng = np.random.default_rng(1)
    filt = rng.normal(size=(4, 3, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(tcore.pack_filters(filt), jcore.pack_filters(filt))
    img = rng.normal(size=(1, 6, 5, 2)).astype(np.float32)
    p = tcore.patch_matrix(_t(img), 3).numpy()
    assert p.shape == (1, 4, 3, 18)
    for i in range(4):
        for j in range(3):
            np.testing.assert_array_equal(p[0, i, j], jimage.vectorize(img[0, i : i + 3, j : j + 3]))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("whiten", [False, True])
def test_convolver_matches_jax(normalize, whiten):
    rng = np.random.default_rng(3)
    imgs = rng.normal(size=(3, 10, 9, 3)).astype(np.float32)
    filt = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    jw, tw = _whiteners(27) if whiten else (None, None)
    j = jcore.Convolver.create(filt, whitener=jw, normalize_patches=normalize)
    t = tcore.Convolver.create(filt, whitener=tw, normalize_patches=normalize, device=CPU)
    want = np.asarray(j.apply_batch(JArrayDataset(imgs)).data)
    got = t.apply_batch(ArrayDataset(imgs, device=CPU)).data.numpy()
    assert got.shape == (3, 8, 7, 5)
    assert _rel(got, want) <= TOL


def test_convolver_create_flips_filters_and_rejects_non_square():
    rng = np.random.default_rng(4)
    imgs = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    filt = rng.normal(size=(3, 3, 3, 1)).astype(np.float32)
    j = jcore.Convolver.create(filt, flip_filters=True)
    t = tcore.Convolver.create(filt, flip_filters=True, device=CPU)
    assert _rel(t.apply_arrays(_t(imgs)).numpy(), np.asarray(j.apply_arrays(jnp.asarray(imgs)))) <= TOL
    with pytest.raises(ValueError, match="square"):
        tcore.Convolver(np.zeros((2, 10), np.float32), 1, device=CPU)


@pytest.mark.parametrize(
    "shape,stride,pool",
    [((12, 12, 2), 4, 4), ((13, 11, 2), 3, 6), ((7, 9, 3), 4, 5), ((27, 27, 4), 13, 14)],
)
@pytest.mark.parametrize("fn", ["sum", "max"])
def test_pooler_matches_jax(shape, stride, pool, fn):
    """Shapes (13, 11) and (7, 9) need padding with the pool's identity."""
    x = np.random.default_rng(2).normal(size=(2,) + shape).astype(np.float32)
    j = jcore.Pooler(stride, pool, pixel_function=abs, pool_function=fn)
    t = tcore.Pooler(stride, pool, pixel_function=abs, pool_function=fn)
    want = np.asarray(j.apply_arrays(jnp.asarray(x)))
    got = t.apply_arrays(_t(x)).numpy()
    assert got.shape == want.shape
    assert t.output_shape(shape[0], shape[1]) == want.shape[1:3]
    assert _rel(got, want) <= TOL
    with pytest.raises(ValueError, match="pool_function"):
        tcore.Pooler(stride, pool, pool_function="mean")


def _cifar_pair(num_filters, filter_block, whiten=False, normalize=True, seed=0):
    filters = np.random.default_rng(seed).normal(size=(num_filters, 6 * 6 * 3)).astype(np.float32) * 0.1
    jw, tw = _whiteners(108) if whiten else (None, None)
    j = jcore.FusedConvFeaturizer(
        jcore.Convolver(filters, 3, whitener=jw, normalize_patches=normalize),
        jcore.SymmetricRectifier(alpha=0.25), jcore.Pooler(13, 14, None, "sum"),
        filter_block=filter_block,
    )
    t = tcore.FusedConvFeaturizer(
        tcore.Convolver(filters, 3, whitener=tw, normalize_patches=normalize, device=CPU),
        tcore.SymmetricRectifier(alpha=0.25), tcore.Pooler(13, 14, None, "sum"),
        filter_block=filter_block,
    )
    t.image_chunk = 2  # several chunks at these sizes
    return j, t


@pytest.mark.parametrize("num_filters,filter_block", [(16, 8), (37, 8), (37, 64), (20, 7)])
def test_fused_featurizer_matches_jax_and_the_unfused_chain(num_filters, filter_block):
    """F divisible and not divisible by the block; images in chunks of 2."""
    j, t = _cifar_pair(num_filters, filter_block)
    imgs = np.random.default_rng(1).random((5, 32, 32, 3), dtype=np.float32)
    want = np.asarray(j.apply_arrays(jnp.asarray(imgs)))
    got = t.apply_arrays(_t(imgs)).numpy()
    assert got.shape == (5, 2 * 2 * 2 * num_filters)
    assert _rel(got, want) <= TOL
    unfused = tcore.ImageVectorizer().apply_arrays(
        t.pool.apply_arrays(t.rect.apply_arrays(t.conv.apply_arrays(_t(imgs))))
    ).numpy()
    assert _rel(got, unfused) <= TOL


@pytest.mark.parametrize("normalize", [True, False])
def test_fused_featurizer_with_whitener_matches_jax(normalize):
    j, t = _cifar_pair(20, 7, whiten=True, normalize=normalize)
    imgs = np.random.default_rng(2).random((3, 32, 32, 3), dtype=np.float32)
    assert _rel(t.apply_arrays(_t(imgs)).numpy(), np.asarray(j.apply_arrays(jnp.asarray(imgs)))) <= TOL


def test_fused_featurizer_packs_blocks_once_and_runs_in_a_pipeline():
    _, t = _cifar_pair(12, 5)
    kb, fs, off = t.packed_filter_blocks()
    assert tuple(kb.shape) == (3, 108, 5) and tuple(fs.shape) == (3, 5)
    assert float(kb[2, :, 2:].abs().sum()) == 0.0 and float(off.abs().sum()) == 0.0
    assert t.packed_filter_blocks()[0] is kb
    imgs = ArrayDataset(np.random.default_rng(3).random((4, 32, 32, 3)).astype(np.float32), device=CPU)
    out = t.to_pipeline()(imgs).get()
    assert tuple(out.data.shape) == (4, 2 * 2 * 24)


# ----------------------------------------------------------- host operators


def test_windower_and_patchers_equal_the_jax_package():
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(3, 9, 8, 2)).astype(np.float32)
    pairs = [
        (jcore.Windower(2, 4), tcore.Windower(2, 4)),
        (jcore.RandomPatcher(4, 3, 5, seed=7), tcore.RandomPatcher(4, 3, 5, seed=7)),
        (jcore.CenterCornerPatcher(5, 4, horizontal_flips=True),
         tcore.CenterCornerPatcher(5, 4, horizontal_flips=True)),
        (jcore.CenterCornerPatcher(5, 4), tcore.CenterCornerPatcher(5, 4)),
    ]
    for j, t in pairs:
        want = np.asarray(j.apply_batch(JArrayDataset(imgs)).data)
        got = t.apply_batch(ArrayDataset(imgs, device=CPU))
        assert got.device == CPU
        np.testing.assert_array_equal(got.data.numpy(), want)
        np.testing.assert_array_equal(np.asarray(t.apply(imgs[0])), np.asarray(j.apply(imgs[0])))


def test_random_image_transformer_equals_the_jax_package():
    imgs = np.random.default_rng(6).normal(size=(16, 5, 4, 3)).astype(np.float32)
    j = jcore.RandomImageTransformer(0.5, jimage.flip_horizontal, seed=3)
    t = tcore.RandomImageTransformer(0.5, timage.flip_horizontal, seed=3)
    want = np.asarray(j.apply_batch(JArrayDataset(imgs)).data)
    got = t.apply_batch(ArrayDataset(imgs, device=CPU)).data.numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, imgs) and not np.array_equal(got, imgs[:, :, ::-1])
    for img in imgs[:4]:
        np.testing.assert_array_equal(t.apply(img), j.apply(img))


def test_label_and_image_extractors():
    imgs = np.zeros((3, 2, 2, 1), np.float32)
    labels = np.array([4, 1, 7], np.int32)
    ds = ArrayDataset({"image": imgs, "label": labels}, device=CPU)
    assert tcore.LabelExtractor().apply_batch(ds).data.tolist() == [4, 1, 7]
    assert tuple(tcore.ImageExtractor().apply_batch(ds).data.shape) == (3, 2, 2, 1)
    assert tcore.MultiLabelExtractor is tcore.LabelExtractor
    assert tcore.LabelExtractor().apply({"image": imgs[0], "label": 5}) == 5


# --------------------------------------------------------------------- ZCA


@pytest.mark.parametrize("eps", [0.1, 1e-5])
def test_zca_whitener_matches_jax(eps):
    """W and μ against the JAX fit; whitened rows against the JAX
    whitener's (the patch rows are CIFAR-like: row-normalized windows)."""
    rng = np.random.default_rng(7)
    raw = rng.normal(size=(500, 27)) @ rng.normal(size=(27, 27))
    mat = (raw - raw.mean(axis=1, keepdims=True)) / np.sqrt(raw.var(axis=1, keepdims=True) + 10.0)
    mat = mat.astype(np.float32)
    j = jzca.ZCAWhitenerEstimator(eps=eps).fit_single(mat)
    t = tzca.ZCAWhitenerEstimator(eps=eps, device=CPU).fit_single(mat)
    assert _rel(t.whitener.numpy(), np.asarray(j.whitener)) <= TOL
    assert _rel(t.means.numpy(), np.asarray(j.means)) <= TOL
    got = t.apply_batch(ArrayDataset(mat[:50], device=CPU)).data.numpy()
    want = np.asarray(j.apply_batch(JArrayDataset(mat[:50])).data)
    assert _rel(got, want) <= (TOL if eps >= 0.1 else ZCA_ROWS_TOL_SMALL_EPS)
    t_fit = tzca.ZCAWhitenerEstimator(eps=eps, device=CPU).fit(ArrayDataset(mat, device=CPU))
    assert _rel(t_fit.whitener.numpy(), t.whitener.numpy()) == 0.0
