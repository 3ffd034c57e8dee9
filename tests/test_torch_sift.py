"""The port's dense SIFT, DAISY and HOG (``ops/images/sift.py``,
``daisy.py``, ``hog.py``) held to the JAX package on the CPU, and SIFT to
the OpenCV fixture the JAX suite uses.

Bounds, each with the value read on the CPU:

- SIFT against the JAX package: the reference's own gate
  (VLFeatSuite.scala:47-52, as ``tests/ops/test_sift_opencv_fixture.py``
  applies it): ≥ 99.5% of the ×512-quantized entries within 1 and none
  off by more than 1. Read: every entry within 1, 99.996–99.999% exactly
  equal (fp32 sums in another order flip an entry that lands on a
  quantization step);
- the OpenCV fixture: mean cosine > 0.95 and p10 > 0.9, the JAX test's
  thresholds (read 0.974 / 0.961 for seed 42, 0.977 / 0.963 for seed 7);
- bf16 binning against the fp32 build: ≥ 99.5% within 1 (read 100%,
  98.3% exactly equal), and the fixture's mean cosine (read 0.974);
- DAISY and HOG against the JAX package ≤ 1e-5 relative (read 1.0e-7
  and ≤ 7.4e-8).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.ops.images.daisy import DaisyExtractor as JDaisy
from keystone_tpu.ops.images.hog import HogExtractor as JHog
from keystone_tpu.ops.images.sift import SIFTExtractor as JSIFT
from keystone_tpu_torch.ops.images import DaisyExtractor, HogExtractor, SIFTExtractor

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "sift_opencv")
WITHIN_ONE = 0.995


def _smooth_images(n, size, seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return np.stack([gaussian_filter(rng.random((size, size)), 1.5) for _ in range(n)]).astype(np.float32)


def _within_one(got, want):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((diff <= 1.0).mean()), float(diff.max()), float((diff == 0).mean())


@pytest.mark.parametrize("size,scales,scale_step", [(64, 1, 0), (64, 4, 1), (80, 4, 0), (80, 1, 1)])
def test_sift_matches_the_jax_package_within_one_step(size, scales, scale_step):
    x = _smooth_images(3, size, seed=size + scales)
    want = np.asarray(JSIFT(scales=scales, scale_step=scale_step).apply_arrays(jnp.asarray(x)))
    ext = SIFTExtractor(scales=scales, scale_step=scale_step)
    ext.image_chunk = 2  # two chunks, the second ragged
    got = ext.apply_arrays(torch.from_numpy(x)[..., None]).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == sum(ext.grid_counts(size, size))
    within, worst, _ = _within_one(got, want)
    assert within >= WITHIN_ONE and worst <= 1.0


def test_sift_too_small_an_image_raises():
    with pytest.raises(ValueError, match="too small"):
        SIFTExtractor(scales=1).apply_arrays(torch.zeros(1, 8, 8))


# ------------------------------------------------------------- OpenCV fixture
# tests/ops/test_sift_opencv_fixture.py's construction and convention map.
BIN_SIZE, STEP, IMG_SIZE, ORIENT_ROLL = 4, 4, 80, 6


def _fixture_image(seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.random((IMG_SIZE, IMG_SIZE)).astype(np.float32), 3.0, mode="nearest")
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8).astype(np.float32) / 255.0


def _cosines_vs_fixture(desc, seed):
    fixture = np.loadtxt(os.path.join(FIXTURE_DIR, f"opencv_dsift_seed{seed}.csv"),
                         delimiter=",").astype(np.float32)
    mapped = np.roll(np.transpose(desc.reshape(-1, 4, 4, 8), (0, 2, 1, 3)), ORIENT_ROLL, axis=-1)
    mapped = mapped.reshape(-1, 128)
    assert mapped.shape == fixture.shape
    na = np.linalg.norm(mapped, axis=1) + 1e-9
    nb = np.linalg.norm(fixture, axis=1) + 1e-9
    return (mapped * fixture).sum(axis=1) / (na * nb)


@pytest.mark.parametrize("seed", [42, 7])
def test_sift_matches_the_opencv_fixture(seed):
    ext = SIFTExtractor(step_size=STEP, bin_size=BIN_SIZE, scales=1, scale_step=1)
    desc = ext.apply_arrays(torch.from_numpy(_fixture_image(seed)[None])).numpy()[0]
    cos = _cosines_vs_fixture(desc, seed)
    assert cos.mean() > 0.95 and np.quantile(cos, 0.1) > 0.9


def test_bf16_binning_passes_the_reference_tolerance():
    img = torch.from_numpy(_fixture_image(42)[None])
    f32 = SIFTExtractor(step_size=STEP, bin_size=BIN_SIZE, scales=1).apply_arrays(img).numpy()[0]
    b16 = SIFTExtractor(step_size=STEP, bin_size=BIN_SIZE, scales=1,
                        binning_dtype=torch.bfloat16).apply_arrays(img).numpy()[0]
    within, _, _ = _within_one(b16, f32)
    assert within >= WITHIN_ONE
    assert _cosines_vs_fixture(b16, 42).mean() > 0.95


# ---------------------------------------------------------------- DAISY, HOG


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_daisy_matches_the_jax_package():
    x = (np.random.default_rng(1).random((2, 48, 40)) * 255).astype(np.float32)
    want = np.asarray(JDaisy().apply_arrays(jnp.asarray(x)))
    got = DaisyExtractor().apply_arrays(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4 * 2, DaisyExtractor().feature_size)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 40, 56, 3), (1, 33, 47, 1)])
def test_hog_matches_the_jax_package(shape):
    x = (np.random.default_rng(2).random(shape) * 255).astype(np.float32)
    want = np.asarray(JHog().apply_arrays(jnp.asarray(x)))
    got = HogExtractor().apply_arrays(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5
