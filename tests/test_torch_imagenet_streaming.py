"""The streaming ImageNet flagship in the port
(``pipelines/imagenet_streaming.py``, ``ops/stats/jax_random.py``,
``utils/aot.py::warm_flagship``, ``convert.flagship_codebooks_from_numpy``
and the CLI's ``imagenet-native-streaming``) held to the JAX package on
the CPU, on ``tests/pipelines/test_imagenet_streaming.py:18-30``'s
fixture unless a test says otherwise.

Bounds, each with the value read on the CPU:

- ``PRNGKey``, ``fold_in`` (of an int and of a tensor), ``split`` and the
  float32 ``uniform`` draws: exactly equal. ``gumbel``: within
  2.4e-7·max(1, |g|) (two float32 steps at |g| ≥ 1; torch's float32
  ``log`` is not XLA's; read: 23% of entries apart, by at most
  1.8e-7·max(1, |g|)), and the slots its top-k picks exactly equal;
- ``_sample_descriptors``: the picked slots and validity exactly equal,
  SIFT rows to SIFT's own gate (the quantized values, the Hellinger map
  undone, ≥ 99.5% equal and none more than one step apart; read 1 entry
  of 6,144 one step apart), LCS rows to the LCS bounds of
  ``tests/test_torch_imagenet.py`` (means ≤ 1e-5 relative to the
  largest, stds ≤ 0.05 absolute; read 8.4e-5 absolute on stds);
- ``fit_codebooks``: PCA components and GMM parameters ≤ 1e-2 relative
  (read 2.0e-3 for SIFT's PCA, 2.5e-3 for its GMM means, ≤ 2.2e-5 for
  LCS): the two packages' SIFT descriptors differ by one quantization
  step at a few entries, and a PCA of 96 sample rows passes that on;
- the encode with JAX-fitted codebooks carried by ``convert``: ≤ 1e-3
  relative to the JAX package's rows (read 1.0e-4: SIFT entries one step
  apart, through the signed Hellinger map, as for the carried Pipeline-API
  flagship in ``tests/test_torch_imagenet.py``);
- the fused encode against the op-by-op composition through the
  workflow operators: ≤ 1e-5 relative (read 0);
- ``encode_buckets`` for prefetch 1, 2, 3 and through ``on_rows``, and
  ``save`` → ``load``: bitwise equal;
- the synthetic templates' 8×8 fields exactly equal; upsampled against
  ``jax.image.resize(..., "bilinear")`` ≤ 2e-4 absolute on the 0–255
  scale (read 7.6e-5: fp32 rounding of the same half-pixel weights);
- ``run_flagship_ondevice(64, 16, 4, 48, 16)``: top-5 error ≤ 25%,
  4,096 features (the JAX test's own bounds,
  ``tests/pipelines/test_imagenet_streaming.py:152-160``);
- ``run_native_resolution_streaming`` on a PIL-built tar: buckets,
  counts, widths and the training and test top-5 error equal the JAX
  package's.
"""

import json
import pickle
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keystone_tpu.data.buckets import bucketize_images as jbucketize_images
from keystone_tpu.pipelines import imagenet_streaming as jstreaming
from keystone_tpu.pipelines.imagenet import ImageNetSiftLcsFVConfig as JConfig
from keystone_tpu.utils.aot import warm_flagship as jwarm_flagship
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.buckets import bucketize_images
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.images import GrayScaler, MaskedExtractor, PixelScaler
from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer
from keystone_tpu_torch.ops.stats import jax_random
from keystone_tpu_torch.ops.stats.core import NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.ops.util.vectors import MatrixVectorizer, VectorCombiner
from keystone_tpu_torch.pipelines import imagenet_streaming as streaming
from keystone_tpu_torch.pipelines.imagenet import ApplyArrays, ImageNetSiftLcsFVConfig
from keystone_tpu_torch.utils.aot import warm_flagship
from keystone_tpu_torch.workflow.executor import PipelineEnv

PIL = pytest.importorskip("PIL")
from PIL import Image as PILImage  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = dict(desc_dim=16, vocab_size=4)


@pytest.fixture(autouse=True)
def _fresh_port_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _records():
    rng = np.random.default_rng(0)
    return [{"image": rng.integers(0, 256, (s, s, 3), dtype=np.uint8)}
            for s in (48, 48, 64, 64, 64, 80)]


def _dicts(buckets):
    return [{"image": b.images, "dims": b.dims} for b in buckets]


@pytest.fixture(scope="module")
def fitted():
    """Both packages' flagships fitted on the same buckets (16 samples per
    image), and the buckets."""
    jbuckets = jbucketize_images(_records(), granularity=16, max_rows=4)
    buckets = bucketize_images(_records(), granularity=16, max_rows=4)
    jfs = jstreaming.StreamingFlagship(JConfig(**SMALL))
    jfs.fit_codebooks(_dicts(jbuckets), per_image=16)
    fs = streaming.StreamingFlagship(ImageNetSiftLcsFVConfig(**SMALL), device=CPU)
    fs.fit_codebooks(_dicts(buckets), per_image=16)
    return jfs, fs, buckets


# ------------------------------------------------------------ jax.random


def test_key_derivation_and_uniform_bits_equal_jax_random():
    key = jax.random.PRNGKey(42)
    assert tuple(np.asarray(key).tolist()) == jax_random.prng_key(42)
    for data in (0, 3, 999, 2**31 - 1):
        assert tuple(np.asarray(jax.random.fold_in(key, data)).tolist()) \
            == jax_random.fold_in(jax_random.prng_key(42), data)
    sub = jax.random.fold_in(key, 3)
    port_sub = jax_random.fold_in(jax_random.prng_key(42), 3)
    for num in (2, 3):
        assert [tuple(k) for k in np.asarray(jax.random.split(sub, num)).tolist()] \
            == list(jax_random.split(port_sub, num))
    for shape, lo, hi in (((8, 8, 3), 0.0, 255.0), ((5, 1031), 0.0, 1.0), ((3, 2, 7), -2.0, 3.5)):
        want = np.asarray(jax.random.uniform(sub, shape, minval=lo, maxval=hi))
        got = jax_random.uniform(port_sub, shape, CPU, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got, want)
    # A tensor of data folds into a batch of keys, each drawing its own.
    labels = np.array([0, 5, 7, 999])
    keys = jax_random.fold_in(jax_random.prng_key(7), torch.tensor(labels))
    got = jax_random.uniform(keys, (8, 8, 3), CPU, 0.0, 255.0).numpy()
    want = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(7), int(v)),
                                                   (8, 8, 3), minval=0.0, maxval=255.0))
                     for v in labels])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        jax_random.jax_uniform_mantissas(11, 100, CPU).numpy() * 2.0**-23,
        np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (100,))))


@pytest.mark.parametrize("shape", [(4, 300), (64, 13_165)])
def test_gumbel_within_float32_steps_and_its_top_k_picks_the_jax_rows(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(42), shape[0])
    port_key = jax_random.fold_in(jax_random.prng_key(42), shape[0])
    want = np.asarray(jax.random.gumbel(key, shape))
    got = jax_random.gumbel(port_key, shape, CPU).numpy()
    assert np.all(np.abs(got - want) <= 2.4e-7 * np.maximum(np.abs(want), 1.0))
    valid = np.random.default_rng(1).random(shape) < 0.8
    take = 64
    jidx = np.asarray(jax.lax.top_k(jnp.where(jnp.asarray(valid), want, -jnp.inf), take)[1])
    tidx = jax_random.top_k_indices(
        torch.where(torch.from_numpy(valid), torch.from_numpy(got), torch.tensor(-torch.inf)), take)
    np.testing.assert_array_equal(tidx.numpy(), jidx)


def test_top_k_orders_ties_by_the_lower_index_as_lax_top_k():
    scores = np.array([[0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0], [-np.inf] * 8], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 5)[1])
    np.testing.assert_array_equal(jax_random.top_k_indices(torch.from_numpy(scores), 5).numpy(), want)


# ------------------------------------------------------------ the flagship


def test_sample_descriptors_pick_the_jax_rows(fitted):
    jfs, fs, buckets = fitted
    for i, b in enumerate(buckets):
        want = jfs._sample_jit(jnp.asarray(b.images), jnp.asarray(b.dims), 16,
                               jax.random.fold_in(jax.random.PRNGKey(42), i))
        got = fs._sample_descriptors(torch.from_numpy(b.images), torch.from_numpy(b.dims), 16,
                                     jax_random.fold_in(jax_random.prng_key(42), i))
        s_flat, s_ok, l_flat, l_ok = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(got[1].numpy(), s_ok > 0)
        np.testing.assert_array_equal(got[3].numpy(), l_ok > 0)
        # SIFT rows after the Hellinger map: squared, the quantized values,
        # at most one step apart, as SIFT's own gate holds them.
        steps = np.abs(got[0].numpy() ** 2 - s_flat.astype(np.float64) ** 2)
        assert steps.max() <= 1.0 + 1e-3 and (steps < 1e-3).mean() >= 0.995
        lcs = got[2].numpy()
        assert np.abs(lcs[:, 0::2] - l_flat[:, 0::2]).max() <= 1e-5 * np.abs(l_flat).max()
        assert np.abs(lcs[:, 1::2] - l_flat[:, 1::2]).max() <= 0.05


def test_fit_codebooks_against_the_jax_package(fitted):
    jfs, fs, _ = fitted
    jcb, cb = jfs.codebooks, fs.codebooks
    assert cb.fv_dim == jcb.fv_dim == 2 * 16 * 2 * 4
    assert _rel(cb.sift_pca, np.asarray(jcb.sift_pca)) <= 1e-2
    assert _rel(cb.lcs_pca, np.asarray(jcb.lcs_pca)) <= 1e-2
    for branch in ("sift_fv", "lcs_fv"):
        jg, g = getattr(jcb, branch).gmm, getattr(cb, branch).gmm
        for name in ("means", "variances", "weights"):
            assert _rel(getattr(g, name), np.asarray(getattr(jg, name))) <= 1e-2, (branch, name)


def test_encode_with_carried_codebooks_matches_the_jax_package(fitted):
    jfs, _, buckets = fitted
    jcb = jfs.codebooks
    carried = convert.flagship_codebooks_from_numpy(
        np.asarray(jcb.sift_pca), np.asarray(jcb.lcs_pca), jstreaming._gmm_arrays(jcb.sift_fv.gmm),
        jstreaming._gmm_arrays(jcb.lcs_fv.gmm), device=CPU)
    fs = streaming.StreamingFlagship(ImageNetSiftLcsFVConfig(**SMALL), device=CPU)
    fs.adopt_codebooks(carried)
    want = jfs.encode_buckets(_dicts(buckets))
    got = fs.encode_buckets(_dicts(buckets))
    assert got.shape == want.shape == (6, 256)
    assert _rel(got, want) <= 1e-3


def op_by_op(fs, images, dims):
    """The fused encode's chain, one workflow operator at a time: masked
    extractor → PCA → Fisher vector → vectorize → normalize → Hellinger →
    normalize per branch, then the combiner."""
    data = ArrayDataset({"image": images, "dims": dims})
    cb = fs.codebooks
    branches = (
        (MaskedExtractor(fs._sift, pre=ApplyArrays(PixelScaler(), GrayScaler()),
                         post=SignedHellingerMapper().apply_arrays), cb.sift_pca, cb.sift_fv),
        (MaskedExtractor(fs._lcs), cb.lcs_pca, cb.lcs_fv),
    )
    rows = []
    for extractor, pca, fv in branches:
        out = extractor.apply_batch(data)
        for op in (BatchPCATransformer(pca), fv, MatrixVectorizer(), NormalizeRows(),
                   SignedHellingerMapper(), NormalizeRows()):
            out = op.apply_batch(out)
        rows.append(out.data)
    return VectorCombiner().apply_arrays(rows)


def test_fused_encode_equals_the_op_by_op_composition(fitted):
    _, fs, buckets = fitted
    for b in buckets:
        images, dims = torch.from_numpy(b.images), torch.from_numpy(b.dims)
        fused = fs._encode_bucket(images, dims, fs.codebooks.sift_pca, fs.codebooks.lcs_pca)
        assert _rel(fused, op_by_op(fs, images, dims)) <= 1e-5


def test_encode_buckets_rows_equal_for_every_prefetch_and_through_on_rows(fitted):
    _, fs, buckets = fitted
    base = fs.encode_buckets(_dicts(buckets), prefetch=1)
    n = sum(len(b) for b in buckets)
    assert base.shape == (n, 256) and np.isfinite(base).all()
    norms = np.linalg.norm(base, axis=1)
    assert np.all(norms > 0.1) and np.all(norms < 2.1)
    for prefetch in (2, 3):
        np.testing.assert_array_equal(fs.encode_buckets(_dicts(buckets), prefetch=prefetch), base)
    seen = []
    assert fs.encode_buckets(_dicts(buckets), on_rows=lambda rows, b: seen.append((rows, b))) is None
    np.testing.assert_array_equal(np.concatenate([rows for rows, _ in seen]), base)
    assert [len(b["dims"]) for _, b in seen] == [len(b) for b in buckets]
    with pytest.raises(NotImplementedError, match="item 14"):
        fs.encode_buckets(_dicts(buckets), mesh=object())


@pytest.mark.parametrize("binning", [None, torch.bfloat16])
def test_save_load_round_trip_encodes_bit_for_bit(fitted, tmp_path, binning):
    _, fitted_fs, buckets = fitted
    fs = streaming.StreamingFlagship(ImageNetSiftLcsFVConfig(**SMALL), sift_binning_dtype=binning,
                                     device=CPU)
    fs.adopt_codebooks(fitted_fs.codebooks)
    before = fs.encode_buckets(_dicts(buckets[:1]))
    path = str(tmp_path / "flagship.pkl")
    fs.save(path, model={"note": "anything picklable rides along"})
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert all(isinstance(a, np.ndarray) for a in (payload["codebooks"]["sift_pca"],
                                                   *payload["codebooks"]["lcs_gmm"]))
    fs2, model = streaming.StreamingFlagship.load(path, device=CPU)
    assert model == {"note": "anything picklable rides along"}
    assert fs2._sift_binning_dtype == binning
    np.testing.assert_array_equal(fs2.encode_buckets(_dicts(buckets[:1])), before)


def test_synthetic_templates_equal_the_jax_package():
    labels = np.array([0, 3, 17, 999])
    for size in (48, 256):
        want = np.stack([np.asarray(jax.image.resize(
            jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(7), int(v)), (8, 8, 3),
                               minval=0.0, maxval=255.0), (size, size, 3), method="bilinear"))
            for v in labels])
        got = streaming.synth_templates(torch.from_numpy(labels), size).numpy()
        assert np.abs(got - want).max() <= 2e-4
    # At 8×8 the resize is the identity: the fields themselves, bit for bit.
    np.testing.assert_array_equal(
        streaming.synth_templates(torch.from_numpy(labels), 8).numpy(),
        np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(7), int(v)),
                                                (8, 8, 3), minval=0.0, maxval=255.0)) for v in labels]))


def test_flagship_ondevice_learns_planted_classes():
    out = streaming.run_flagship_ondevice(num_train=64, num_test=16, num_classes=4, image_size=48,
                                          batch=16, device=CPU)
    assert out["top5_err_percent"] <= 25.0
    assert out["encode_images_per_sec"] > 0 and out["encoded_images"] == 80
    assert out["fv_dim_combined"] == 4096
    assert out["solve_path"] == "woodbury"


def test_flagship_deadline_truncates_gracefully():
    r = streaming.run_flagship_ondevice(num_train=48, num_test=16, num_classes=4, image_size=64,
                                        batch=16, deadline_left_fn=lambda: 0.0, device=CPU)
    assert r["truncated"] == "deadline mid-encode at 0/64"
    assert "codebook_fit_s" in r
    assert "top5_err_percent" not in r
    # With time left for the encode only, the run stops before the solve.
    left = iter([1000.0, 100.0])
    r = streaming.run_flagship_ondevice(num_train=48, num_test=16, num_classes=4, image_size=48,
                                        batch=16, deadline_left_fn=lambda: next(left), device=CPU)
    assert r["truncated"] == "deadline before solve" and r["encoded_images"] == 64


def _jpeg(rng, color, w, h):
    import io

    arr = np.clip(rng.integers(0, 60, size=(h, w, 3)) + np.asarray(color), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PILImage.fromarray(arr, "RGB").save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def _native_tar(tmp_path):
    """Six classes of one colour each, three JPEGs per class at three
    sizes."""
    import io

    rng = np.random.default_rng(0)
    colors = [(180, 30, 30), (30, 180, 30), (30, 30, 180), (160, 160, 20), (20, 160, 160),
              (160, 20, 160)]
    sizes = [(48, 48), (60, 52), (72, 64)]
    tar_path = tmp_path / "native.tar"
    with tarfile.open(tar_path, "w") as tar:
        for c, color in enumerate(colors):
            for i, (w, h) in enumerate(sizes):
                payload = _jpeg(rng, color, w, h)
                info = tarfile.TarInfo(f"n{c:02d}/img{i}.jpg")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"n{c:02d} {c}\n" for c in range(len(colors))))
    return str(tar_path), str(labels)


NATIVE = dict(desc_dim=8, vocab_size=3, num_classes=6, solver_block_size=64, lcs_stride=8)


def test_native_resolution_streaming_matches_the_jax_package(tmp_path):
    tar_path, labels_path = _native_tar(tmp_path)
    kw = dict(train_location=tar_path, test_location=tar_path, label_path=labels_path, **NATIVE)
    want = jstreaming.run_native_resolution_streaming(JConfig(**kw), max_rows=4)
    got = streaming.run_native_resolution_streaming(ImageNetSiftLcsFVConfig(**kw), max_rows=4,
                                                    device=CPU)
    for key in ("num_train", "num_buckets", "fv_dim_combined", "num_test",
                "train_top5_err_percent", "test_top5_err_percent"):
        assert got[key] == want[key], key
    assert got["num_train"] == 18 and got["fv_dim_combined"] == 2 * 8 * 2 * 3
    assert got["bucket_shapes"] == [(64, 64), (64, 96)]
    assert 0.0 < got["padding_share"] < 1.0
    assert isinstance(got["flagship"], streaming.StreamingFlagship)


def test_runner_needs_its_inputs():
    with pytest.raises(ValueError, match="--train-location"):
        streaming.run_native_resolution_streaming(ImageNetSiftLcsFVConfig(), device=CPU)


def test_warm_flagship_keys_match_the_jax_package():
    cfg = dict(desc_dim=8, vocab_size=2, solver_block_size=32)
    shapes = dict(bucket_shapes=((2, 48, 48),), solver_shapes=((40, 64, 3),))
    want = jwarm_flagship(JConfig(**cfg), enable_persistent_cache=False, **shapes)
    got = warm_flagship(ImageNetSiftLcsFVConfig(**cfg), device=CPU, **shapes)
    assert set(got) == set(want) == {"encode_2x48x48_s", "solve_40x64x3_s"}
    assert all(v >= 0.0 for v in got.values())


def test_cli_runs_the_streaming_workload_and_needs_a_card_without_device(tmp_path, monkeypatch):
    tar_path, labels_path = _native_tar(tmp_path)
    config = ImageNetSiftLcsFVConfig(train_location=tar_path, label_path=labels_path, **NATIVE)
    want = streaming.run_native_resolution_streaming(config, device=CPU)
    flags = ["--train-location", tar_path, "--label-path", labels_path, "--desc-dim", "8",
             "--vocab-size", "3", "--num-classes", "6", "--solver-block-size", "64",
             "--lcs-stride", "8", "--use-native", "false"]
    out = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", "imagenet-native-streaming",
                          *flags, "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["workload"] == "imagenet-native-streaming"
    assert line["train_top5_err_percent"] == want["train_top5_err_percent"]
    assert line["num_train"] == 18 and "flagship" not in line

    from keystone_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["imagenet-native-streaming", *flags])
