"""The ImageNet SIFT + LCS + Fisher-vector flagship in the port
(``ops/images/{lcs,native}.py``, ``ops/learning/weighted.py``,
``data/buckets.py``, ``data/loaders/imagenet.py``, the masked paths of
``SIFTExtractor`` / ``FisherVector`` / ``ColumnSampler`` /
``BatchPCATransformer`` / ``ColumnPCAEstimator``, the bucketed
``GatherTransformer``, ``pipelines/imagenet.py``,
``convert.imagenet_pipeline_from_numpy`` and the CLI's
``imagenet-sift-lcs-fv`` / ``imagenet-native``) held to the JAX package
on the CPU.

Bounds, each with the value read on the CPU:

- LCS means ≤ 1e-5 relative to the largest (read 1.2e-7); LCS stds to an
  absolute 0.05 on the 0–255 pixel scale (read 1.2e-4, flat patches at
  255 and 100 included), not a relative bound: where a patch is flat,
  E[x²] − m² cancels (fp32's step at 65,025 is 0.0078) and the two
  packages' sums in other orders leave different residues under the
  square root; plain and masked (read 9.2e-5);
- the weighted estimators' predictions and weights ≤ 1e-5 relative on
  both solve paths (read ≤ 2.1e-7), intercepts ≤ 1e-5 absolute, the
  absent-class rule of ``joint_label_means`` exact;
- buckets, labels, ``concat`` order, the bucketed gather, the masked
  sampler's rows, the masked PCA projection's validity: exactly equal;
  masked PCA and Fisher vectors ≤ 1e-5 relative (read 2.2e-7, 2.0e-7);
- masked SIFT against the JAX package: the reference's gate (≥ 99.5% of
  entries within 1, none further; read 100%, 99.9987–99.9993% equal) and
  valid masks equal; ``MaskedExtractor`` equal to the raw masked
  extractor; a bucket's valid descriptors against a native-size run of
  each image: the same gate (read bitwise equal);
- the flagship end to end at ``tests/pipelines/test_imagenet.py:53``'s
  configuration: the top-5 predictions and the error equal the JAX
  pipeline's; the native-resolution run at ``:76``'s: buckets, counts
  and the training error equal;
- a JAX-fitted flagship carried through ``convert`` (all 10 classes
  present): scores ≤ 1e-3 relative (read 2.2e-4: the two packages' SIFT
  descriptors read 2.1e-4 apart on these images, entries one
  quantization step apart, which the signed Hellinger map's square root
  amplifies near zero), and the top 5 equal on every row whose order
  through rank 6 is clear of that agreement (≥ 10 of 20 rows; read 14).
"""

import io
import json
import pickle
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data import buckets as jbuckets
from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.data.dataset import BucketedDataset as JBucketedDataset
from keystone_tpu.data.loaders import imagenet as jimagenet_loader
from keystone_tpu.ops.images.fisher import FisherVector as JFisherVector
from keystone_tpu.ops.images.lcs import LCSExtractor as JLCS
from keystone_tpu.ops.images.native import MaskedExtractor as JMaskedExtractor
from keystone_tpu.ops.images.sift import SIFTExtractor as JSIFT
from keystone_tpu.ops.learning import weighted as jweighted
from keystone_tpu.ops.learning.block import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.ops.learning.gmm import GaussianMixtureModel as JGMM
from keystone_tpu.ops.learning.pca import BatchPCATransformer as JBatchPCA
from keystone_tpu.ops.stats.core import ColumnSampler as JColumnSampler
from keystone_tpu.ops.util.gather import GatherTransformer as JGather
from keystone_tpu.ops.util.labels import ClassLabelIndicators as JClassLabelIndicators
from keystone_tpu.pipelines import imagenet as jimagenet
from keystone_tpu_torch import convert
from keystone_tpu_torch.data import buckets
from keystone_tpu_torch.data.dataset import ArrayDataset, BucketedDataset
from keystone_tpu_torch.data.loaders import imagenet as imagenet_loader
from keystone_tpu_torch.ops.images import ConcatBuckets, FisherVector, LCSExtractor, MaskedExtractor
from keystone_tpu_torch.ops.images.sift import SIFTExtractor
from keystone_tpu_torch.ops.learning import weighted
from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from keystone_tpu_torch.ops.stats.core import ColumnSampler
from keystone_tpu_torch.ops.util.gather import GatherTransformer
from keystone_tpu_torch.pipelines import imagenet
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.optimize import DataStats
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

PIL = pytest.importorskip("PIL")
from PIL import Image as PILImage  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
WITHIN_ONE = 0.995


@pytest.fixture(autouse=True)
def _fresh_port_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _within_one(got, want):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((diff <= 1.0).mean()), float(diff.max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -------------------------------------------------------------------- LCS


def _lcs_images():
    rng = np.random.default_rng(0)
    x = (rng.random((3, 64, 72, 3)) * 255).astype(np.float32)
    x[0, :24, :24] = 255.0  # flat patches: the stds' cancellation
    x[1, 30:, 40:] = 100.0
    return x


@pytest.mark.parametrize("kwargs", [dict(), dict(stride=8), dict(stride=4, stride_start=12, sub_patch_size=4)])
def test_lcs_matches_the_jax_package(kwargs):
    x = _lcs_images()
    want = np.asarray(JLCS(**kwargs).apply_arrays(jnp.asarray(x)))
    ext = LCSExtractor(**kwargs)
    ext.image_chunk = 2
    got = ext.apply_arrays(_t(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got[..., 0::2] - want[..., 0::2]).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got[..., 1::2] - want[..., 1::2]).max() <= 0.05


def test_masked_lcs_matches_the_jax_package_and_native_size_runs():
    x = _lcs_images()
    dims = np.array([[64, 72], [50, 60], [40, 41]], np.int32)
    want, want_valid = JLCS().apply_arrays_masked(jnp.asarray(x), jnp.asarray(dims))
    got, valid = LCSExtractor().apply_arrays_masked(_t(x), _t(dims))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 0.05
    for i, (xn, yn) in enumerate(dims):
        own = LCSExtractor().apply_arrays(_t(x[i : i + 1, :xn, :yn]))[0]
        assert int(valid[i].sum()) == own.shape[0]
        np.testing.assert_allclose(got[i][valid[i]].numpy(), own.numpy(), atol=0.05)


# --------------------------------------------------------------- weighted


def _weighted_problem(n=120, d=48, classes=7, absent=True, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, classes - 1 if absent else classes, size=n)
    y = -np.ones((n, classes), np.float32)
    y[np.arange(n), labels] = 1.0
    return x, y


@pytest.mark.parametrize("path", ["dense", "woodbury", "auto"])
@pytest.mark.parametrize("block,num_iter", [(16, 2), (48, 1)])
def test_block_weighted_estimator_matches_the_jax_package(path, block, num_iter):
    x, y = _weighted_problem()
    je = jweighted.BlockWeightedLeastSquaresEstimator(block, num_iter, 0.1, 0.25, solve_path=path)
    est = weighted.BlockWeightedLeastSquaresEstimator(block, num_iter, 0.1, 0.25, solve_path=path)
    jm = je.fit(JArrayDataset(x), JArrayDataset(y))
    m = est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    assert est.last_solve_path == ("dense" if path == "auto" else path)
    want = np.asarray(jm.apply_arrays(jnp.asarray(x)))
    got = m.apply_arrays(_t(x)).numpy()
    assert _rel(got, want) <= 1e-5
    assert _rel(m.weights.numpy(), np.asarray(jm.weights)) <= 1e-5
    assert np.abs(m.intercept.numpy() - np.asarray(jm.intercept)).max() <= 1e-5
    # The absent class (6): zero weights, intercept −1.
    assert not m.weights[:, 6].any() and m.intercept[6].item() == -1.0


def test_block_weighted_auto_takes_woodbury_for_small_classes_in_class_groups(monkeypatch):
    x, y = _weighted_problem(n=60, d=96, classes=20, seed=1)
    monkeypatch.setattr(weighted, "CLASS_GROUP_BYTES", 1)  # one class per group
    je = jweighted.BlockWeightedLeastSquaresEstimator(96, 1, 0.05, 0.25)
    est = weighted.BlockWeightedLeastSquaresEstimator(96, 1, 0.05, 0.25)
    jm = je.fit(JArrayDataset(x), JArrayDataset(y))
    m = est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    assert est.last_solve_path == "woodbury"
    assert _rel(m.apply_arrays(_t(x)).numpy(), np.asarray(jm.apply_arrays(jnp.asarray(x)))) <= 1e-5


def test_mixture_weight_endpoints_take_the_dense_path():
    x, y = _weighted_problem(n=40, d=16, classes=4, absent=False)
    for mw in (0.0, 1.0):
        est = weighted.BlockWeightedLeastSquaresEstimator(16, 1, 0.1, mw)
        assert est.solve_path == "dense"
        m = est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
        jm = jweighted.BlockWeightedLeastSquaresEstimator(16, 1, 0.1, mw).fit(JArrayDataset(x), JArrayDataset(y))
        assert _rel(m.apply_arrays(_t(x)).numpy(), np.asarray(jm.apply_arrays(jnp.asarray(x)))) <= 1e-5
    with pytest.raises(ValueError, match="woodbury"):
        weighted.BlockWeightedLeastSquaresEstimator(16, 1, 0.1, 1.0, solve_path="woodbury")
    with pytest.raises(ValueError, match="mixture_weight"):
        weighted.BlockWeightedLeastSquaresEstimator(16, 1, 0.1, 1.5)


def test_per_class_weighted_estimator_and_joint_label_means_match_the_jax_package():
    x, y = _weighted_problem()
    jm = jweighted.PerClassWeightedLeastSquaresEstimator(16, 2, 0.1, 0.25).fit(JArrayDataset(x), JArrayDataset(y))
    m = weighted.PerClassWeightedLeastSquaresEstimator(16, 2, 0.1, 0.25).fit(
        ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    assert _rel(m.apply_arrays(_t(x)).numpy(), np.asarray(jm.apply_arrays(jnp.asarray(x)))) <= 1e-5
    assert _rel(m.weights.numpy(), np.asarray(jm.weights)) <= 1e-5
    counts = np.array([0, 3, 5, 0, 12])
    np.testing.assert_array_equal(weighted.joint_label_means(_t(counts), 20, 0.25).numpy(),
                                  np.asarray(jweighted.joint_label_means(counts, 20, 0.25)))
    assert weighted.joint_label_means(_t(counts), 20, 0.25)[0].item() == -1.0


# ---------------------------------------------------------------- buckets


def _records(n=12, lo=64, hi=97, seed=0, num_classes=3):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        x, y = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
        recs.append({"image": (rng.random((x, y, 3)) * 255).astype(np.float32),
                     "label": int(i % num_classes), "filename": f"im{i}"})
    return recs


@pytest.fixture(scope="module")
def bucketed():
    recs = _records()
    got = buckets.bucketize_images(recs, granularity=32)
    want = jbuckets.bucketize_images(recs, granularity=32)
    return recs, got, want


def test_bucketization_and_concat_order_equal_the_jax_packages(bucketed):
    recs, got, want = bucketed
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.bucket_shape == w.bucket_shape and len(g) == len(w)
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.dims, w.dims)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.filenames == w.filenames
    np.testing.assert_array_equal(buckets.bucket_labels(got), jbuckets.bucket_labels(want))
    split = buckets.bucketize_images(recs, granularity=32, max_rows=2, pad_mode="constant")
    split_want = jbuckets.bucketize_images(recs, granularity=32, max_rows=2, pad_mode="constant")
    assert [len(b) for b in split] == [len(b) for b in split_want]
    for g, w in zip(split, split_want):
        np.testing.assert_array_equal(g.images, w.images)
    bd = buckets.to_bucketed_dataset(got, device=CPU)
    assert isinstance(bd, BucketedDataset) and len(bd) == len(recs)
    ids = ConcatBuckets().apply_batch(
        bd.map_datasets(lambda b: ArrayDataset({"label": b.data["label"]}, b.num_examples)))
    np.testing.assert_array_equal(ids.data["label"].numpy(), buckets.bucket_labels(got))
    jbd = jbuckets.to_bucketed_dataset(want)
    jids = jbd.map_datasets(lambda b: JArrayDataset({"label": b.data["label"]}, b.num_examples)).concat()
    np.testing.assert_array_equal(np.asarray(jids.data["label"]), ids.data["label"].numpy())


def test_bucketize_dataset_and_the_imagenet_loader_match_the_jax_package(tmp_path):
    rng = np.random.default_rng(2)
    tar_path = tmp_path / "shard.tar"
    with tarfile.open(tar_path, "w") as tar:
        for i, (w, h) in enumerate([(48, 48), (50, 44), (72, 64), (60, 70)]):
            buf = io.BytesIO()
            PILImage.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(buf, format="JPEG")
            info = tarfile.TarInfo(f"n0{i % 2 + 1}/img{i}.jpg")
            info.size = len(buf.getvalue())
            tar.addfile(info, io.BytesIO(buf.getvalue()))
        info = tarfile.TarInfo("n09/orphan.jpg")  # no label: quarantined
        info.size = 3
        tar.addfile(info, io.BytesIO(b"abc"))
    labels = tmp_path / "labels.txt"
    labels.write_text("n01 0\nn02 1\n\n")
    assert imagenet_loader.read_label_map(str(labels)) == jimagenet_loader.read_label_map(str(labels))
    assert imagenet_loader.NUM_CLASSES == jimagenet_loader.NUM_CLASSES == 1000
    got = imagenet_loader.load_imagenet(str(tar_path), str(labels))
    want = jimagenet_loader.load_imagenet(str(tar_path), str(labels))
    assert got.quarantine["label_missing"] == want.quarantine["label_missing"] == 1
    gb, wb = buckets.bucketize_dataset(got), jbuckets.bucketize_dataset(want)
    assert [b.bucket_shape for b in gb] == [b.bucket_shape for b in wb]
    for g, w in zip(gb, wb):
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)


def test_bucketed_gather_matches_the_jax_package(bucketed):
    _, got, _ = bucketed
    rng = np.random.default_rng(5)
    sizes = [len(b) for b in got]
    a = [rng.normal(size=(s, 3)).astype(np.float32) for s in sizes]
    b = [rng.normal(size=(s, 2)).astype(np.float32) for s in sizes]
    out = GatherTransformer().batch_transform([
        BucketedDataset([ArrayDataset(t, device=CPU) for t in a]),
        BucketedDataset([ArrayDataset(t, device=CPU) for t in b]),
    ])
    jout = JGather().batch_transform([JBucketedDataset([JArrayDataset(t) for t in a]),
                                      JBucketedDataset([JArrayDataset(t) for t in b])])
    assert isinstance(out, BucketedDataset) and len(out.buckets) == len(jout.buckets)
    for g, w in zip(out.buckets, jout.buckets):
        assert len(g.data) == 2
        for gp, wp in zip(g.data, w.data):
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    misaligned = GatherTransformer().batch_transform([
        BucketedDataset([ArrayDataset(np.concatenate(a), device=CPU)]),
        BucketedDataset([ArrayDataset(t, device=CPU) for t in b]),
    ])
    assert len(misaligned) == sum(sizes) and not isinstance(misaligned, BucketedDataset)


# ------------------------------------------------------- masked descriptors


@pytest.fixture(scope="module")
def masked_sift(bucketed):
    _, got, want = bucketed
    ext = SIFTExtractor(scale_step=2)
    bd = buckets.to_bucketed_dataset(got, device=CPU)
    out = MaskedExtractor(ext).apply_batch(bd)
    jout = JMaskedExtractor(JSIFT(scale_step=2)).apply_batch(jbuckets.to_bucketed_dataset(want))
    return got, ext, bd, out, jout


def test_masked_sift_matches_the_jax_package_and_native_size_runs(masked_sift):
    got, ext, _, out, jout = masked_sift
    for bucket, ds, jds in zip(got, out.buckets, jout.buckets):
        desc, valid = ext.apply_arrays_masked(_t(bucket.images).float(), _t(bucket.dims))
        torch.testing.assert_close(ds.data["desc"], desc, rtol=0, atol=0)
        np.testing.assert_array_equal(ds.data["valid"].numpy(), valid.numpy())
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jds.data["valid"]))
        within, worst = _within_one(desc.numpy(), np.asarray(jds.data["desc"]))
        assert within >= WITHIN_ONE and worst <= 1.0
        gray = bucket.images[..., 0].astype(np.float32)
        for i, (xn, yn) in enumerate(bucket.dims):
            own = ext.apply_arrays(_t(gray[i : i + 1, :xn, :yn]))[0].numpy()
            mine = desc[i][valid[i]].numpy()
            assert mine.shape == own.shape
            within, worst = _within_one(mine, own)
            assert within >= WITHIN_ONE and worst <= 1.0


def test_masked_column_sampler_draws_the_jax_packages_rows(masked_sift):
    _, _, _, out, jout = masked_sift
    got = ColumnSampler(5, seed=3).apply_batch(out).data.numpy()
    # The JAX package's draw on the port's descriptors (the SIFT of the two
    # packages differs by quantization steps; the draw must not).
    port_as_jax = JBucketedDataset([
        JArrayDataset({"desc": jnp.asarray(b.data["desc"].numpy()), "valid": jnp.asarray(b.data["valid"].numpy())})
        for b in out.buckets])
    want = np.asarray(JColumnSampler(5, seed=3).apply_batch(port_as_jax).data)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] <= 5 * sum(len(b) for b in out.buckets)
    assert (np.linalg.norm(got, axis=1) > 0).all()
    one = out.buckets[0]
    np.testing.assert_array_equal(ColumnSampler(1000, seed=9).apply_batch(one).data.numpy(),
                                  np.asarray(JColumnSampler(1000, seed=9).apply_batch(port_as_jax.buckets[0]).data))


def test_masked_pca_fisher_and_column_pca_pick_match_the_jax_package(masked_sift):
    _, _, _, out, _ = masked_sift
    rng = np.random.default_rng(6)
    comps = rng.normal(size=(128, 6)).astype(np.float32)
    projected = BatchPCATransformer(comps, device=CPU).apply_batch(out)
    jprojected = JBatchPCA(comps).apply_batch(JBucketedDataset([
        JArrayDataset({"desc": jnp.asarray(b.data["desc"].numpy()), "valid": jnp.asarray(b.data["valid"].numpy())})
        for b in out.buckets]))
    params = dict(means=rng.normal(size=(6, 3)).astype(np.float32) * 50,
                  variances=(500 + 500 * rng.random((6, 3))).astype(np.float32),
                  weights=np.array([0.2, 0.3, 0.5], np.float32))
    fv = FisherVector(GaussianMixtureModel(**params, device=CPU)).apply_batch(projected)
    jfv = JFisherVector(JGMM(**params)).apply_batch(jprojected)
    for p, jp, f, jf in zip(projected.buckets, jprojected.buckets, fv.buckets, jfv.buckets):
        np.testing.assert_array_equal(p.data["valid"].numpy(), np.asarray(jp.data["valid"]))
        assert _rel(p.data["desc"].numpy(), np.asarray(jp.data["desc"])) <= 1e-5
        assert f.data.shape == (len(p), 6, 6)
        assert _rel(f.data.numpy(), np.asarray(jf.data)) <= 1e-5
        # Each image's masked encoding equals the plain encoding of its valid rows.
        fvm = FisherVector(GaussianMixtureModel(**params, device=CPU))
        for i in range(len(p)):
            rows = p.data["desc"][i][p.data["valid"][i]][None]
            assert _rel(f.data[i].numpy(), fvm.apply_arrays(rows)[0].numpy()) <= 1e-5
    stats = DataStats(n_total=sum(len(b) for b in out.buckets), num_shards=len(out.buckets),
                      n_per_shard=[len(b) for b in out.buckets])
    pick = ColumnPCAEstimator(6, num_machines=8).optimize([out], stats)
    assert type(pick).__name__ in ("LocalColumnPCAEstimator", "DistributedColumnPCAEstimator")


def test_masked_extractor_pipeline_saves_and_loads(tmp_path, masked_sift):
    _, _, bd, _, _ = masked_sift
    op = MaskedExtractor(LCSExtractor(stride=8), pre=imagenet.ApplyArrays(), post=None)
    first = op.apply_batch(bd)
    again = pickle.loads(pickle.dumps(op)).apply_batch(bd)
    for a, b in zip(first.buckets, again.buckets):
        torch.testing.assert_close(a.data["desc"], b.data["desc"], rtol=0, atol=0)
    single = op.apply({"image": bd.buckets[0].data["image"][0], "dims": bd.buckets[0].data["dims"][0]})
    torch.testing.assert_close(single["desc"], first.buckets[0].data["desc"][0], rtol=0, atol=0)
    with pytest.raises(TypeError, match="bucket data"):
        op.apply_batch(ArrayDataset(np.zeros((2, 64, 64, 3), np.float32), device=CPU))


# --------------------------------------------------------------- pipeline


def _class_jpeg(rng, mean_rgb, size=(72, 72)):
    base = rng.integers(0, 80, size=(size[1], size[0], 3))
    arr = np.clip(base + np.asarray(mean_rgb), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PILImage.fromarray(arr, "RGB").save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def _imagenet_fixture(tmp_path, colors=None, per_class=4):
    """``tests/pipelines/test_imagenet.py``'s tar: per class ``per_class``
    72×72 JPEGs of one colour plus noise."""
    rng = np.random.default_rng(0)
    colors = colors or {"n01": (180, 30, 30), "n02": (30, 30, 180)}
    tar_path = tmp_path / "train.tar"
    with tarfile.open(tar_path, "w") as tar:
        for cls, color in colors.items():
            for i in range(per_class):
                payload = _class_jpeg(rng, color)
                info = tarfile.TarInfo(f"{cls}/img{i}.jpg")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
    labels_path = tmp_path / "labels.txt"
    labels_path.write_text("".join(f"{cls} {i}\n" for i, cls in enumerate(colors)))
    return str(tar_path), str(labels_path)


FIXTURE_CONFIG = dict(desc_dim=8, vocab_size=2, num_pca_samples=400, num_gmm_samples=400,
                      num_classes=10, image_size=(64, 64), solver_block_size=32, lcs_border=16,
                      reg=1e-3)


def _jax_flagship(config):
    parsed = jimagenet_loader.load_imagenet(config.train_location, config.label_path,
                                            resize=config.image_size).to_arrays()
    images = JArrayDataset(parsed.data["image"].astype(np.float32), parsed.num_examples)
    labels = JClassLabelIndicators(config.num_classes).apply_batch(
        JArrayDataset(parsed.data["label"], parsed.num_examples))
    return jimagenet.build_pipeline(config, images, labels), images, np.asarray(parsed.data["label"])


def test_flagship_end_to_end_matches_the_jax_pipeline(tmp_path):
    tar_path, labels_path = _imagenet_fixture(tmp_path)
    kw = dict(train_location=tar_path, test_location=tar_path, label_path=labels_path, **FIXTURE_CONFIG)
    predictor, images, labels = _jax_flagship(jimagenet.ImageNetSiftLcsFVConfig(**kw))
    want = np.asarray(predictor(images).get().data)
    got = imagenet.run(imagenet.ImageNetSiftLcsFVConfig(**kw), device=CPU)
    np.testing.assert_array_equal(got["test_predictions"], want)
    assert got["test_error_percent"] == jimagenet.top_k_err_percent(want, labels) <= 50.0
    assert imagenet.top_k_err_percent(np.array([[0, 1], [2, 3], [4, 5]]), np.array([1, 0, 4])) \
        == pytest.approx(100.0 / 3.0)

    fitted = got["pipeline"]
    assert isinstance(fitted, FittedPipeline)
    test = ArrayDataset(np.asarray(images.data), device=CPU)
    scores_path = tmp_path / "imagenet.pt"
    fitted.save(str(scores_path))
    again = FittedPipeline.load(str(scores_path), device="cpu").apply_batch(test).data
    np.testing.assert_array_equal(again.numpy(), want)


def _members(fitted, cls):
    ops = fitted.graph.operators.values()
    return [m for op in ops for m in getattr(op, "members", (op,)) if isinstance(m, cls)]


def test_jax_fitted_flagship_carried_into_the_port_scores_alike(tmp_path):
    from keystone_tpu.ops.util.labels import TopKClassifier as JTopK
    from keystone_tpu.workflow.pipeline import FittedPipeline as JFittedPipeline
    from keystone_tpu.workflow.pipeline import BatchTransformer as JBatchTransformer

    # Every one of the 10 classes present, so no class's score ties the
    # absent classes' constant −1 in the top 5.
    colors = {f"n{c:02d}": (25 * c, 255 - 25 * c, (97 * c) % 256) for c in range(10)}
    tar_path, labels_path = _imagenet_fixture(tmp_path, colors=colors, per_class=2)
    config = jimagenet.ImageNetSiftLcsFVConfig(train_location=tar_path, label_path=labels_path,
                                               **FIXTURE_CONFIG)
    predictor, images, _ = _jax_flagship(config)
    jfitted = predictor.fit()
    graph = jfitted.graph
    # Each branch's (PCA, Fisher encoder): the encoder's input is the PCA.
    branches = []
    for node, op in graph.operators.items():
        for member in getattr(op, "members", (op,)):
            if isinstance(member, JFisherVector):
                pca = graph.get_operator(graph.get_dependencies(node)[0])
                branches.append({"pca_components": np.asarray(pca.components),
                                 "gmm_means": np.asarray(member.gmm.means),
                                 "gmm_variances": np.asarray(member.gmm.variances),
                                 "gmm_weights": np.asarray(member.gmm.weights)})
    sift_b, lcs_b = sorted(branches, key=lambda b: -b["pca_components"].shape[0])
    assert sift_b["pca_components"].shape[0] == 128 and lcs_b["pca_components"].shape[0] == 96
    (mapper,) = _members(jfitted, JBlockLinearMapper)
    kwargs = dict(weights=np.asarray(mapper.weights), block_size=mapper.block_size,
                  intercept=np.asarray(mapper.intercept),
                  feature_mean=None if mapper.feature_mean is None else np.asarray(mapper.feature_mean),
                  sift_scale_step=config.sift_scale_step, lcs_stride=config.lcs_stride,
                  lcs_border=config.lcs_border, lcs_patch=config.lcs_patch, device=CPU)
    test = ArrayDataset(np.asarray(images.data), device=CPU)
    want = np.asarray(jfitted.apply_batch(images).data)
    got = convert.imagenet_pipeline_from_numpy(sift_b, lcs_b, **kwargs).apply_batch(test).data.numpy()
    # Scores: the JAX fitted graph with its top-k member dropped.
    (topk_node,) = [n for n, op in graph.operators.items()
                    if any(isinstance(m, JTopK) for m in getattr(op, "members", (op,)))]
    kept = [m for m in getattr(graph.get_operator(topk_node), "members", ()) if not isinstance(m, JTopK)]

    class ScoresOnly(JBatchTransformer):
        def apply_arrays(self, x):
            for member in kept:
                x = member.apply_arrays(x)
            return x

    jscores = JFittedPipeline(graph.set_operator(topk_node, ScoresOnly()), jfitted.source,
                              jfitted.sink).apply_batch(images).data
    scores = convert.imagenet_pipeline_from_numpy(sift_b, lcs_b, top_k=None, **kwargs).apply_batch(test).data
    assert scores.shape == (20, 10)
    jscores = np.asarray(jscores)
    assert _rel(scores.numpy(), jscores) <= 1e-3
    # The top 5 agree wherever the JAX scores' order through rank 6 is
    # not within the scores' agreement (1e-3 of the largest score).
    ranked = -np.sort(-jscores, axis=1)[:, :6]
    clear = (np.diff(-ranked, axis=1) > 1e-3 * np.abs(jscores).max()).all(axis=1)
    assert clear.sum() >= 10
    np.testing.assert_array_equal(got[clear], want[clear])


def test_native_resolution_run_matches_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)

    def jpeg(w, h):
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        PILImage.fromarray(arr).save(buf, format="JPEG", quality=95)
        return buf.getvalue()

    tar_path = tmp_path / "shard.tar"
    sizes = [(48, 48), (50, 44), (72, 64), (48, 48), (60, 70), (44, 50)]
    with tarfile.open(tar_path, "w") as tar:
        for i, (w, h) in enumerate(sizes):
            payload = jpeg(w, h)
            info = tarfile.TarInfo(f"{'n01' if i % 2 == 0 else 'n02'}/img{i}.jpg")
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    (tmp_path / "labels.txt").write_text("n01 0\nn02 1\n")
    kw = dict(train_location=str(tar_path), label_path=str(tmp_path / "labels.txt"), desc_dim=8,
              vocab_size=2, num_classes=2, num_pca_samples=2000, num_gmm_samples=2000,
              solver_block_size=64, image_size=None, lcs_stride=8)
    want = jimagenet.run_native_resolution(jimagenet.ImageNetSiftLcsFVConfig(**kw))
    got = imagenet.run_native_resolution(imagenet.ImageNetSiftLcsFVConfig(**kw), device=CPU)
    assert got["num_train"] == want["num_train"] == 6
    assert got["num_buckets"] == want["num_buckets"] >= 2
    assert got["train_error_percent"] == want["train_error_percent"]
    assert got["train_predictions"].shape == (6, 2)


def test_runs_need_their_inputs():
    for fn in (imagenet.run, imagenet.run_native_resolution):
        with pytest.raises(ValueError, match="--train-location"):
            fn(imagenet.ImageNetSiftLcsFVConfig(), device=CPU)


def test_cli_runs_both_imagenet_workloads(tmp_path):
    tar_path, labels_path = _imagenet_fixture(tmp_path)
    kw = dict(train_location=tar_path, test_location=tar_path, label_path=labels_path, **FIXTURE_CONFIG)
    want = imagenet.run(imagenet.ImageNetSiftLcsFVConfig(**kw), device=CPU)["test_error_percent"]
    flags = ["--train-location", tar_path, "--label-path", labels_path, "--desc-dim", "8",
             "--vocab-size", "2", "--num-pca-samples", "400", "--num-gmm-samples", "400",
             "--num-classes", "10", "--solver-block-size", "32", "--reg", "0.001", "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", "imagenet-sift-lcs-fv",
                          "--test-location", tar_path, "--image-size", "64x64",
                          "--use-native", "true", *flags],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["workload"] == "imagenet-sift-lcs-fv" and line["test_error_percent"] == want
    out = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", "imagenet-native",
                          "--lcs-stride", "8", *flags],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["workload"] == "imagenet-native" and line["num_train"] == 8


def _fp64_weighted_scores(x, labels, x_test, num_classes, mw, reg):
    """Test scores of the mixture-weighted solve (one block, one pass) by
    the dense per-class formula in float64 numpy."""
    x, x_test = x.astype(np.float64), x_test.astype(np.float64)
    n, d = x.shape
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    jlm = np.where(counts > 0, 2 * mw + 2 * (1 - mw) * counts / n - 1, -1.0)
    resid = -np.ones((n, num_classes)) - jlm
    resid[np.arange(n), labels] += 2.0
    pop_mean = x.mean(0)
    pop_cov = x.T @ x / n - np.outer(pop_mean, pop_mean)
    pop_xtr = x.T @ resid / n
    out = []
    for c in range(num_classes):
        win, r_c = x[labels == c], resid[labels == c, c]
        class_mean = win.mean(0)
        class_cov = win.T @ win / len(win) - np.outer(class_mean, class_mean)
        delta = class_mean - pop_mean
        joint_mean = mw * class_mean + (1 - mw) * pop_mean
        mean_mix = (1 - mw) * resid[:, c].mean() + mw * r_c.mean()
        rhs = (1 - mw) * pop_xtr[:, c] + mw * win.T @ r_c / len(win) - joint_mean * mean_mix
        lhs = (1 - mw) * pop_cov + mw * class_cov + mw * (1 - mw) * np.outer(delta, delta) + reg * np.eye(d)
        w = np.linalg.solve(lhs, rhs)
        out.append(x_test @ w + (jlm[c] - joint_mean @ w))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("shared", [0.0, 3.0, 10.0])
def test_woodbury_path_stays_solver_grade_when_class_rows_share_a_large_component(shared):
    """Unit rows = shared·μ + class centre + 0.1·noise, 20 classes of 60
    rows, λ = 6e-5, mixture weight 0.25, d = block = 512: the Woodbury
    path's held-out scores ≤ 2e-5 from a float64 solve, as the dense
    path's (read ≤ 3.0e-6 for both). The rank-(m+2) form with a negative
    μμᵀ term (the JAX package's) loses this accuracy as the shared
    component grows: the centred update is this port's repair (ROADMAP
    Queue C)."""
    rng = np.random.default_rng(0)
    d, classes, per = 512, 20, 60
    mu, centres = rng.normal(size=d), rng.normal(size=(classes, d))

    def rows(lab):
        x = shared * mu + centres[lab] + 0.1 * rng.normal(size=(len(lab), d))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    labels = np.repeat(np.arange(classes), per)
    x, x_test = rows(labels), rows(np.repeat(np.arange(classes), 5))
    y = -np.ones((len(labels), classes), np.float32)
    y[np.arange(len(labels)), labels] = 1.0
    want = _fp64_weighted_scores(x, labels, x_test, classes, 0.25, 6e-5)
    for path in ("woodbury", "dense"):
        est = weighted.BlockWeightedLeastSquaresEstimator(d, 1, 6e-5, 0.25, solve_path=path)
        model = est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
        assert est.last_solve_path == path
        assert _rel(model.apply_arrays(torch.from_numpy(x_test)).numpy(), want) <= 2e-5, path
