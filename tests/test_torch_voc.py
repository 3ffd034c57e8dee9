"""The VOC 2007 path in the port (``data/loaders/{archive,voc}.py``,
``utils/image.py::load_image``, ``ops/stats/core.py::ColumnSampler``,
``ops/util/vectors.py``'s ``Cast`` / ``FloatToDouble`` /
``MatrixVectorizer``, ``evaluation/mean_average_precision.py``,
``pipelines/voc.py``, ``convert.voc_pipeline_from_numpy`` and the CLI's
``voc-sift-fisher``) held to the JAX package on the CPU, and
``TopKClassifier``'s order among tied scores.

Bounds, each with the value read on the CPU: the sampler's rows, the
decoded and resized images, the label maps, quarantine counts, MAP and
top-k indices exactly equal; the JAX-fitted pipeline carried into the
port scores the test images ≤ 1e-4 relative from the JAX package (read
7.1e-6: SIFT entries one quantization step apart, and fp32 sums in
another order); the pipeline fitted in the port reaches the JAX
package's MAP ± 0.02 (read equal, 0.15 both, on noise images).
"""

import io
import json
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.data.loaders import archive as jarchive
from keystone_tpu.data.loaders import voc as jvocload
from keystone_tpu.evaluation.mean_average_precision import (
    MeanAveragePrecisionEvaluator as JMAP,
)
from keystone_tpu.ops.images.fisher import FisherVector as JFisherVector
from keystone_tpu.ops.learning.block import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.ops.learning.pca import BatchPCATransformer as JBatchPCATransformer
from keystone_tpu.ops.stats.core import ColumnSampler as JColumnSampler
from keystone_tpu.ops.util import labels as jlabels
from keystone_tpu.ops.util import vectors as jvectors
from keystone_tpu.pipelines import voc as jvoc
from keystone_tpu.utils.image import load_image as jload_image
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
from keystone_tpu_torch.data.loaders import archive as tarchive
from keystone_tpu_torch.data.loaders import voc as tvocload
from keystone_tpu_torch.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.ops.stats.core import ColumnSampler
from keystone_tpu_torch.ops.util import labels as tlabels
from keystone_tpu_torch.ops.util import vectors as tvectors
from keystone_tpu_torch.pipelines import voc as tvoc
from keystone_tpu_torch.reliability import FaultSpec, InjectedTransient, injected
from keystone_tpu_torch.reliability.faultinject import KNOWN_PROBE_SITES
from keystone_tpu_torch.reliability.recovery import get_recovery_log
from keystone_tpu_torch.utils.image import load_image
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

PIL = pytest.importorskip("PIL")
from PIL import Image as PILImage  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PREFIX = tvocload.DEFAULT_NAME_PREFIX


@pytest.fixture(autouse=True)
def _fresh_port_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _jpeg(rng, size=(72, 72), fmt="JPEG"):
    arr = rng.integers(0, 256, size=(size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    PILImage.fromarray(arr, "RGB").save(buf, format=fmt, quality=92)
    return buf.getvalue()


def _voc_fixture(tmp_path, n_images=6, extras=False):
    """``tests/pipelines/test_voc.py``'s tar and label CSV (noise JPEGs,
    classes 1 or 2+3 alternating); ``extras`` adds a corrupt entry, an
    entry without a label, a PNG of another size, and a file outside
    the prefix."""
    rng = np.random.default_rng(0)
    tar_path = tmp_path / "voc.tar"
    entries = [(PREFIX + f"{i:06d}.jpg", _jpeg(rng)) for i in range(n_images)]
    if extras:
        entries += [(PREFIX + "broken.jpg", b"not a jpeg"),
                    (PREFIX + "unlabeled.jpg", _jpeg(rng)),
                    (PREFIX + "wide.png", _jpeg(rng, size=(50, 30), fmt="PNG")),
                    ("VOCdevkit/VOC2007/Annotations/000000.xml", b"<x/>")]
    with tarfile.open(tar_path, "w") as tar:
        for name, payload in entries:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    rows = ["id,class,a,b,filename"]
    for i in range(n_images):
        if i % 2 == 0:
            rows.append(f'{i},1,x,y,"{i:06d}.jpg"')
        else:
            rows.append(f'{i},2,x,y,"{i:06d}.jpg"')
            rows.append(f'{i},3,x,y,"{i:06d}.jpg"')
    if extras:
        rows += ['90,4,x,y,"broken.jpg"', '91,5,x,y,"wide.png"', '92,5,x,y,"wide.png"']
    labels_path = tmp_path / "labels.csv"
    labels_path.write_text("\n".join(rows) + "\n")
    return str(tar_path), str(labels_path)


FIXTURE_CONFIG = dict(desc_dim=8, vocab_size=2, num_pca_samples=600, num_gmm_samples=600,
                      image_size=(64, 64), solver_block_size=16, reg=1e-2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------- TopK ties


TIED_ROWS = [
    (np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float32), 3),
    (np.zeros(10, np.float32), 4),
]


def _duplicated_row():
    row = np.random.default_rng(3).normal(size=12).astype(np.float32)
    row[[2, 7, 9]] = row[4]
    row[[0, 11]] = row.max()
    return row


@pytest.mark.parametrize("row,k", TIED_ROWS + [(_duplicated_row(), 6)])
def test_top_k_orders_ties_as_the_jax_package(row, k):
    want = np.asarray(jlabels.TopKClassifier(k).apply_arrays(jnp.asarray(row[None])))
    got = tlabels.TopKClassifier(k).apply_arrays(torch.from_numpy(row[None])).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- ColumnSampler


@pytest.mark.parametrize("chunk", [256, 3, 1])
def test_column_sampler_rows_equal_the_jax_packages(chunk):
    x = np.random.default_rng(4).normal(size=(7, 40, 5)).astype(np.float32)
    want = np.asarray(JColumnSampler(6, seed=9).apply_batch(JArrayDataset(x)).data)
    sampler = ColumnSampler(6, seed=9)
    sampler.chunk_items = chunk
    got = sampler.apply_batch(ArrayDataset(x, device=CPU)).data.numpy()
    np.testing.assert_array_equal(got, want)


def test_column_sampler_per_item_path_equals_the_jax_packages():
    rng = np.random.default_rng(5)
    mats = [rng.normal(size=(10 + i, 4)).astype(np.float32) for i in range(5)]
    want = np.asarray(JColumnSampler(3, seed=2).apply_batch(jvocload.ObjectDataset(mats)).data)
    got = ColumnSampler(3, seed=2).apply_batch(ObjectDataset([torch.from_numpy(m) for m in mats]))
    np.testing.assert_array_equal(got.data.numpy(), want)
    np.testing.assert_array_equal(ColumnSampler(3, seed=2).apply(mats[0]),
                                  JColumnSampler(3, seed=2).apply(mats[0]))


def test_vector_casts_and_vectorizer_equal_the_jax_packages():
    x = np.random.default_rng(6).normal(size=(3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tvectors.MatrixVectorizer().apply_arrays(torch.from_numpy(x)).numpy(),
        np.asarray(jvectors.MatrixVectorizer().apply_arrays(jnp.asarray(x))))
    assert tvectors.FloatToDouble().apply_arrays(torch.from_numpy(x).double()).dtype == torch.float32
    assert tvectors.FloatToDouble().label == jvectors.FloatToDouble().label == "Cast[float32]"
    assert tvectors.Cast("bfloat16").apply_arrays(torch.from_numpy(x)).dtype == torch.bfloat16


# ----------------------------------------------------------------- loaders


def test_loaders_equal_the_jax_packages_with_quarantine(tmp_path):
    from keystone_tpu import native as jnative

    assert jnative.load(auto_build=True) is not None  # its native decode, built where it is not
    tar_path, labels_path = _voc_fixture(tmp_path, extras=True)
    assert tvocload.read_voc_labels(labels_path) == jvocload.read_voc_labels(labels_path)
    label_map = jvocload.read_voc_labels(labels_path)

    def label_fn(name):
        return label_map[name.rsplit("/", 1)[-1]]

    for resize, use_native in ((None, False), ((40, 48), False), ((40, 48), None)):
        # The JAX loader's PIL path, and with a resize its native libjpeg
        # decode, which the port's loader takes by default then.
        want = jarchive.load_image_archives(tar_path, label_fn, name_prefix=PREFIX, resize=resize,
                                            num_workers=2, label_key="labels",
                                            use_native=resize is not None and use_native is None)
        got = tvocload.load_voc(tar_path, labels_path, resize=resize, num_workers=2,
                                use_native=use_native)
        # Decode threads finish in any order: the examples as a set.
        assert sorted(got.quarantine.pop("examples")) == sorted(want.quarantine.pop("examples"))
        assert got.quarantine == want.quarantine
        assert got.quarantine["label_missing"] == 1 and got.quarantine["decode_failed"] == 1
        w, g = want.collect(), got.collect()
        assert [r["filename"] for r in g] == [r["filename"] for r in w]
        assert [r["labels"] for r in g] == [r["labels"] for r in w]
        for a, b in zip(g, w):
            assert a["image"].dtype == b["image"].dtype
            np.testing.assert_array_equal(a["image"], b["image"])
    log = get_recovery_log().summary()
    assert log["quarantined_records"] >= 2


def test_load_image_equals_the_jax_packages():
    rng = np.random.default_rng(7)
    for fmt in ("JPEG", "PNG"):
        raw = _jpeg(rng, size=(31, 17), fmt=fmt)
        np.testing.assert_array_equal(load_image(raw), jload_image(raw))
        np.testing.assert_array_equal(load_image(raw, expected_channels=1),
                                      jload_image(raw, expected_channels=1))
    assert load_image(b"junk") is None


def test_native_decode_raises_naming_its_item(tmp_path, monkeypatch):
    """The native decode needs a resize target, and where its library
    cannot be built (no ``jpeglib.h``) it raises naming the header; PIL
    serves ``use_native=False``."""
    from keystone_tpu_torch import native

    tar_path, labels_path = _voc_fixture(tmp_path)
    with pytest.raises(ValueError, match="resize target"):
        tarchive.load_image_archives(tar_path, lambda name: 0, use_native=True)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "has_header", lambda header: False)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        tarchive.load_image_archives(tar_path, lambda name: 0, resize=(8, 8), use_native=True)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        tarchive.load_image_archives(tar_path, lambda name: 0, resize=(8, 8))
    assert len(tarchive.load_image_archives(tar_path, lambda name: 0, use_native=False)) == 6
    assert len(tarchive.load_image_archives(tar_path, lambda name: 0, resize=(8, 8), use_native=False)) == 6


def test_the_decode_probe_site_is_known_and_fires(tmp_path):
    assert "ingest.decode_batch" in KNOWN_PROBE_SITES
    tar_path, labels_path = _voc_fixture(tmp_path)
    with injected(FaultSpec(match="ingest.decode_batch", kind="transient", first_n=1)):
        with pytest.raises(InjectedTransient):
            tvocload.load_voc(tar_path, labels_path)


def test_mean_average_precision_equals_the_jax_packages():
    rng = np.random.default_rng(8)
    scores = np.round(rng.normal(size=(40, 5)), 1).astype(np.float32)  # rounded: ties
    labels = [sorted(set(rng.integers(0, 5, rng.integers(1, 3)).tolist())) for _ in range(40)]
    want = JMAP(5).evaluate(scores, labels)
    got = MeanAveragePrecisionEvaluator(5).evaluate(ArrayDataset(scores, device=CPU), labels)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(MeanAveragePrecisionEvaluator(5).evaluate(torch.from_numpy(scores), labels),
                                  want)


# ---------------------------------------------------------------- pipeline


def _jax_fitted_parts(config):
    """The JAX-fitted pipeline's PCA components, GMM and block mapper."""
    parsed = jvocload.load_voc(config.train_location, config.label_path, resize=config.image_size)
    images = jvoc.extract_images(parsed)
    labels = jlabels.MultiLabelIndicators(jvocload.NUM_CLASSES).apply_batch(jvoc.extract_multi_labels(parsed))
    fitted = jvoc.build_pipeline(config, images, labels).fit()

    def member(cls):
        ops = fitted.graph.operators.values()
        found = [m for op in ops for m in getattr(op, "members", (op,)) if isinstance(m, cls)]
        assert len(found) == 1
        return found[0]

    return fitted, member(JBatchPCATransformer), member(JFisherVector).gmm, member(JBlockLinearMapper)


def test_jax_fitted_pipeline_carried_into_the_port_scores_alike(tmp_path):
    tar_path, labels_path = _voc_fixture(tmp_path)
    config = jvoc.SIFTFisherConfig(train_location=tar_path, label_path=labels_path, **FIXTURE_CONFIG)
    jfitted, pca, gmm, mapper = _jax_fitted_parts(config)
    test = jvoc.extract_images(jvocload.load_voc(tar_path, labels_path, resize=config.image_size))
    want = np.asarray(jfitted.apply_batch(test).data)

    def host(a):
        return None if a is None else np.asarray(a)

    carried = convert.voc_pipeline_from_numpy(
        host(pca.components), host(gmm.means), host(gmm.variances), host(gmm.weights),
        host(mapper.weights), mapper.block_size, host(mapper.intercept), host(mapper.feature_mean),
        scale_step=config.scale_step, device=CPU,
    )
    got = carried.apply_batch(ArrayDataset(np.asarray(test.data), device=CPU)).data.numpy()
    assert got.shape == want.shape == (6, 20)
    assert _rel(got, want) <= 1e-4


def test_run_reaches_the_jax_packages_map_and_round_trips(tmp_path):
    tar_path, labels_path = _voc_fixture(tmp_path)
    kw = dict(train_location=tar_path, test_location=tar_path, label_path=labels_path, **FIXTURE_CONFIG)
    want = jvoc.run(jvoc.SIFTFisherConfig(**kw))
    got = tvoc.run(tvoc.SIFTFisherConfig(**kw), device=CPU)
    assert got["per_class_ap"].shape == (20,)
    assert abs(got["test_map"] - want["test_map"]) <= 0.02

    fitted = got["pipeline"]
    assert isinstance(fitted, FittedPipeline)
    test = ArrayDataset(tvoc.extract_images(tvocload.load_voc(tar_path, labels_path, resize=(64, 64)),
                                            device=CPU).data, device=CPU)
    scores = fitted.apply_batch(test).data
    path = tmp_path / "voc.pt"
    fitted.save(str(path))
    again = FittedPipeline.load(str(path), device="cpu").apply_batch(test).data
    torch.testing.assert_close(again, scores, rtol=0, atol=0)


def test_run_needs_its_inputs():
    with pytest.raises(ValueError, match="--train-location"):
        tvoc.run(tvoc.SIFTFisherConfig(), device=CPU)


def test_cli_runs_the_workload_with_the_jax_clis_flags(tmp_path):
    tar_path, labels_path = _voc_fixture(tmp_path)
    kw = dict(train_location=tar_path, test_location=tar_path, label_path=labels_path, **FIXTURE_CONFIG)
    want = tvoc.run(tvoc.SIFTFisherConfig(**kw), device=CPU)["test_map"]
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "voc-sift-fisher",
           "--train-location", tar_path, "--test-location", tar_path, "--label-path", labels_path,
           "--desc-dim", "8", "--vocab-size", "2", "--num-pca-samples", "600",
           "--num-gmm-samples", "600", "--image-size", "64x64", "--solver-block-size", "16",
           "--reg", "0.01", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["workload"] == "voc-sift-fisher"
    assert line["test_map"] == want
