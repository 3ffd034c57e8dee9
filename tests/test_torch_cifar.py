"""The CIFAR-10 path in the port (``keystone_tpu_torch/pipelines/cifar.py``,
``data/loaders/cifar.py``, ``ops/util/labels.py``'s remainder,
``evaluation/augmented.py`` and the CLI's ``cifar-*`` workloads) on the
CPU, held to the JAX package's on the same seeded synthetic CIFAR
(``tests/pipelines/test_cifar.py``'s prototype images).

Bounds, each with the value measured on the CPU: the decoder, the patch
sampling, the label encoders and the evaluators exactly equal; the
learned filters and whitener ≤ 1e-5 relative (read 2.8e-6 and 1.3e-6);
pipeline scores ≤ 1e-5 for every solver (``block``, ``kernel``,
``conv_block``, ``linear`` with learned and with random filters) and for
``build_linear_pixels`` (read ≤ 4.5e-6), with equal predicted labels;
``run_augmented`` through a written binary: the same test error.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu import cli as jcli
from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.data.dataset import ObjectDataset as JObjectDataset
from keystone_tpu.data.loaders import cifar as jloader
from keystone_tpu.evaluation.augmented import AugmentedExamplesEvaluator as JAugmented
from keystone_tpu.ops.util import labels as jlabels
from keystone_tpu.pipelines import cifar as jcifar
from keystone_tpu_torch import cli as tcli
from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
from keystone_tpu_torch.data.loaders import cifar as tloader
from keystone_tpu_torch.evaluation.augmented import AugmentedExamplesEvaluator
from keystone_tpu_torch.ops.util import labels as tlabels
from keystone_tpu_torch.pipelines import cifar as tcifar
from keystone_tpu_torch.workflow.executor import PipelineEnv

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_synthetic_cifar(n, seed=0):
    """Class-dependent mean images + noise (``tests/pipelines/test_cifar.py``)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    protos = rng.normal(size=(10, 32, 32, 3)) * 40 + 128
    images = protos[labels] + rng.normal(size=(n, 32, 32, 3)) * 10
    return np.clip(images, 0, 255).astype(np.float32), labels


def write_cifar_binary(path, images, labels):
    """CIFAR-10 binary records: label byte, then R, G, B planes."""
    planes = images.astype(np.uint8).transpose(0, 3, 1, 2).reshape(len(labels), -1)
    np.concatenate([labels.astype(np.uint8)[:, None], planes], axis=1).tofile(path)


def _both(images, labels):
    return (JArrayDataset({"image": images, "label": labels}),
            ArrayDataset({"image": images, "label": labels}, device=CPU))


# ----------------------------------------------------------------- loader


def test_cifar_binary_decode_layout_and_equality(tmp_path):
    rec = np.zeros(1 + 3072, dtype=np.uint8)
    rec[0] = 7
    rec[1:1025], rec[1025:2049], rec[2049:] = 1, 2, 3
    rec[1 + 1 * 32 + 2] = 9
    img = tloader.decode_cifar_bytes(rec.tobytes(), device=CPU).data["image"][0].numpy()
    assert img[0, 0].tolist() == [1, 2, 3] and img[1, 2, 0] == 9
    raw = np.random.default_rng(0).integers(0, 256, size=5 * 3073 + 11, dtype=np.uint8)
    for max_images in (None, 3):
        want = jloader.decode_cifar_bytes(raw.tobytes(), max_images)
        got = tloader.decode_cifar_bytes(raw, max_images, device=CPU)
        for key in ("image", "label"):
            np.testing.assert_array_equal(got.data[key].numpy(), np.asarray(want.data[key]))
    path = tmp_path / "c.bin"
    raw.tofile(path)
    loaded = tloader.load_cifar(str(path), device=CPU)
    assert len(loaded) == 5 and loaded.data["image"].dtype == torch.float32
    np.testing.assert_array_equal(loaded.data["image"].numpy(),
                                  np.asarray(jloader.load_cifar(str(path)).data["image"]))


# ---------------------------------------------------- labels and evaluators


def test_multi_label_indicators_and_top_k_equal_the_jax_package():
    lists = [[0, 3], [2], [1, 2, 4]]
    want = np.asarray(jlabels.MultiLabelIndicators(5).apply_batch(JObjectDataset(lists)).data)
    got = tlabels.MultiLabelIndicators(5, device=CPU).apply_batch(ObjectDataset(lists))
    np.testing.assert_array_equal(got.data.numpy(), want)
    np.testing.assert_array_equal(tlabels.MultiLabelIndicators(5).apply([4]),
                                  jlabels.MultiLabelIndicators(5).apply([4]))
    scores = np.random.default_rng(1).normal(size=(6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tlabels.TopKClassifier(3).apply_arrays(torch.from_numpy(scores)).numpy(),
        np.asarray(jlabels.TopKClassifier(3).apply_arrays(jnp.asarray(scores))),
    )


@pytest.mark.parametrize("policy", ["average", "borda"])
def test_augmented_evaluator_equals_the_jax_package(policy):
    rng = np.random.default_rng(2)
    names = np.repeat(np.arange(30), 4)
    labels = np.repeat(rng.integers(0, 5, 30), 4)
    scores = rng.normal(size=(120, 5)).astype(np.float32) + 1.5 * np.eye(5)[labels]
    want = JAugmented(names, 5, policy).evaluate(scores, labels)
    got = AugmentedExamplesEvaluator(names, 5, policy).evaluate(
        ArrayDataset(scores, device=CPU), torch.from_numpy(labels))
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    with pytest.raises(ValueError, match="conflicting"):
        AugmentedExamplesEvaluator(names, 5, policy).evaluate(scores, np.roll(labels, 1))
    with pytest.raises(ValueError, match="policy"):
        AugmentedExamplesEvaluator(names, 5, "vote")


# ---------------------------------------------------------------- pipelines


def _config(solver, **kw):
    args = dict(num_filters=32, patch_steps=4, reg=1.0 if solver != "kernel" else 1e-4,
                kernel_block_size=64, gamma=1e-3)
    args.update(kw)
    return jcifar.RandomCifarConfig(**args), tcifar.RandomCifarConfig(**args)


def test_learn_random_patch_filters_matches_jax():
    images, _ = make_synthetic_cifar(192, seed=1)
    jconf, tconf = _config("block")
    jf, jw = jcifar.learn_random_patch_filters(JArrayDataset(images), jconf, whitener_size=2000)
    tf, tw = tcifar.learn_random_patch_filters(ArrayDataset(images, device=CPU), tconf,
                                               whitener_size=2000, device=CPU)
    assert tf.shape == (32, 108) and tf.dtype == np.float32
    assert _rel(tf, np.asarray(jf)) <= TOL
    assert _rel(tw.whitener.numpy(), np.asarray(jw.whitener)) <= TOL
    assert _rel(tw.means.numpy(), np.asarray(jw.means)) <= TOL
    # The sampler keeps the JAX package's rows: a subsampled image set
    # (want_images < n) windows and samples the same patches.
    many, _ = make_synthetic_cifar(40, seed=3)
    jconf2, tconf2 = _config("block", patch_steps=1)
    jf2, _ = jcifar.learn_random_patch_filters(JArrayDataset(many), jconf2, whitener_size=3000)
    tf2, _ = tcifar.learn_random_patch_filters(ArrayDataset(many, device=CPU), tconf2,
                                               whitener_size=3000, device=CPU)
    assert _rel(tf2, np.asarray(jf2)) <= TOL
    x = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(tcifar.normalize_rows(x, 10.0), jcifar.normalize_rows(x, 10.0))


@pytest.mark.parametrize("solver", ["block", "kernel", "conv_block", "linear", "random"])
def test_build_random_patch_scores_match_jax(solver):
    """``random``: RandomCifar's Gaussian filters (no whitener) and the
    linear solver; the others on learned filters and whitener."""
    images, labels = make_synthetic_cifar(192, seed=1)
    jtrain, ttrain = _both(images, labels)
    jconf, tconf = _config(solver)
    if solver == "random":
        jp = jcifar.build_random_patch(jtrain, jconf, solver="linear", with_classifier=False)
        tp = tcifar.build_random_patch(ttrain, tconf, solver="linear", with_classifier=False, device=CPU)
    else:
        jf, jw = jcifar.learn_random_patch_filters(JArrayDataset(images), jconf, whitener_size=2000)
        tf, tw = tcifar.learn_random_patch_filters(ArrayDataset(images, device=CPU), tconf,
                                                   whitener_size=2000, device=CPU)
        jp = jcifar.build_random_patch(jtrain, jconf, jf, jw, solver=solver, with_classifier=False)
        tp = tcifar.build_random_patch(ttrain, tconf, tf, tw, solver=solver, with_classifier=False,
                                       device=CPU)
    want = np.asarray(jp(JArrayDataset(images)).get().data)
    got = tp(ArrayDataset(images, device=CPU)).get().data.numpy()
    assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert (got.argmax(1) != labels).mean() < 0.2


def test_build_linear_pixels_matches_jax():
    images, labels = make_synthetic_cifar(1536)
    jtrain, ttrain = _both(images, labels)
    jp = jcifar.build_linear_pixels(jtrain)
    tp = tcifar.build_linear_pixels(ttrain, device=CPU)
    want = np.asarray(jp(JArrayDataset(images)).get().data)
    got = tp(ArrayDataset(images, device=CPU)).get().data.numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != labels).mean() < 0.15
    with pytest.raises(ValueError, match="unknown solver"):
        tcifar.build_random_patch(ttrain, tcifar.RandomCifarConfig(num_filters=2), solver="svm",
                                  device=CPU)


@pytest.mark.parametrize("variant", ["random_patch_augmented", "random_patch_kernel_augmented"])
def test_run_augmented_through_a_written_binary_matches_jax(tmp_path, variant):
    images, labels = make_synthetic_cifar(96, seed=2)
    path = tmp_path / "cifar_train.bin"
    write_cifar_binary(str(path), images, labels)
    kw = dict(train_location=str(path), test_location=str(path), num_filters=24, patch_steps=4,
              reg=1.0, num_random_images_augment=3, seed=3, gamma=1e-3, kernel_block_size=64)
    want = jcifar.run(jcifar.RandomCifarConfig(**kw), variant=variant)
    got = tcifar.run(tcifar.RandomCifarConfig(**kw), variant=variant, device=CPU)
    assert got["num_augmented_train"] == want["num_augmented_train"] == 96 * 3
    assert got["test_error"] == want["test_error"]
    assert got["test_error"] < 0.5


def test_run_needs_a_train_location_and_a_known_variant(tmp_path):
    with pytest.raises(ValueError, match="train-location"):
        tcifar.run(tcifar.RandomCifarConfig(), device=CPU)
    images, labels = make_synthetic_cifar(8)
    write_cifar_binary(str(tmp_path / "t.bin"), images, labels)
    with pytest.raises(ValueError, match="unknown variant"):
        tcifar.run(tcifar.RandomCifarConfig(train_location=str(tmp_path / "t.bin")), "resnet", device=CPU)


# ---------------------------------------------------------------------- CLI


def test_cli_lists_the_seven_cifar_workloads_of_the_jax_cli():
    want = sorted(n for n in jcli.WORKLOADS if n.startswith("cifar-"))
    assert len(want) == 7
    assert sorted(n for n in tcli.WORKLOADS if n.startswith("cifar-")) == want
    for name in want:
        assert tcli.WORKLOADS[name][:4] == jcli.WORKLOADS[name][:4]
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "--list"], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    assert set(want) <= {line.split()[0] for line in out.splitlines() if line.strip()}


def test_cli_runs_a_cifar_workload_on_the_cpu(tmp_path):
    images, labels = make_synthetic_cifar(64, seed=4)
    path = tmp_path / "cifar.bin"
    write_cifar_binary(str(path), images, labels)
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "cifar-random-patch-fused",
         "--train-location", str(path), "--test-location", str(path), "--num-filters", "16",
         "--patch-steps", "4", "--reg", "1.0", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result["workload"] == "cifar-random-patch-fused"
    assert result["train_error"] < 0.2 and result["test_error"] == result["train_error"]
