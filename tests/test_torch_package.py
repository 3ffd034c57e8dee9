"""Guards on the port package: it imports neither JAX nor the JAX
package, it never runs on the CPU unless asked, and a CUDA tensor never
falls back to the plain version."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import keystone_tpu_torch
from keystone_tpu_torch.ops.cuda import _build
from keystone_tpu_torch.ops.cuda import blocksparse as tbs

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_nothing_of_keystone_tpu():
    script = """
import importlib, json, pkgutil, sys
import keystone_tpu_torch
names = [m.name for m in pkgutil.walk_packages(keystone_tpu_torch.__path__, "keystone_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "keystone_tpu" or m.startswith("keystone_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    expected = {
        "keystone_tpu_torch.envknobs",
        "keystone_tpu_torch.device",
        "keystone_tpu_torch.convert",
        "keystone_tpu_torch.utils.sparse",
        "keystone_tpu_torch.data.dataset",
        "keystone_tpu_torch.workflow.pipeline",
        "keystone_tpu_torch.ops.nlp.text",
        "keystone_tpu_torch.ops.util.vectors",
        "keystone_tpu_torch.ops.util.labels",
        "keystone_tpu_torch.ops.cuda._build",
        "keystone_tpu_torch.ops.cuda.blocksparse",
        "keystone_tpu_torch.parallel.linalg",
        "keystone_tpu_torch.ops.learning.block",
        "keystone_tpu_torch.evaluation.multiclass",
        "keystone_tpu_torch.utils.tree",
        "keystone_tpu_torch.workflow.graph",
        "keystone_tpu_torch.workflow.analysis",
        "keystone_tpu_torch.workflow.prefix",
        "keystone_tpu_torch.workflow.operators",
        "keystone_tpu_torch.workflow.tracing",
        "keystone_tpu_torch.workflow.rules",
        "keystone_tpu_torch.workflow.optimize",
        "keystone_tpu_torch.workflow.executor",
        "keystone_tpu_torch.ops.util.misc",
        "keystone_tpu_torch.ops.util.gather",
        "keystone_tpu_torch.ops.stats.core",
        "keystone_tpu_torch.data.loaders.csv",
        "keystone_tpu_torch.pipelines.mnist_random_fft",
        "keystone_tpu_torch.cli",
        "keystone_tpu_torch.__main__",
        "keystone_tpu_torch.reliability",
        "keystone_tpu_torch.reliability.errors",
        "keystone_tpu_torch.reliability.recovery",
        "keystone_tpu_torch.reliability.retry",
        "keystone_tpu_torch.reliability.degrade",
        "keystone_tpu_torch.reliability.faultinject",
        "keystone_tpu_torch.obs",
        "keystone_tpu_torch.obs.metrics",
        "keystone_tpu_torch.obs.names",
        "keystone_tpu_torch.obs.spans",
        "keystone_tpu_torch.utils.aot",
        "keystone_tpu_torch.serving",
        "keystone_tpu_torch.serving.config",
        "keystone_tpu_torch.serving.batcher",
        "keystone_tpu_torch.serving.admission",
        "keystone_tpu_torch.serving.telemetry",
        "keystone_tpu_torch.serving.registry",
        "keystone_tpu_torch.serving.synthetic",
        "keystone_tpu_torch.serving.server",
        "keystone_tpu_torch.data.ingest",
        "keystone_tpu_torch.workflow.fusion",
        "keystone_tpu_torch.workflow.streaming",
        "keystone_tpu_torch.ops.learning.linear",
        "keystone_tpu_torch.ops.cuda.gemm",
        "keystone_tpu_torch.data.loaders.timit",
        "keystone_tpu_torch.pipelines.timit",
        "keystone_tpu_torch.obs.cost",
        "keystone_tpu_torch.ops.learning.cost",
        "keystone_tpu_torch.ops.learning.lbfgs",
        "keystone_tpu_torch.ops.learning.least_squares",
        "keystone_tpu_torch.ops.learning.logistic",
        "keystone_tpu_torch.ops.learning.naive_bayes",
        "keystone_tpu_torch.ops.util.sparse",
        "keystone_tpu_torch.data.loaders.text",
        "keystone_tpu_torch.evaluation.binary",
        "keystone_tpu_torch.pipelines.text",
        "keystone_tpu_torch.refit",
        "keystone_tpu_torch.refit.state",
        "keystone_tpu_torch.sketch",
        "keystone_tpu_torch.sketch.core",
        "keystone_tpu_torch.sketch.solvers",
        "keystone_tpu_torch.ops.learning.kernel",
        "keystone_tpu_torch.utils.image",
        "keystone_tpu_torch.ops.images",
        "keystone_tpu_torch.ops.images.core",
        "keystone_tpu_torch.ops.learning.zca",
        "keystone_tpu_torch.ops.learning.conv_block",
        "keystone_tpu_torch.data.loaders.cifar",
        "keystone_tpu_torch.evaluation.augmented",
        "keystone_tpu_torch.pipelines.cifar",
        "keystone_tpu_torch.ops.images.sift",
        "keystone_tpu_torch.ops.images.fisher",
        "keystone_tpu_torch.ops.images.daisy",
        "keystone_tpu_torch.ops.images.hog",
        "keystone_tpu_torch.ops.learning.kmeans",
        "keystone_tpu_torch.ops.learning.gmm",
        "keystone_tpu_torch.ops.learning.pca",
        "keystone_tpu_torch.data.loaders.archive",
        "keystone_tpu_torch.data.loaders.voc",
        "keystone_tpu_torch.evaluation.mean_average_precision",
        "keystone_tpu_torch.pipelines.voc",
        "keystone_tpu_torch.native",
        "keystone_tpu_torch.ops.images.external",
        "keystone_tpu_torch.ops.images.external.sift",
        "keystone_tpu_torch.ops.images.external.fisher",
        "keystone_tpu_torch.ops.images.lcs",
        "keystone_tpu_torch.ops.images.native",
        "keystone_tpu_torch.ops.learning.weighted",
        "keystone_tpu_torch.data.buckets",
        "keystone_tpu_torch.data.loaders.imagenet",
        "keystone_tpu_torch.pipelines.imagenet",
        "keystone_tpu_torch.ops.stats.jax_random",
        "keystone_tpu_torch.pipelines.imagenet_streaming",
        "keystone_tpu_torch.ops.nlp",
        "keystone_tpu_torch.ops.nlp.indexers",
        "keystone_tpu_torch.ops.nlp.stupid_backoff",
        "keystone_tpu_torch.ops.nlp.corenlp",
        "keystone_tpu_torch.ops.learning.lda",
        "keystone_tpu_torch.pipelines.stupid_backoff",
    }
    assert expected <= set(result["imported"])


def test_kernel_sources_ship_in_the_package():
    for name in ("ell_matmul", "solver_gemm"):
        assert (Path(keystone_tpu_torch.__file__).parent / f"ops/cuda/csrc/{name}.cu").is_file()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert _build.LINK_FLAGS["solver_gemm"] == ("-lcublas",)


@pytest.mark.parametrize(
    "setup",
    [
        "pass",
        "torch.set_float32_matmul_precision('high')",
        "torch.set_float32_matmul_precision('medium')",
        "torch.backends.cuda.matmul.allow_tf32 = True; torch.backends.cudnn.allow_tf32 = False",
    ],
)
def test_importing_the_port_changes_no_global_precision_flag(setup):
    """``import keystone_tpu_torch`` and its solvers leave PyTorch's
    process-wide TF32 flags and matmul precision as they found them."""
    script = f"""
import json, torch
{setup}
def flags():
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError as exc:  # legacy and new APIs mixed
        precision = str(exc)[:60]
    return [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, precision]
seen = flags()
import keystone_tpu_torch
import keystone_tpu_torch.parallel.linalg
import keystone_tpu_torch.ops.learning.linear
import keystone_tpu_torch.pipelines.timit
import keystone_tpu_torch.pipelines.cifar
print(json.dumps([seen, flags()]))
"""
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    seen, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert after == seen
    assert seen[0] == ("high" in setup or "= True" in setup or "medium" in setup)


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
    from keystone_tpu_torch.device import resolve_device
    from keystone_tpu_torch.convert import mapper_from_numpy
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util.vectors import Densify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArrayDataset(np.zeros((3, 2), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Densify().apply_batch(ObjectDataset([np.zeros(2), np.ones(2)]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mapper_from_numpy(np.zeros((2, 2)), 2)
    y = ArrayDataset(np.ones((4, 2), np.float32), device="cpu")
    x = ArrayDataset(np.eye(4, dtype=np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockLeastSquaresEstimator(2).fit(x, y)
    assert resolve_device("cpu") == torch.device("cpu")

    from keystone_tpu_torch.ops.stats.core import RandomSignNode
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig,
        run,
        synthetic_mnist,
    )
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    for entry_point in (
        lambda: synthetic_mnist(4),
        lambda: RandomSignNode.create(4),
        lambda: run(MnistRandomFFTConfig(num_ffts=1)),
        lambda: FittedPipeline.load("unused.pt"),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()


def test_stream_and_fusion_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.serving.synthetic import synthetic_chain_pipeline
    from keystone_tpu_torch.workflow.streaming import ChunkStream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = ArrayDataset(np.eye(4, dtype=np.float32), device="cpu")
    y = ArrayDataset(np.ones((4, 2), np.float32), device="cpu")
    for entry_point in (
        lambda: ChunkStream(x, y, ()),
        lambda: LinearMapEstimator(reg=1.0).fit(x, y),
        lambda: synthetic_chain_pipeline(num_nodes=2, d=4),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_with_kernel_library_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})

    def plain_must_not_run(*args):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(tbs, "ell_matmul_reference", plain_must_not_run)
    idx = torch.zeros(2, 3, dtype=torch.int32).as_subclass(_CudaLooking)
    blocks = torch.ones(2, 3, 4, 4).as_subclass(_CudaLooking)
    b = torch.ones(8, 5).as_subclass(_CudaLooking)
    before = tbs.ell_matmul.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tbs.ell_matmul(idx, blocks, b)
    assert tbs.ell_matmul.launches == before


def test_solver_products_on_cuda_tensors_never_fall_back(monkeypatch, tmp_path):
    """A CUDA tensor reaches the cuBLAS binding (here: its missing build)
    at every mode; neither the plain version nor ``torch.matmul`` runs."""
    from keystone_tpu_torch.ops.cuda import gemm as tgemm
    from keystone_tpu_torch.parallel import linalg

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("a CUDA tensor fell back to a plain product")

    for name in ("gemm_reference", "gemm_tn_chunked_reference"):
        monkeypatch.setattr(tgemm, name, plain_must_not_run)
    monkeypatch.setattr(torch, "matmul", plain_must_not_run)
    a = torch.ones(8, 4).as_subclass(_CudaLooking)
    b = torch.ones(8, 3).as_subclass(_CudaLooking)
    before = dict(tgemm.launches)
    for mode in ("highest", "high", "default", "refine"):
        with linalg.solver_mode_scope(mode):
            for call in (lambda: linalg.mm(a.T, b), lambda: linalg.mm_t(a, b)):
                with pytest.raises(RuntimeError, match="nvcc not found"):
                    call()
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        tgemm.gemm(a.half().T, b.half())
    assert tgemm.launches == before


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    idx = torch.zeros(1, 1, dtype=torch.int32).as_subclass(_CudaLooking)
    b = torch.ones(129, 5).as_subclass(_CudaLooking)
    with pytest.raises(ValueError, match="tiles 1..128"):
        tbs.ell_matmul(idx, torch.ones(1, 1, 4, 129).as_subclass(_CudaLooking), b)
    with pytest.raises(ValueError, match="contiguous"):
        tbs.ell_matmul(
            idx, torch.ones(1, 1, 8, 4).as_subclass(_CudaLooking),
            torch.ones(5, 8).t().as_subclass(_CudaLooking),
        )
    with pytest.raises(ValueError, match="one CUDA device"):
        tbs.ell_matmul(torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, 1, 4, 4), b[:8])


def test_least_squares_and_text_entry_points_without_device_raise_when_no_cuda(monkeypatch, tmp_path):
    from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
    from keystone_tpu_torch.ops.learning.cost import default_cost_weights
    from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSEstimator, SparseLBFGSEstimator
    from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.linear import LocalLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.logistic import LogisticRegressionEstimator
    from keystone_tpu_torch.ops.learning.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.pipelines import text

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = ArrayDataset(np.eye(4, dtype=np.float32), device="cpu")
    y = ArrayDataset(np.ones((4, 2), np.float32), device="cpu")
    labels = ArrayDataset(np.array([0, 1, 0, 1], np.int32), device="cpu")
    reviews = tmp_path / "r.json"
    reviews.write_text('{"reviewText": "good", "overall": 5}\n{"reviewText": "bad", "overall": 1}\n')
    for entry_point in (
        lambda: default_cost_weights(),
        lambda: DenseLBFGSEstimator(num_iterations=1).fit(x, y),
        lambda: SparseLBFGSEstimator(num_iterations=1).fit(ObjectDataset(list(np.eye(4))), y),
        lambda: LeastSquaresEstimator(num_machines=1).fit(x, y),
        lambda: LocalLeastSquaresEstimator().fit(x, y),
        lambda: LogisticRegressionEstimator(2, num_iterations=1).fit(x, labels),
        lambda: NaiveBayesEstimator(2).fit(x, labels),
        lambda: text.run_amazon(text.AmazonReviewsConfig(
            train_location=str(reviews), test_location=str(reviews), common_features=4)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()


def test_sketch_and_kernel_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    from keystone_tpu_torch.convert import kernel_mapper_from_numpy
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.kernel import GaussianKernelGenerator, KernelRidgeRegression
    from keystone_tpu_torch.refit.state import StreamState
    from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = ArrayDataset(np.eye(4, dtype=np.float32), device="cpu")
    y = ArrayDataset(np.ones((4, 2), np.float32), device="cpu")
    state = StreamState(kind="sketch", estimator="x", num_examples=4,
                        carry=(np.zeros((2, 4), np.float32), np.zeros((2, 2), np.float32),
                               np.zeros(2, np.float32), np.zeros(4, np.float32), np.zeros(2, np.float32)))
    for entry_point in (
        lambda: SketchedLeastSquaresEstimator(sketch_size=2).fit(x, y),
        lambda: SketchedLeastSquaresEstimator(sketch_size=2).finish_from_state(state),
        lambda: KernelRidgeRegression(GaussianKernelGenerator(1.0), 0.1, 2, 1).fit(x, y),
        lambda: GaussianKernelGenerator(1.0).fit(x),
        lambda: kernel_mapper_from_numpy(np.eye(4), np.ones((4, 2)), 1.0, 4, 2),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()


def test_image_entry_points_without_device_raise_when_no_cuda(monkeypatch, tmp_path):
    from keystone_tpu_torch.convert import conv_block_model_from_numpy, zca_whitener_from_numpy
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.data.loaders.cifar import decode_cifar_bytes, load_cifar
    from keystone_tpu_torch.ops.images import Convolver, FusedConvFeaturizer, Pooler, SymmetricRectifier
    from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.zca import ZCAWhitenerEstimator
    from keystone_tpu_torch.pipelines import cifar

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    record = np.zeros(3073, np.uint8)
    record.tofile(tmp_path / "c.bin")
    filters = np.ones((2, 108), np.float32)
    fz = FusedConvFeaturizer(Convolver(filters, 3, device="cpu"), SymmetricRectifier(),
                             Pooler(13, 14))
    images = ArrayDataset(np.zeros((2, 32, 32, 3), np.float32), device="cpu")
    y = ArrayDataset(np.ones((2, 2), np.float32), device="cpu")
    for entry_point in (
        lambda: Convolver(filters, 3),
        lambda: ZCAWhitenerEstimator().fit_single(np.eye(3, dtype=np.float32)),
        lambda: ConvBlockLeastSquaresEstimator(fz, block_size=16).fit(images, y),
        lambda: decode_cifar_bytes(record.tobytes()),
        lambda: load_cifar(str(tmp_path / "c.bin")),
        lambda: cifar.run(cifar.RandomCifarConfig(train_location=str(tmp_path / "c.bin"))),
        lambda: zca_whitener_from_numpy(np.eye(2), np.zeros(2)),
        lambda: conv_block_model_from_numpy(filters, np.zeros((16, 2)), np.zeros(16), np.zeros(2)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()


def test_voc_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    """The VOC path's entry points that place host arrays (the image
    stack, carried PCA and GMM parameters) resolve ``None`` to CUDA and
    raise without a card."""
    from keystone_tpu_torch.convert import gmm_from_numpy, pca_from_numpy
    from keystone_tpu_torch.data.dataset import ObjectDataset
    from keystone_tpu_torch.pipelines.voc import extract_images

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    records = ObjectDataset([{"image": np.zeros((4, 4, 3)), "labels": [0]}])
    for entry_point in (
        lambda: extract_images(records),
        lambda: pca_from_numpy(np.eye(3)),
        lambda: gmm_from_numpy(np.zeros((2, 3)), np.ones((2, 3)), np.full(3, 1 / 3)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()
    assert extract_images(records, device="cpu").data.shape == (1, 4, 4, 3)


def test_streaming_flagship_and_nlp_entry_points_without_device_raise_when_no_cuda(monkeypatch, tmp_path):
    """The streaming flagship's entry points, ``warm_flagship``, the carried
    codebooks, LDA's model and the Stupid Backoff workload resolve ``None``
    to CUDA and raise without a card."""
    from keystone_tpu_torch.convert import flagship_codebooks_from_numpy
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.lda import LinearDiscriminantAnalysis
    from keystone_tpu_torch.pipelines import imagenet_streaming, stupid_backoff
    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig
    from keystone_tpu_torch.utils.aot import warm_flagship

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = ArrayDataset(np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32), device="cpu")
    y = ArrayDataset(np.array([0, 1] * 4, np.int32), device="cpu")
    gmm = (np.zeros((2, 2)), np.ones((2, 2)), np.full(2, 0.5))
    config = ImageNetSiftLcsFVConfig(train_location=str(tmp_path / "t.tar"),
                                     label_path=str(tmp_path / "labels.txt"))
    for entry_point in (
        lambda: imagenet_streaming.StreamingFlagship(),
        lambda: imagenet_streaming.StreamingFlagship.load(str(tmp_path / "missing.pkl")),
        lambda: imagenet_streaming.run_flagship_ondevice(num_train=4, num_test=4),
        lambda: imagenet_streaming.run_native_resolution_streaming(config),
        lambda: warm_flagship(),
        lambda: flagship_codebooks_from_numpy(np.eye(2), np.eye(2), gmm, gmm),
        lambda: LinearDiscriminantAnalysis(1).fit(x, y),
        lambda: stupid_backoff.run(stupid_backoff.StupidBackoffConfig()),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()
