"""ImageNet SIFT + LCS + Fisher Vector workload — the flagship pipeline.

Port of ``keystone_tpu/pipelines/imagenet.py`` (reference:
pipelines/images/imagenet/ImageNetSiftLcsFV.scala:19-146): two
featurization branches merged with ``Pipeline.gather``, sample-driven
optimizable PCA, GMM Fisher encoding and the per-class mixture-weighted
block solver, with the JAX package's configuration, shapes and seeds.

Branch structure (reference lines in parens):
  SIFT branch: PixelScaler → GrayScaler → SIFT → SignedHellinger (:99-102)
  LCS branch:  LCSExtractor (:114-115)
  each → ColumnSampler → ColumnPCA → GMM FisherVector → FloatToDouble →
         MatrixVectorizer → NormalizeRows → SignedHellinger →
         NormalizeRows (:22-73 computePCAandFisherBranch)
  gather → VectorCombiner → BlockWeightedLeastSquares(4096, 1, λ, w) →
         TopKClassifier(5) (:127-136)

Two entry points: ``run`` resizes every image to ``image_size`` on the
host (one static shape, batched on the device); ``run_native_resolution``
keeps each image's own size, groups images into padded size buckets
(``data/buckets.py``) and featurizes them with the masked extractors
(``ops/images/native.py``) through the same Pipeline API.

Every entry point takes ``device=`` (default ``None``: the CUDA device).
``run`` fits the pipeline (``Pipeline.fit``) before it scores the test
set, so the fit's node outputs are freed before the test images are
featurized, and opens the spans ``imagenet:load``, ``imagenet:fit`` and
``imagenet:apply``; ``run_native_resolution`` opens
``imagenet_native:load``, ``:fit`` and ``:apply``.
``config.use_native`` picks the JPEG decode of ``run`` (see
:func:`~keystone_tpu_torch.data.loaders.archive.load_image_archives`).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.dataset import ArrayDataset, BucketedDataset, Dataset
from ..data.loaders import imagenet as imagenet_loader
from ..data.loaders.imagenet import load_imagenet
from ..device import DeviceLike
from ..obs import spans as _spans
from ..ops.images.core import GrayScaler, PixelScaler
from ..ops.images.fisher import FisherVector, GMMFisherVectorEstimator
from ..ops.images.lcs import LCSExtractor
from ..ops.images.native import MaskedExtractor
from ..ops.images.sift import SIFTExtractor
from ..ops.learning.gmm import GaussianMixtureModel
from ..ops.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from ..ops.learning.weighted import BlockWeightedLeastSquaresEstimator
from ..ops.stats.core import ColumnSampler, NormalizeRows, SignedHellingerMapper
from ..ops.util.labels import ClassLabelIndicators, TopKClassifier
from ..ops.util.vectors import FloatToDouble, MatrixVectorizer, VectorCombiner
from ..workflow.pipeline import Pipeline

logger = logging.getLogger(__name__)


@dataclass
class ImageNetSiftLcsFVConfig:
    """reference: ImageNetSiftLcsFV.scala:148-169."""

    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    reg: float = 6e-5  # lambda
    mixture_weight: float = 0.25
    desc_dim: int = 64
    vocab_size: int = 16
    sift_scale_step: int = 1
    lcs_stride: int = 4
    lcs_border: int = 16
    lcs_patch: int = 6
    sift_pca_file: Optional[str] = None
    sift_gmm_mean_file: Optional[str] = None
    sift_gmm_var_file: Optional[str] = None
    sift_gmm_wts_file: Optional[str] = None
    lcs_pca_file: Optional[str] = None
    lcs_gmm_mean_file: Optional[str] = None
    lcs_gmm_var_file: Optional[str] = None
    lcs_gmm_wts_file: Optional[str] = None
    num_pca_samples: int = int(1e7)
    num_gmm_samples: int = int(1e7)
    num_classes: int = imagenet_loader.NUM_CLASSES
    image_size: Optional[Tuple[int, int]] = (256, 256)
    solver_block_size: int = 4096
    seed: int = 42
    # Decode path of run(): None → the native libjpeg decode (a resize is
    # set), False → PIL (a machine without jpeglib.h), True → native.
    use_native: Optional[bool] = None


class ApplyArrays:
    """A picklable composition of operators' ``apply_arrays`` (the masked
    extractors' ``pre`` map), where the JAX package passes a lambda."""

    def __init__(self, *ops):
        self.ops = ops

    def __call__(self, x):
        for op in self.ops:
            x = op.apply_arrays(x)
        return x


def compute_pca_fisher_branch(
    prefix: Pipeline,
    train_images: Dataset,
    config: ImageNetSiftLcsFVConfig,
    pca_samples_per_image: int,
    gmm_samples_per_image: int,
    pca_file: Optional[str],
    gmm_files: Tuple[Optional[str], Optional[str], Optional[str]],
    device: DeviceLike = None,
) -> Pipeline:
    """PCA + FisherVector feature branch shared by SIFT and LCS
    (reference: ImageNetSiftLcsFV.scala:22-73 computePCAandFisherBranch)."""
    if pca_file is not None:
        pca_mat = np.loadtxt(pca_file, delimiter=",").astype(np.float32)
        pca_transformer = BatchPCATransformer(pca_mat.T, device=device).to_pipeline()
    else:
        samples = ColumnSampler(pca_samples_per_image, seed=config.seed)(prefix(train_images))
        pca_transformer = ColumnPCAEstimator(config.desc_dim).with_data(samples)

    mean_file, var_file, wts_file = gmm_files
    if mean_file is not None:
        gmm = GaussianMixtureModel.load(mean_file, var_file, wts_file, device=device)
        fisher_transformer = FisherVector(gmm).to_pipeline()
    else:
        sampler = ColumnSampler(gmm_samples_per_image, seed=config.seed)
        gmm_data = pca_transformer.apply(sampler(prefix(train_images)))
        fisher_transformer = GMMFisherVectorEstimator(
            config.vocab_size, seed=config.seed
        ).with_data(gmm_data)

    return (
        prefix.then(pca_transformer)
        .then(fisher_transformer)
        .then(FloatToDouble())
        .then(MatrixVectorizer())
        .then(NormalizeRows())
        .then(SignedHellingerMapper())
        .then(NormalizeRows())
    )


def _samples_per_image(config: ImageNetSiftLcsFVConfig, num_train: int) -> Tuple[int, int]:
    return (max(1, config.num_pca_samples // max(1, num_train)),
            max(1, config.num_gmm_samples // max(1, num_train)))


def _sift_files(config):
    return config.sift_pca_file, (config.sift_gmm_mean_file, config.sift_gmm_var_file,
                                  config.sift_gmm_wts_file)


def _lcs_files(config):
    return config.lcs_pca_file, (config.lcs_gmm_mean_file, config.lcs_gmm_var_file,
                                 config.lcs_gmm_wts_file)


def _assemble(config, sift_prefix, lcs_prefix, train, train_labels, top_k, device) -> Pipeline:
    per_pca, per_gmm = _samples_per_image(config, len(train))
    sift_branch = compute_pca_fisher_branch(sift_prefix, train, config, per_pca, per_gmm,
                                            *_sift_files(config), device=device)
    lcs_branch = compute_pca_fisher_branch(lcs_prefix, train, config, per_pca, per_gmm,
                                           *_lcs_files(config), device=device)
    return (
        Pipeline.gather([sift_branch, lcs_branch]) >> VectorCombiner()
    ).then_label_estimator(
        BlockWeightedLeastSquaresEstimator(
            config.solver_block_size,
            num_iter=1,
            reg=config.reg,
            mixture_weight=config.mixture_weight,
        ),
        train,
        train_labels,
    ) >> TopKClassifier(top_k)


def _lcs(config) -> LCSExtractor:
    return LCSExtractor(stride=config.lcs_stride, stride_start=config.lcs_border,
                        sub_patch_size=config.lcs_patch)


def build_pipeline(
    config: ImageNetSiftLcsFVConfig,
    train_images: ArrayDataset,
    train_labels: ArrayDataset,
    device: DeviceLike = None,
) -> Pipeline:
    """Assemble the full dual-branch DAG
    (reference: ImageNetSiftLcsFV.scala:96-136)."""
    sift_prefix = (
        PixelScaler().to_pipeline()
        >> GrayScaler()
        >> SIFTExtractor(scale_step=config.sift_scale_step)
        >> SignedHellingerMapper()
    )
    return _assemble(config, sift_prefix, _lcs(config).to_pipeline(), train_images,
                     train_labels, 5, device)


def build_native_resolution_pipeline(
    config: ImageNetSiftLcsFVConfig,
    train_buckets: BucketedDataset,
    train_labels: ArrayDataset,
    device: DeviceLike = None,
) -> Pipeline:
    """The flagship dual-branch DAG over native-resolution size buckets:
    :func:`build_pipeline`'s graph with ``MaskedExtractor`` prefixes, so
    every image is featurized at its own size (reference:
    VLFeat.cxx:170-186 takes per-call w,h) while sampling, the
    optimizable PCA, the GMM fit, the masked Fisher encoding, the gather
    and the solver run through the workflow layer."""
    sift_prefix = MaskedExtractor(
        SIFTExtractor(scale_step=config.sift_scale_step),
        pre=ApplyArrays(PixelScaler(), GrayScaler()),
        post=SignedHellingerMapper().apply_arrays,
    ).to_pipeline()
    lcs_prefix = MaskedExtractor(_lcs(config)).to_pipeline()
    return _assemble(config, sift_prefix, lcs_prefix, train_buckets, train_labels,
                     min(5, config.num_classes), device)


def top_k_err_percent(predicted, actual) -> float:
    """Stats.getErrPercent analog: % of rows whose true label is absent
    from the predicted top-k (reference: utils/Stats.scala getErrPercent)."""
    predicted = predicted.cpu().numpy() if isinstance(predicted, torch.Tensor) else np.asarray(predicted)
    actual = np.asarray(actual).reshape(-1)
    hit = (predicted == actual[:, None]).any(axis=1)
    return 100.0 * float((~hit).mean())


def _needs_inputs(config: ImageNetSiftLcsFVConfig) -> None:
    if not config.train_location or not config.label_path:
        raise ValueError(
            "imagenet workloads need --train-location (tar-of-JPEGs) and "
            "--label-path (reference: ImageNetSiftLcsFV.scala:75-141)"
        )


def _load_resized(location, config, device):
    records = load_imagenet(location, config.label_path, resize=config.image_size,
                            use_native=config.use_native).collect()
    images = ArrayDataset(np.stack([r["image"] for r in records]).astype(np.float32), device=device)
    return images, np.asarray([r["label"] for r in records])


def run(config: ImageNetSiftLcsFVConfig, device: DeviceLike = None) -> dict:
    """End-to-end train + evaluate (reference: ImageNetSiftLcsFV.scala:75-146).
    Returns ``pipeline`` (the fitted pipeline), ``seconds`` and, with a
    test set, ``test_error_percent`` and ``test_predictions`` (the top-5
    class ids per test image)."""
    start = time.time()
    _needs_inputs(config)
    with _spans.span("imagenet:load", split="train"):
        train_images, labels = _load_resized(config.train_location, config, device)
    train_labels = ClassLabelIndicators(config.num_classes).apply_batch(
        ArrayDataset(labels, device=train_images.device)
    )
    with _spans.span("imagenet:fit"):
        fitted = build_pipeline(config, train_images, train_labels, device=device).fit()
    del train_images, train_labels

    results = {"pipeline": fitted}
    if config.test_location:
        with _spans.span("imagenet:load", split="test"):
            test_images, test_labels = _load_resized(config.test_location, config, device)
        with _spans.span("imagenet:apply"):
            predicted = fitted.apply_batch(test_images).data.cpu().numpy()
        err = top_k_err_percent(predicted, test_labels)
        logger.info("TEST Error is %s%%", err)
        results["test_error_percent"] = err
        results["test_predictions"] = predicted
    results["seconds"] = time.time() - start
    return results


def run_native_resolution(config: ImageNetSiftLcsFVConfig, device: DeviceLike = None) -> dict:
    """End-to-end ImageNet SIFT+LCS+FV with per-image native-resolution
    featurization: the loader keeps each image's size (PIL decode), the
    images group into padded size buckets, and the fitted pipeline scores
    the training buckets. Returns ``pipeline`` (fitted), ``num_buckets``,
    ``num_train``, ``train_error_percent``, ``train_predictions`` (top-k
    class ids in bucket-major order), ``train_labels`` (same order) and
    ``seconds``."""
    from ..data.buckets import bucket_labels, bucketize_dataset, to_bucketed_dataset

    start = time.time()
    _needs_inputs(config)
    with _spans.span("imagenet_native:load"):
        ds = load_imagenet(config.train_location, config.label_path, resize=None)
        buckets = bucketize_dataset(ds, granularity=32)
        del ds
        train_buckets = to_bucketed_dataset(buckets, device=device)
    labels = bucket_labels(buckets)
    del buckets
    train_labels = ClassLabelIndicators(config.num_classes).apply_batch(
        ArrayDataset(labels, device=train_buckets.buckets[0].device)
    )
    with _spans.span("imagenet_native:fit"):
        fitted = build_native_resolution_pipeline(config, train_buckets, train_labels,
                                                  device=device).fit()
    del train_labels
    with _spans.span("imagenet_native:apply"):
        predicted_ds = fitted.apply_batch(train_buckets)
        if isinstance(predicted_ds, BucketedDataset):
            predicted_ds = predicted_ds.concat()
        predicted = predicted_ds.data.cpu().numpy()
    return {
        "pipeline": fitted,
        "num_buckets": len(train_buckets.buckets),
        "num_train": len(train_buckets),
        "train_error_percent": top_k_err_percent(predicted, labels),
        "train_predictions": predicted,
        "train_labels": labels,
        "seconds": time.time() - start,
    }
