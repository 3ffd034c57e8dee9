"""VOC 2007 SIFT + Fisher Vector workload.

Port of ``keystone_tpu/pipelines/voc.py`` (reference:
pipelines/images/voc/VOCSIFTFisher.scala:20-152). Pipeline shape,
hyperparameters and seeds are the JAX package's; the tar of ragged JPEGs
is resized on the host to one static shape, so SIFT, the PCA projection
and the Fisher encoding each run batched on the device.

Stages (reference lines in parens):
  PixelScaler → GrayScaler → SIFT (:42-46); ColumnSampler → ColumnPCA
  (:48-58); ColumnSampler → GMM Fisher Vector (:60-74); FloatToDouble →
  MatrixVectorizer → NormalizeRows → SignedHellinger → NormalizeRows
  (:75-80); BlockLeastSquares(4096, 1, λ) (:82-86); MAP evaluation
  (:88-104).

Every entry point takes ``device=`` (default ``None``: the CUDA device).
``run`` fits the pipeline (``Pipeline.fit``) before it scores the test
set, so the fit's node outputs (at 256×256, 12.3 MB of descriptors per
image before PCA) are freed before the test images are featurized; the
JAX package applies the unfitted pipeline to the test set, which
computes the same fit. ``run`` opens the spans ``voc:load``,
``voc:fit`` and ``voc:apply``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..data.dataset import ArrayDataset, Dataset, ObjectDataset
from ..data.loaders.voc import NUM_CLASSES, load_voc
from ..device import DeviceLike
from ..evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
from ..obs import spans as _spans
from ..ops.images.core import GrayScaler, PixelScaler
from ..ops.images.fisher import FisherVector, GMMFisherVectorEstimator
from ..ops.images.sift import SIFTExtractor
from ..ops.learning.block import BlockLeastSquaresEstimator
from ..ops.learning.gmm import GaussianMixtureModel
from ..ops.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from ..ops.stats.core import ColumnSampler, NormalizeRows, SignedHellingerMapper
from ..ops.util.labels import MultiLabelIndicators
from ..ops.util.vectors import FloatToDouble, MatrixVectorizer
from ..workflow.pipeline import Pipeline

logger = logging.getLogger(__name__)


@dataclass
class SIFTFisherConfig:
    """reference: VOCSIFTFisher.scala:108-122 SIFTFisherConfig."""

    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    reg: float = 0.5  # lambda
    desc_dim: int = 80
    vocab_size: int = 256
    scale_step: int = 0
    pca_file: Optional[str] = None
    gmm_mean_file: Optional[str] = None
    gmm_var_file: Optional[str] = None
    gmm_wts_file: Optional[str] = None
    num_pca_samples: int = int(1e6)
    num_gmm_samples: int = int(1e6)
    image_size: Tuple[int, int] = (256, 256)  # host-side resize for batching
    solver_block_size: int = 4096
    seed: int = 42
    # Decode path: None → the native libjpeg decode (a resize is set),
    # False → PIL (a machine without jpeglib.h), True → native.
    use_native: Optional[bool] = None


def extract_images(parsed: Dataset, device: DeviceLike = None) -> ArrayDataset:
    """MultiLabeledImageExtractor analog: records → stacked image batch."""
    records = parsed.collect()
    return ArrayDataset(np.stack([r["image"] for r in records]).astype(np.float32), device=device)


def extract_multi_labels(parsed: Dataset) -> ObjectDataset:
    """MultiLabelExtractor analog."""
    return ObjectDataset([r["labels"] for r in parsed.collect()])


def build_pipeline(
    config: SIFTFisherConfig,
    train_images: ArrayDataset,
    train_labels: ArrayDataset,
    device: DeviceLike = None,
) -> Pipeline:
    """Assemble the featurizer + solver DAG
    (reference: VOCSIFTFisher.scala:40-86)."""
    num_train = len(train_images)
    pca_samples_per_image = max(1, config.num_pca_samples // max(1, num_train))
    gmm_samples_per_image = max(1, config.num_gmm_samples // max(1, num_train))

    sift_extractor = (
        PixelScaler().to_pipeline()
        >> GrayScaler()
        >> SIFTExtractor(scale_step=config.scale_step)
    )

    # PCA stage: load from disk or fit on sampled descriptors.
    if config.pca_file is not None:
        pca_mat = np.loadtxt(config.pca_file, delimiter=",").astype(np.float32)
        pca_featurizer = sift_extractor >> BatchPCATransformer(pca_mat.T, device=device)
    else:
        pca_samples = ColumnSampler(pca_samples_per_image, seed=config.seed)(
            sift_extractor(train_images)
        )
        pca_featurizer = sift_extractor.then(
            ColumnPCAEstimator(config.desc_dim).with_data(pca_samples)
        )

    # Fisher stage: load GMM from disk or fit on sampled PCA'd descriptors.
    if config.gmm_mean_file is not None:
        gmm = GaussianMixtureModel.load(
            config.gmm_mean_file, config.gmm_var_file, config.gmm_wts_file, device=device
        )
        fisher_featurizer = pca_featurizer >> FisherVector(gmm)
    else:
        gmm_samples = ColumnSampler(gmm_samples_per_image, seed=config.seed)(
            pca_featurizer(train_images)
        )
        fisher_featurizer = pca_featurizer.then(
            GMMFisherVectorEstimator(config.vocab_size).with_data(gmm_samples)
        )

    featurizer = (
        fisher_featurizer
        >> FloatToDouble()
        >> MatrixVectorizer()
        >> NormalizeRows()
        >> SignedHellingerMapper()
        >> NormalizeRows()
    )

    return featurizer.then_label_estimator(
        BlockLeastSquaresEstimator(
            config.solver_block_size, num_iter=1, reg=config.reg, device=device
        ),
        train_images,
        train_labels,
    )


def run(config: SIFTFisherConfig, device: DeviceLike = None) -> dict:
    """End-to-end train + evaluate (reference: VOCSIFTFisher.scala:24-105).
    Returns ``pipeline`` (the fitted pipeline), ``seconds`` and, with a
    test set, ``test_map`` and ``per_class_ap``."""
    start = time.time()
    if not config.train_location or not config.label_path:
        raise ValueError(
            "voc-sift-fisher needs --train-location (VOC 2007 image tar) "
            "and --label-path (see examples/images/voc_sift_fisher.sh)"
        )
    with _spans.span("voc:load", split="train"):
        parsed = load_voc(config.train_location, config.label_path, resize=config.image_size,
                          use_native=config.use_native)
        train_images = extract_images(parsed, device=device)
    train_labels = MultiLabelIndicators(NUM_CLASSES, device=device).apply_batch(
        extract_multi_labels(parsed)
    )
    del parsed

    with _spans.span("voc:fit"):
        fitted = build_pipeline(config, train_images, train_labels, device=device).fit()
    del train_images, train_labels

    results = {"pipeline": fitted}
    if config.test_location:
        with _spans.span("voc:load", split="test"):
            test_parsed = load_voc(config.test_location, config.label_path, resize=config.image_size,
                                   use_native=config.use_native)
            test_images = extract_images(test_parsed, device=device)
        test_actuals = extract_multi_labels(test_parsed)
        with _spans.span("voc:apply"):
            predictions = fitted.apply_batch(test_images)
            aps = MeanAveragePrecisionEvaluator(NUM_CLASSES).evaluate(
                predictions, test_actuals.collect()
            )
        logger.info("TEST APs are: %s", ",".join(str(a) for a in aps))
        logger.info("TEST MAP is: %s", float(np.mean(aps)))
        results["test_map"] = float(np.mean(aps))
        results["per_class_ap"] = np.asarray(aps)
    results["seconds"] = time.time() - start
    return results
