"""MNIST random-FFT workload — the reference's README example pipeline.

Port of ``keystone_tpu/pipelines/mnist_random_fft.py``
(reference: pipelines/images/mnist/MnistRandomFFT.scala): ``num_ffts``
parallel branches of RandomSign → PaddedFFT → LinearRectifier, gathered
and concatenated, then block least squares and argmax classification.

Every entry point takes ``device=`` (default ``None``: the CUDA device);
it is threaded to the datasets, the sign vectors and the estimator.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..data.dataset import ArrayDataset
from ..data.loaders.csv import LabeledData, load_labeled_csv
from ..device import DeviceLike
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..ops.learning.block import BlockLeastSquaresEstimator
from ..ops.stats.core import LinearRectifier, PaddedFFT, RandomSignNode
from ..ops.util.labels import ClassLabelIndicators, MaxClassifier
from ..ops.util.vectors import VectorCombiner
from ..workflow.pipeline import Pipeline

logger = logging.getLogger(__name__)

NUM_CLASSES = 10
MNIST_IMAGE_SIZE = 784


@dataclass
class MnistRandomFFTConfig:
    train_location: str = ""
    test_location: str = ""
    num_ffts: int = 4
    block_size: int = 2048
    reg: Optional[float] = None
    seed: int = 0


def build_featurizer(
    config: MnistRandomFFTConfig, image_size: int = MNIST_IMAGE_SIZE, device: DeviceLike = None
) -> Pipeline:
    branches = [
        RandomSignNode.create(image_size, seed=config.seed + i, device=device)
        >> PaddedFFT()
        >> LinearRectifier(0.0)
        for i in range(config.num_ffts)
    ]
    return Pipeline.gather(branches) >> VectorCombiner()


def build_pipeline(
    config: MnistRandomFFTConfig, train: LabeledData, device: DeviceLike = None
) -> Pipeline:
    labels = ClassLabelIndicators(NUM_CLASSES)(train.labels)
    featurizer = build_featurizer(config, device=device)
    return featurizer.then_label_estimator(
        BlockLeastSquaresEstimator(
            config.block_size, num_iter=1, reg=config.reg or 0.0, device=device
        ),
        train.data,
        labels,
    ) >> MaxClassifier()


def run(config: MnistRandomFFTConfig, device: DeviceLike = None) -> dict:
    start = time.time()
    if config.train_location:
        # Reference MNIST CSVs are 1-indexed label-first rows.
        train = load_labeled_csv(config.train_location, label_offset=-1, device=device)
        test = (
            load_labeled_csv(config.test_location, label_offset=-1, device=device)
            if config.test_location
            else None
        )
    else:
        train = synthetic_mnist(8192, seed=config.seed, device=device)
        test = synthetic_mnist(2048, seed=config.seed + 1, device=device)

    pipeline = build_pipeline(config, train, device=device)
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator.evaluate(pipeline(train.data), train.labels)
    logger.info("TRAIN error %.2f%%", 100 * train_eval.total_error)
    results = {"train_error": train_eval.total_error, "pipeline": pipeline}
    if test is not None:
        test_eval = evaluator.evaluate(pipeline(test.data), test.labels)
        logger.info("TEST error %.2f%%", 100 * test_eval.total_error)
        results["test_error"] = test_eval.total_error
    results["seconds"] = time.time() - start
    return results


def synthetic_mnist(n: int, seed: int = 0, device: DeviceLike = None) -> LabeledData:
    """Learnable synthetic stand-in: labels from a hidden linear rule,
    drawn with numpy exactly as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, MNIST_IMAGE_SIZE)).astype(np.float32)
    w = np.random.default_rng(12345).normal(size=(MNIST_IMAGE_SIZE, NUM_CLASSES))
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return LabeledData(ArrayDataset(y, device=device), ArrayDataset(x, device=device))
