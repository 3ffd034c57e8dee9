"""TIMIT phone-classification workload.

Port of ``keystone_tpu/pipelines/timit.py`` (reference:
pipelines/speech/TimitPipeline.scala): ``num_cosines`` parallel
``CosineRandomFeatures`` branches (4,096 features each, Gaussian or
Cauchy W), gathered and concatenated, then block least squares over
4,096-wide feature blocks and argmax classification against 147 phone
classes.

Every entry point takes ``device=`` (default ``None``: the CUDA device);
it is threaded to the datasets, the random-feature weights and the
estimator.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np

from ..data.dataset import ArrayDataset
from ..data.loaders.csv import LabeledData
from ..data.loaders.timit import NUM_CLASSES, TIMIT_DIMENSION, load_timit
from ..device import DeviceLike
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..obs import spans as _spans
from ..ops.learning.block import BlockLeastSquaresEstimator
from ..ops.stats.core import CosineRandomFeatures
from ..ops.util.labels import ClassLabelIndicators, MaxClassifier
from ..ops.util.vectors import VectorCombiner
from ..workflow.pipeline import Pipeline

logger = logging.getLogger(__name__)

NUM_COSINE_FEATURES = 4096


@dataclass
class TimitConfig:
    train_data_location: str = ""
    train_labels_location: str = ""
    test_data_location: str = ""
    test_labels_location: str = ""
    num_cosines: int = 50
    gamma: float = 0.05555
    rf_type: str = "gaussian"  # or "cauchy"
    reg: float = 0.0
    num_epochs: int = 5
    num_cosine_features: int = NUM_COSINE_FEATURES
    seed: int = 123


def build_featurizer(
    config: TimitConfig, input_dim: int = TIMIT_DIMENSION, device: DeviceLike = None
) -> Pipeline:
    with _spans.span("build:featurizer", branches=config.num_cosines):
        branches = [
            CosineRandomFeatures.create(
                input_dim,
                config.num_cosine_features,
                config.gamma,
                dist=config.rf_type,
                seed=config.seed + i,
                device=device,
            )
            for i in range(config.num_cosines)
        ]
        return Pipeline.gather(branches) >> VectorCombiner()


def build_pipeline(
    config: TimitConfig,
    train: LabeledData,
    input_dim: int = TIMIT_DIMENSION,
    device: DeviceLike = None,
) -> Pipeline:
    labels = ClassLabelIndicators(NUM_CLASSES)(train.labels)
    featurizer = build_featurizer(config, input_dim, device=device)
    return featurizer.then_label_estimator(
        BlockLeastSquaresEstimator(
            config.num_cosine_features, num_iter=config.num_epochs, reg=config.reg,
            device=device,
        ),
        train.data,
        labels,
    ) >> MaxClassifier()


def run(config: TimitConfig, device: DeviceLike = None) -> dict:
    start = time.time()
    if config.train_data_location:
        data = load_timit(
            config.train_data_location,
            config.train_labels_location,
            config.test_data_location,
            config.test_labels_location,
            device=device,
        )
        train, test = data.train, data.test
    else:
        train = synthetic_timit(4096, seed=config.seed, device=device)
        test = synthetic_timit(1024, seed=config.seed + 1, device=device)

    pipeline = build_pipeline(config, train, TIMIT_DIMENSION, device=device)
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


def synthetic_timit(n: int, seed: int = 0, device: DeviceLike = None) -> LabeledData:
    """Learnable synthetic stand-in: labels from a hidden linear rule over
    the 440-dim feature space, drawn with numpy exactly as the JAX
    package draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, TIMIT_DIMENSION)).astype(np.float32)
    w = np.random.default_rng(54321).normal(size=(TIMIT_DIMENSION, NUM_CLASSES))
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return LabeledData(ArrayDataset(y, device=device), ArrayDataset(x, device=device))
