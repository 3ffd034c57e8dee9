"""Text classification workloads: Amazon reviews and 20 Newsgroups.

Port of ``keystone_tpu/pipelines/text.py`` (reference:
pipelines/text/AmazonReviewsPipeline.scala — binary sentiment: Trim →
LowerCase → Tokenizer → NGrams(1..n) → TermFrequency(x→1) →
CommonSparseFeatures → logistic regression — and
pipelines/text/NewsgroupsPipeline.scala — the same featurization → naive
Bayes → MaxClassifier). The featurization is host-side; the solvers run
on ``device`` (default CUDA) through the ``Densify`` bridge (CSR rows →
one dense float32 matrix on the device).

Every entry point takes ``device=``; it is threaded to ``Densify`` and
the estimator.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from ..data.loaders.text import (
    NEWSGROUPS_CLASSES,
    TextLabeledData,
    load_amazon_reviews,
    load_newsgroups,
)
from ..device import DeviceLike
from ..evaluation import BinaryClassifierEvaluator, MulticlassClassifierEvaluator
from ..ops.learning.logistic import LogisticRegressionEstimator
from ..ops.learning.naive_bayes import NaiveBayesEstimator
from ..ops.nlp.text import LowerCase, NGramsFeaturizer, TermFrequency, Tokenizer, Trim
from ..ops.util.labels import MaxClassifier
from ..ops.util.sparse import CommonSparseFeatures
from ..ops.util.vectors import Densify
from ..workflow.pipeline import Pipeline

logger = logging.getLogger(__name__)


@dataclass
class AmazonReviewsConfig:
    train_location: str = ""
    test_location: str = ""
    threshold: float = 3.5
    n_grams: int = 2
    common_features: int = 100000
    num_iters: int = 20


@dataclass
class NewsgroupsConfig:
    train_location: str = ""
    test_location: str = ""
    n_grams: int = 2
    common_features: int = 100000


def build_featurizer(n_grams: int, common_features: int, train_data) -> Pipeline:
    """Shared Trim→…→CommonSparseFeatures prefix of both text pipelines."""
    return (
        Trim().to_pipeline()
        .then(LowerCase())
        .then(Tokenizer())
        .then(NGramsFeaturizer(range(1, n_grams + 1)))
        .then(TermFrequency(lambda x: 1))
        .then_estimator(CommonSparseFeatures(common_features), train_data)
    )


def build_amazon(
    config: AmazonReviewsConfig, train: TextLabeledData, device: DeviceLike = None
) -> Pipeline:
    featurizer = build_featurizer(config.n_grams, config.common_features, train.data)
    return featurizer.then(Densify(device=device)).then_label_estimator(
        LogisticRegressionEstimator(num_classes=2, num_iterations=config.num_iters, device=device),
        train.data,
        train.labels,
    ) >> MaxClassifier()


def build_newsgroups(
    config: NewsgroupsConfig, train: TextLabeledData, device: DeviceLike = None
) -> Pipeline:
    featurizer = build_featurizer(config.n_grams, config.common_features, train.data)
    return featurizer.then(Densify(device=device)).then_label_estimator(
        NaiveBayesEstimator(len(NEWSGROUPS_CLASSES), device=device), train.data, train.labels
    ) >> MaxClassifier()


def run_amazon(config: AmazonReviewsConfig, device: DeviceLike = None) -> dict:
    start = time.time()
    if not config.train_location:
        raise ValueError(
            "amazon-reviews needs --train-location pointing at the Amazon "
            "reviews JSON (reference: AmazonReviewsPipeline.scala)"
        )
    train = load_amazon_reviews(config.train_location, config.threshold)
    pipeline = build_amazon(config, train, device=device)
    results = {"pipeline": pipeline}
    if config.test_location:
        test = load_amazon_reviews(config.test_location, config.threshold)
        preds = pipeline(test.data)
        eval_ = BinaryClassifierEvaluator().evaluate(preds, test.labels)
        logger.info("\n%s", eval_.summary())
        results["metrics"] = eval_
    results["seconds"] = time.time() - start
    return results


def run_newsgroups(config: NewsgroupsConfig, device: DeviceLike = None) -> dict:
    start = time.time()
    if not config.train_location:
        raise ValueError(
            "newsgroups needs --train-location pointing at the 20news "
            "directory tree (reference: NewsgroupsPipeline.scala)"
        )
    train = load_newsgroups(config.train_location)
    pipeline = build_newsgroups(config, train, device=device)
    results = {"pipeline": pipeline}
    if config.test_location:
        test = load_newsgroups(config.test_location)
        eval_ = MulticlassClassifierEvaluator(len(NEWSGROUPS_CLASSES)).evaluate(
            pipeline(test.data), test.labels
        )
        logger.info("test error: %s", eval_.total_error)
        results["metrics"] = eval_
    results["seconds"] = time.time() - start
    return results


__all__ = [
    "AmazonReviewsConfig",
    "NewsgroupsConfig",
    "build_amazon",
    "build_featurizer",
    "build_newsgroups",
    "run_amazon",
    "run_newsgroups",
]
