"""Stupid Backoff language-model workload.

Port of ``keystone_tpu/pipelines/stupid_backoff.py`` (reference:
pipelines/nlp/StupidBackoffPipeline.scala): tokenize a corpus, fit a
frequency vocabulary, featurize 2..n-grams over the encoded ids, count
them, and fit the Stupid Backoff scorer. Host Python in both packages,
with the same dict and sort semantics, so the scores are equal.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np

from ..data.dataset import ObjectDataset
from ..device import DeviceLike, resolve_device
from ..ops.nlp import (
    NGramsCounts,
    NGramsFeaturizer,
    StupidBackoffEstimator,
    StupidBackoffModel,
    Tokenizer,
    WordFrequencyEncoder,
)

logger = logging.getLogger(__name__)


@dataclass
class StupidBackoffConfig:
    train_data: str = ""
    n: int = 3


def fit_language_model(lines, n: int = 3) -> StupidBackoffModel:
    text = Tokenizer().apply_batch(ObjectDataset(list(lines)))
    frequency_encode = WordFrequencyEncoder().fit(text)
    unigram_counts = frequency_encode.unigram_counts

    make_ngrams = frequency_encode.to_pipeline().then(NGramsFeaturizer(range(2, n + 1)))
    ngram_counts = NGramsCounts("no_add")(make_ngrams(text))
    return StupidBackoffEstimator(unigram_counts).fit(ngram_counts)


def _synthetic_corpus(num_lines: int = 2000, seed: int = 0) -> list:
    """Zipf-sampled sentences over a 500-word vocabulary, drawn as the JAX
    package draws them (the same lines for the same arguments), so the
    workload runs end to end without a corpus. The vocabulary is an array
    (the JAX package passes a list, which ``choice`` converts on every
    line; the draws are the same)."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i}" for i in range(500)])
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    p = (1.0 / ranks) / np.sum(1.0 / ranks)
    return [
        " ".join(rng.choice(vocab, size=rng.integers(4, 12), p=p))
        for _ in range(num_lines)
    ]


def run(config: StupidBackoffConfig, device: DeviceLike = None) -> dict:
    """Fit the model on ``config.train_data`` (one sentence per line) or
    on the synthetic corpus. The model is host Python; ``device`` is
    resolved as every entry point's is (``None``: the CUDA device, which
    must be present), and nothing is placed on it. Returns ``model``,
    ``seconds``, ``num_tokens``, ``vocab_size`` and ``num_ngrams``."""
    resolve_device(device)
    start = time.time()
    if config.train_data:
        with open(config.train_data) as f:
            lines = [line for line in f.read().splitlines() if line.strip()]
    else:
        logger.info("no --train-data given: using a synthetic Zipf corpus")
        lines = _synthetic_corpus()
    model = fit_language_model(lines, config.n)
    logger.info(
        "number of tokens: %d | vocab: %d | ngrams: %d",
        model.num_tokens,
        len(model.unigram_counts),
        len(model.scores),
    )
    return {"model": model, "seconds": time.time() - start, "num_tokens": model.num_tokens,
            "vocab_size": len(model.unigram_counts), "num_ngrams": len(model.scores)}
