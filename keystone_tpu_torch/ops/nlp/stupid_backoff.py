"""Stupid Backoff n-gram language model (Brants et al. 2007).

Port of ``keystone_tpu/ops/nlp/stupid_backoff.py`` (host Python, the same
dict semantics and scores). Reference: nodes/nlp/StupidBackoff.scala:25-200. Score:

    S(w_i | context) = freq(ngram)/freq(context)       if freq(ngram) > 0
                       α · S(w_i | shorter context)    otherwise
    S(w_i) = freq(w_i) / N

Scores are computed for every counted n-gram at fit time (the reference
does this partition-locally after co-partitioning ngrams by their first
two context words; here the count table is a host dict, so locality is
free) and arbitrary n-grams can be scored on demand with ``score``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

from ...data.dataset import Dataset
from ...workflow.pipeline import Estimator, Transformer
from .indexers import NGramIndexer


class StupidBackoffModel(Transformer):
    def __init__(
        self,
        scores: Dict[Tuple, float],
        ngram_counts: Dict[Tuple, int],
        unigram_counts: Mapping,
        num_tokens: int,
        alpha: float = 0.4,
        indexer: NGramIndexer = None,
    ):
        self.scores = scores
        self.ngram_counts = ngram_counts
        self.unigram_counts = unigram_counts
        self.num_tokens = num_tokens
        self.alpha = alpha
        self.indexer = indexer or NGramIndexer()

    def score(self, ngram) -> float:
        """Recursive backoff score (reference: StupidBackoff.scoreLocally).

        Accepts either a word sequence (packed through the indexer) or an
        already-packed key (e.g. a NaiveBitPackIndexer 64-bit int)."""
        key = self.indexer.pack(ngram) if isinstance(ngram, (list, tuple)) else ngram
        if self.indexer.ngram_order(key) == 1:
            freq = self.unigram_counts.get(self.indexer.unpack(key, 0), 0)
        else:
            freq = self.ngram_counts.get(key, 0)
        return self._score(1.0, key, freq)

    def _score(self, accum: float, ngram, freq: int) -> float:
        idx = self.indexer
        order = idx.ngram_order(ngram)
        if order == 1:
            return accum * freq / self.num_tokens
        if freq != 0:
            context = idx.remove_current_word(ngram)
            if order != 2:
                context_freq = self.ngram_counts.get(context, 0)
            else:
                context_freq = self.unigram_counts.get(idx.unpack(context, 0), 0)
            if context_freq != 0:
                return accum * freq / context_freq
            # Context unseen in the count table (e.g. counts fitted on a
            # single high order only) — treat like an unseen ngram and back
            # off rather than dividing by zero.
        backoffed = idx.remove_farthest_word(ngram)
        if order != 2:
            freq2 = self.ngram_counts.get(backoffed, 0)
        else:
            freq2 = self.unigram_counts.get(idx.unpack(backoffed, 0), 0)
        return self._score(self.alpha * accum, backoffed, freq2)

    def apply(self, datum):
        raise NotImplementedError(
            "chain-application is meaningless for an LM; query with score(ngram)"
        )


class StupidBackoffEstimator(Estimator):
    """Fit from (ngram, count) pairs
    (reference: StupidBackoff.scala:138-180 StupidBackoffEstimator)."""

    def __init__(self, unigram_counts: Mapping, alpha: float = 0.4, indexer: NGramIndexer = None):
        self.unigram_counts = unigram_counts
        self.alpha = alpha
        self.indexer = indexer or NGramIndexer()

    def fit(self, data: Dataset) -> StupidBackoffModel:
        if isinstance(data, Dataset):
            pairs = data.collect()
        else:
            pairs = list(data)
        counts: Dict = {}
        for ngram, c in pairs:
            key = self.indexer.pack(ngram) if isinstance(ngram, (list, tuple)) else ngram
            counts[key] = counts.get(key, 0) + c
        num_tokens = sum(self.unigram_counts.values())
        model = StupidBackoffModel(
            {}, counts, self.unigram_counts, num_tokens, self.alpha, self.indexer
        )
        scores = {}
        for ngram, freq in counts.items():
            s = model._score(1.0, ngram, freq)
            if not (0.0 <= s <= 1.0):
                raise AssertionError(f"score {s} not in [0,1] for {ngram}")
            scores[ngram] = s
        model.scores = scores
        return model
