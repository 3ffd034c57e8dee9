"""Text preprocessing, n-gram, and feature-hashing operators.

Port of ``keystone_tpu/ops/nlp/text.py``. These are host-side (string)
operators, so the port is the same Python: a deterministic 32-bit
Java-style string hash plus a Scala-compatible MurmurHash3 sequence mix,
bit-identical to the JAX package, so ``NGramsHashingTF`` equals
``NGramsFeaturizer >> HashingTF`` and both packages hash every term to
the same feature. Output rows are scipy CSR (1, num_features).
``NGramsCounts`` and ``WordFrequencyEncoder`` count with ``Counter`` and
sort with Python's stable sort on the negated count, so equal counts keep
their first-seen order and both packages rank every term alike.
"""

from __future__ import annotations

import functools
import re
from collections import Counter
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

from ...data.dataset import Dataset
from ...utils.sparse import BlockSparseMatrix, csr_row
from ...workflow.pipeline import Estimator, Transformer

_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=1 << 18)
def java_string_hash(s: str) -> int:
    """JVM ``String.hashCode``: h = 31·h + c, 32-bit signed. Cached: a
    corpus repeats its vocabulary, and this loop is the hashing cost."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & _M32
    return h - (1 << 32) if h >= (1 << 31) else h


def _rotl(x: int, r: int) -> int:
    x &= _M32
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix(h: int, k: int) -> int:
    k = (k * 0xCC9E2D51) & _M32
    k = _rotl(k, 15)
    k = (k * 0x1B873593) & _M32
    h = (h ^ k) & _M32
    h = _rotl(h, 13)
    return (h * 5 + 0xE6546B64) & _M32


def _finalize(h: int, length: int) -> int:
    h = (h ^ length) & _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h - (1 << 32) if h >= (1 << 31) else h


SEQ_SEED = java_string_hash("Seq")


def term_hash(term: Any) -> int:
    """Deterministic 32-bit hash: strings via Java hashCode, int-like via
    value, tuples (n-grams) via MurmurHash3 over word hashes."""
    if isinstance(term, str):
        return java_string_hash(term)
    if isinstance(term, (int, np.integer)):
        return int(term) & _M32
    if isinstance(term, (tuple, list)):
        h = SEQ_SEED
        for w in term:
            h = _mix(h, term_hash(w) & _M32)
        return _finalize(h, len(term))
    return java_string_hash(repr(term))


class Trim(Transformer):
    """Strip leading/trailing whitespace."""

    def apply(self, s: str) -> str:
        return s.strip()


class LowerCase(Transformer):
    """Lowercase."""

    def apply(self, s: str) -> str:
        return s.lower()


class Tokenizer(Transformer):
    """Split on a delimiter regex; default matches runs of punctuation and
    whitespace."""

    def __init__(self, sep: str = r"[\W_]+"):
        self.sep = re.compile(sep)

    def apply(self, s: str) -> List[str]:
        # re.split yields '' at leading/trailing delimiters; the JVM's
        # String.split drops those, so drop them here too.
        return [t for t in self.sep.split(s) if t]


class NGramsFeaturizer(Transformer):
    """All n-grams for consecutive orders [min(orders), max(orders)],
    position-major, then ascending order."""

    def __init__(self, orders: Sequence[int]):
        self.min_order = min(orders)
        self.max_order = max(orders)
        if self.min_order < 1:
            raise ValueError("minimum order must be >= 1")
        sorted_orders = sorted(orders)
        for a, b in zip(sorted_orders, sorted_orders[1:]):
            if b != a + 1:
                raise ValueError("orders must be consecutive")

    def apply(self, tokens: Sequence[Any]) -> List[Tuple[Any, ...]]:
        out: List[Tuple[Any, ...]] = []
        n = len(tokens)
        for i in range(n - self.min_order + 1):
            for order in range(self.min_order, self.max_order + 1):
                if i + order > n:
                    break
                out.append(tuple(tokens[i : i + order]))
        return out


class NGramsCounts:
    """Count n-grams across the whole dataset, sorted by count descending
    (reference: nodes/nlp/ngrams.scala:150-196 NGramsCounts).

    Called on a dataset of per-line n-gram lists (or a pipeline's result,
    or a plain iterable), it returns a list of (ngram, count) pairs;
    ``mode="no_add"`` skips the global sort (the reference's
    per-partition NoAdd mode), leaving first-seen order."""

    def __init__(self, mode: str = "default"):
        if mode not in ("default", "no_add"):
            raise ValueError("mode must be 'default' or 'no_add'")
        self.mode = mode

    def __call__(self, data) -> List[Tuple[Tuple[Any, ...], int]]:
        counts: Counter = Counter()
        items = data.collect() if isinstance(data, Dataset) else (
            data.get().collect() if hasattr(data, "get") else data
        )
        for line in items:
            counts.update(line)
        pairs = list(counts.items())
        if self.mode == "default":
            pairs.sort(key=lambda kv: -kv[1])
        return pairs


class TermFrequency(Transformer):
    """Seq[T] → Seq[(T, weight(count))]."""

    def __init__(self, fun: Callable[[float], float] = lambda x: x):
        self.fun = fun

    def apply(self, terms: Sequence[Any]) -> List[Tuple[Any, float]]:
        return [(t, float(self.fun(c))) for t, c in Counter(terms).items()]


def _non_negative_mod(x: int, mod: int) -> int:
    r = x % mod
    return r + mod if r < 0 else r


class HashingTF(Transformer):
    """Terms → sparse term-frequency vector via the hashing trick. A
    dataset of these rows fed straight into ``BlockLeastSquaresEstimator``
    fits on the block-sparse kernel when block density is at or below the
    threshold."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def apply(self, document: Sequence[Any]):
        tf: Counter = Counter()
        for term in document:
            tf[_non_negative_mod(term_hash(term), self.num_features)] += 1.0
        return csr_row(tf, self.num_features)


def block_sparse_features(rows, block_shape=None) -> BlockSparseMatrix:
    """Stack hashing-TF CSR rows into the BSR container the block-sparse
    kernel consumes, without materializing the dense matrix.
    ``block_shape`` defaults to the env/tile default shrunk to the
    feature width."""
    from ..cuda.blocksparse import default_block_shape

    items = rows.collect() if isinstance(rows, Dataset) else list(rows)
    if not items:
        raise ValueError("no rows to convert")
    if block_shape is None:
        block_shape = default_block_shape(int(items[0].shape[-1]))
    return BlockSparseMatrix.from_csr_rows(items, block_shape)


class NGramsHashingTF(Transformer):
    """Rolling-hash fusion of NGramsFeaturizer >> HashingTF: hashes each
    n-gram incrementally and produces the same sparse vector as the
    unfused pair."""

    def __init__(self, orders: Sequence[int], num_features: int):
        NGramsFeaturizer(orders)  # validates orders
        self.min_order = min(orders)
        self.max_order = max(orders)
        self.num_features = num_features

    def apply(self, line: Sequence[str]):
        hashes = [term_hash(w) & _M32 for w in line]
        n = len(line)
        tf: Counter = Counter()
        for i in range(n - self.min_order + 1):
            h = SEQ_SEED
            for j in range(i, i + self.min_order):
                h = _mix(h, hashes[j])
            tf[_non_negative_mod(_finalize(h, self.min_order), self.num_features)] += 1.0
            for order in range(self.min_order + 1, self.max_order + 1):
                if i + order > n:
                    break
                h = _mix(h, hashes[i + order - 1])
                tf[_non_negative_mod(_finalize(h, order), self.num_features)] += 1.0
        return csr_row(tf, self.num_features)


class WordFrequencyTransformer(Transformer):
    """Token → frequency-rank index; out-of-vocabulary → −1
    (reference: WordFrequencyEncoder.scala:33-60)."""

    OOV_INDEX = -1

    def __init__(self, word_index: dict, unigram_counts: dict):
        self.word_index = word_index
        self.unigram_counts = unigram_counts  # {rank index: count}

    def apply(self, words: Sequence[str]) -> List[int]:
        idx = self.word_index
        return [idx.get(w, self.OOV_INDEX) for w in words]


class WordFrequencyEncoder(Estimator):
    """Fit a frequency-ranked vocabulary: rank 0 is the most frequent word,
    equal counts in first-seen order (reference:
    WordFrequencyEncoder.scala:7-31)."""

    def fit(self, data: Dataset) -> WordFrequencyTransformer:
        counts: Counter = Counter()
        for tokens in data.collect():
            counts.update(tokens)
        ranked = sorted(counts.items(), key=lambda kv: -kv[1])
        word_index = {w: i for i, (w, _) in enumerate(ranked)}
        unigram_counts = {word_index[w]: c for w, c in counts.items()}
        return WordFrequencyTransformer(word_index, unigram_counts)
