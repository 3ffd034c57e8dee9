"""N-gram indexers for backoff language models.

Port of ``keystone_tpu/ops/nlp/indexers.py`` (host Python, the same
packed 64-bit keys). Reference: nodes/nlp/indexers.scala:5-130 — the ``BackoffIndexer``
interface (pack/unpack/strip words, query order) with two
implementations: tuple-backed (any word type) and the 64-bit
``NaiveBitPackIndexer`` (20 bits per word, ≤ trigrams, vocab < 2²⁰).
"""

from __future__ import annotations

from typing import Sequence, Tuple

_WORD_BITS = 20
_WORD_MASK = (1 << _WORD_BITS) - 1
_CTRL_SHIFT = 60
_U64 = (1 << 64) - 1


class NGramIndexer:
    """Tuple-backed indexer (reference: indexers.scala NGramIndexerImpl).

    Position 0 is the farthest context word; the last position is the
    current word."""

    min_ngram_order = 1
    max_ngram_order = 5

    def pack(self, ngram: Sequence) -> Tuple:
        return tuple(ngram)

    def unpack(self, ngram: Tuple, pos: int):
        return ngram[pos]

    def remove_farthest_word(self, ngram: Tuple) -> Tuple:
        return ngram[1:]

    def remove_current_word(self, ngram: Tuple) -> Tuple:
        return ngram[:-1]

    def ngram_order(self, ngram: Tuple) -> int:
        return len(ngram)


class NaiveBitPackIndexer:
    """Pack ≤3 word ids (< 2²⁰) into one 64-bit int
    (reference: indexers.scala:48-115).

    Layout, most→least significant: [4 control bits][farthest]…[current],
    left-aligned. Control bits 0/1/2 → unigram/bigram/trigram."""

    min_ngram_order = 1
    max_ngram_order = 3

    def pack(self, ngram: Sequence[int]) -> int:
        for w in ngram:
            if not (0 <= w < (1 << _WORD_BITS)):
                # catches the WordFrequencyTransformer OOV index (-1), which
                # would otherwise clobber neighboring fields and control bits
                raise ValueError("word id must be in [0, 2^20)")
        n = len(ngram)
        if n == 1:
            return (ngram[0] << 40) & _U64
        if n == 2:
            return ((ngram[1] << 20) | (ngram[0] << 40) | (1 << 60)) & _U64
        if n == 3:
            return (ngram[2] | (ngram[1] << 20) | (ngram[0] << 40) | (1 << 61)) & _U64
        raise ValueError("ngram order must be in {1, 2, 3}")

    def unpack(self, ngram: int, pos: int) -> int:
        if pos == 0:
            return (ngram >> 40) & _WORD_MASK
        if pos == 1:
            return (ngram >> 20) & _WORD_MASK
        if pos == 2:
            return ngram & _WORD_MASK
        raise ValueError("pos must be in {0, 1, 2}")

    def ngram_order(self, ngram: int) -> int:
        order = (ngram >> _CTRL_SHIFT) & 0xF
        if not (self.min_ngram_order <= order + 1 <= self.max_ngram_order):
            raise ValueError(f"invalid control bits {order}")
        return order + 1

    def remove_farthest_word(self, ngram: int) -> int:
        order = self.ngram_order(ngram)
        stripped = ngram & ((1 << 40) - 1)
        shifted = (stripped << 20) & ~(0xF << _CTRL_SHIFT) & _U64
        if order == 2:
            return shifted
        if order == 3:
            return (shifted | (1 << 60)) & _U64
        raise ValueError(f"unsupported order {order}")

    def remove_current_word(self, ngram: int) -> int:
        order = self.ngram_order(ngram)
        if order == 2:
            return ngram & ~((1 << 40) - 1) & ~(0xF << _CTRL_SHIFT) & _U64
        if order == 3:
            stripped = ngram & ~((1 << 20) - 1)
            return ((stripped & ~(0xF << _CTRL_SHIFT)) | (1 << 60)) & _U64
        raise ValueError(f"unsupported order {order}")
