"""Text / NLP operators: port of ``keystone_tpu.ops.nlp`` (reference:
nodes/nlp/), host Python as in the JAX package."""

from .corenlp import CoreNLPFeatureExtractor, lemmatize
from .indexers import NaiveBitPackIndexer, NGramIndexer
from .stupid_backoff import StupidBackoffEstimator, StupidBackoffModel
from .text import (
    HashingTF,
    LowerCase,
    NGramsCounts,
    NGramsFeaturizer,
    NGramsHashingTF,
    TermFrequency,
    Tokenizer,
    Trim,
    WordFrequencyEncoder,
    WordFrequencyTransformer,
)

__all__ = [
    "CoreNLPFeatureExtractor",
    "lemmatize",
    "HashingTF",
    "LowerCase",
    "NGramsCounts",
    "NGramsFeaturizer",
    "NGramsHashingTF",
    "NaiveBitPackIndexer",
    "NGramIndexer",
    "StupidBackoffEstimator",
    "StupidBackoffModel",
    "TermFrequency",
    "Tokenizer",
    "Trim",
    "WordFrequencyEncoder",
    "WordFrequencyTransformer",
]
