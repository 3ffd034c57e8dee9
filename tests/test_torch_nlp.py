"""The NLP remainder in the port (``ops/nlp/{text,indexers,stupid_backoff,
corenlp}.py``, ``ops/learning/lda.py``, ``ops/util/vectors.py::Sparsify``,
``pipelines/stupid_backoff.py`` and the CLI's ``stupid-backoff``),
mirroring ``tests/ops/test_nlp.py`` and held to the JAX package on the
same inputs.

Bounds: every host-Python result (n-gram counts and their order, ranks,
packed keys, Stupid Backoff scores, lemmas, extracted n-grams, CSR rows)
exactly equal to the JAX package's; LDA's projection ≤ 1e-5 relative to
the JAX package's (both eigendecompose in float64 on the host and store
float32; read 0) and its applied projection ≤ 1e-5 relative (read
5.6e-8).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.data.dataset import ObjectDataset as JObjectDataset
from keystone_tpu.ops import nlp as jnlp
from keystone_tpu.ops.learning.lda import LinearDiscriminantAnalysis as JLDA
from keystone_tpu.ops.util.vectors import Sparsify as JSparsify
from keystone_tpu.pipelines import stupid_backoff as jstupid
from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
from keystone_tpu_torch.ops import nlp
from keystone_tpu_torch.ops.learning.lda import LinearDiscriminantAnalysis
from keystone_tpu_torch.ops.nlp import (
    NaiveBitPackIndexer,
    NGramIndexer,
    NGramsCounts,
    NGramsFeaturizer,
    StupidBackoffEstimator,
    Tokenizer,
    WordFrequencyEncoder,
)
from keystone_tpu_torch.ops.nlp.corenlp import ENTITY_TAG, CoreNLPFeatureExtractor, lemmatize
from keystone_tpu_torch.ops.util.vectors import Sparsify
from keystone_tpu_torch.pipelines import stupid_backoff
from keystone_tpu_torch.workflow.executor import PipelineEnv

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GOLD = REPO / "tests" / "fixtures" / "corenlp_lemma_gold.json"


@pytest.fixture(autouse=True)
def _fresh_port_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def test_exports_match_the_jax_package():
    assert nlp.__all__ == jnlp.__all__
    assert all(hasattr(nlp, name) for name in nlp.__all__)


# ------------------------------------------------------------- counting


@pytest.mark.parametrize("mode", ["default", "no_add"])
def test_ngrams_counts_equal_the_jax_package_with_tied_counts_in_order(mode):
    lines = [[("a",), ("b",), ("c",)], [("c",), ("a",)], [("d",), ("b",)], [("e",)]]
    got = NGramsCounts(mode)(ObjectDataset(lines))
    want = jnlp.NGramsCounts(mode)(JObjectDataset(lines))
    assert got == want
    if mode == "default":
        # Counts descending; the tied ones keep their first-seen order.
        assert got == [(("a",), 2), (("b",), 2), (("c",), 2), (("d",), 1), (("e",), 1)]
    else:
        assert [k for k, _ in got] == [("a",), ("b",), ("c",), ("d",), ("e",)]
    with pytest.raises(ValueError, match="mode"):
        NGramsCounts("sum")


def test_ngrams_counts_read_a_pipeline_result_and_an_iterable():
    text = Tokenizer().apply_batch(ObjectDataset(["a b a", "b a c"]))
    result = NGramsFeaturizer([1]).to_pipeline()(text)
    assert NGramsCounts()(result) == [(("a",), 3), (("b",), 2), (("c",), 1)]
    assert NGramsCounts()([[("x",)], [("x",), ("y",)]]) == [(("x",), 2), (("y",), 1)]


def test_word_frequency_encoder_ranks_equal_the_jax_package():
    lines = [["a", "b", "a"], ["a", "c"], ["d", "c", "b"]]
    enc = WordFrequencyEncoder().fit(ObjectDataset(lines))
    jenc = jnlp.WordFrequencyEncoder().fit(JObjectDataset(lines))
    assert enc.word_index == jenc.word_index == {"a": 0, "b": 1, "c": 2, "d": 3}
    assert enc.unigram_counts == jenc.unigram_counts == {0: 3, 1: 2, 2: 2, 3: 1}
    assert enc.apply(["a", "b", "zzz"]) == [0, 1, -1]
    out = enc.apply_batch(ObjectDataset(lines)).collect()
    assert out == jenc.apply_batch(JObjectDataset(lines)).collect()


# ------------------------------------------------------------- indexers


@pytest.mark.parametrize("ngram", [(3,), (3, 7), (3, 7, 11), (0, 0, 0), ((1 << 20) - 1, 5, 9)])
def test_bitpack_keys_equal_the_jax_package_and_round_trip(ngram):
    idx, jidx = NaiveBitPackIndexer(), jnlp.NaiveBitPackIndexer()
    packed = idx.pack(ngram)
    assert packed == jidx.pack(ngram) and 0 <= packed < 2**64
    assert idx.ngram_order(packed) == len(ngram)
    assert [idx.unpack(packed, p) for p in range(len(ngram))] == list(ngram)
    if len(ngram) > 1:
        for strip in ("remove_farthest_word", "remove_current_word"):
            got = getattr(idx, strip)(packed)
            assert got == getattr(jidx, strip)(packed)
        assert [idx.unpack(idx.remove_farthest_word(packed), p) for p in range(len(ngram) - 1)] \
            == list(ngram[1:])
        assert [idx.unpack(idx.remove_current_word(packed), p) for p in range(len(ngram) - 1)] \
            == list(ngram[:-1])


def test_indexers_reject_what_they_cannot_pack():
    idx = NaiveBitPackIndexer()
    with pytest.raises(ValueError, match="2\\^20"):
        idx.pack([-1, 2])
    with pytest.raises(ValueError, match="order"):
        idx.pack([1, 2, 3, 4])
    tup = NGramIndexer()
    assert tup.pack([1, 2, 3]) == (1, 2, 3)
    assert tup.remove_farthest_word((1, 2, 3)) == (2, 3)
    assert tup.remove_current_word((1, 2, 3)) == (1, 2)
    assert tup.ngram_order((1, 2)) == 2 and tup.unpack((1, 2), 1) == 2


# ------------------------------------------------------------- stupid backoff


@pytest.mark.parametrize("indexer", [NGramIndexer, NaiveBitPackIndexer])
def test_stupid_backoff_scores_the_hand_checked_corpus(indexer):
    """'a a b': unigrams a:2 b:1, bigrams (a,a):1, (a,b):1."""
    model = StupidBackoffEstimator({0: 2, 1: 1}, indexer=indexer()).fit(
        [((0, 0), 1), ((0, 1), 1)])
    np.testing.assert_allclose(model.score((0, 0)), 0.5)
    np.testing.assert_allclose(model.score((0, 1)), 0.5)
    np.testing.assert_allclose(model.score((1, 0)), 0.4 * 2 / 3)
    np.testing.assert_allclose(model.score((0, 0, 1)), 0.4 * 0.5)
    if indexer is NaiveBitPackIndexer:
        np.testing.assert_allclose(model.score(indexer().pack((0, 1))), 0.5)
    with pytest.raises(NotImplementedError):
        model.apply((0, 1))


def test_stupid_backoff_rejects_a_score_outside_the_unit_interval():
    # A bigram counted more often than its context word: the score 2/1
    # breaks the [0, 1] contract, which the fit asserts.
    with pytest.raises(AssertionError, match="not in"):
        StupidBackoffEstimator({0: 1, 1: 1}).fit([((0, 1), 2)])


def test_stupid_backoff_model_equals_the_jax_package_on_the_synthetic_corpus():
    lines = stupid_backoff._synthetic_corpus()
    assert lines == jstupid._synthetic_corpus()
    model = stupid_backoff.fit_language_model(lines)
    want = jstupid.fit_language_model(lines)
    assert model.scores == want.scores
    assert model.unigram_counts == want.unigram_counts
    assert model.ngram_counts == want.ngram_counts
    assert model.num_tokens == want.num_tokens
    assert all(0.0 <= s <= 1.0 for s in model.scores.values())
    for ngram in [(0, 1), (3, 9, 4), (499, 498), (7, 7, 7)]:
        assert model.score(ngram) == want.score(ngram)


def test_stupid_backoff_run_and_cli(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the cat sat\nthe cat ran\n\na dog sat\n")
    out = stupid_backoff.run(stupid_backoff.StupidBackoffConfig(train_data=str(corpus)), device=CPU)
    want = jstupid.run(jstupid.StupidBackoffConfig(train_data=str(corpus)))
    assert out["model"].scores == want["model"].scores
    assert (out["num_tokens"], out["vocab_size"]) == (9, 6)
    assert out["num_ngrams"] == len(want["model"].scores)
    synthetic = stupid_backoff.run(stupid_backoff.StupidBackoffConfig(), device=CPU)
    line = json.loads(subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "stupid-backoff", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True).stdout.splitlines()[-1])
    assert line["workload"] == "stupid-backoff"
    assert (line["num_tokens"], line["vocab_size"], line["num_ngrams"]) == (
        synthetic["num_tokens"], synthetic["vocab_size"], synthetic["num_ngrams"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stupid_backoff.run(stupid_backoff.StupidBackoffConfig(train_data=str(corpus)))


# ------------------------------------------------------------- corenlp


def test_lemmatizer_equals_the_jax_package_on_the_gold_fixture():
    from keystone_tpu.ops.nlp.corenlp import lemmatize as jlemmatize

    gold = json.loads(GOLD.read_text())
    assert len(gold) >= 300
    assert [lemmatize(w) for w in gold] == [jlemmatize(w) for w in gold]
    # The JAX package's bound is 95%; both read every one of the 337 words
    # (chip_smoke.py's stupid_backoff phase holds the card machine to this).
    assert sum(lemmatize(w) == g for w, g in gold.items()) == len(gold) == 337
    for word, lemma in (("studies", "study"), ("running", "run"), ("children", "child"),
                        ("walked", "walk"), ("glasses", "glass")):
        assert lemmatize(word) == lemma


@pytest.mark.parametrize("text,orders", [
    ("The cats were running. Dogs barked loudly!", [1, 2]),
    ("Yesterday we visited Paris together.", [1]),
    ("Yesterday we visited Qozvix together.", [1]),
    ("John likes cake and he lives in Florida", [1, 2, 3]),
    ("jumping snakes lakes oceans hunted", [1, 2, 3]),
    ("Mark the boxes carefully. We told Mark about it.", [1, 2]),
    ("a b c d", [1, 2, 3]),
])
def test_corenlp_extractor_equals_the_jax_package(text, orders):
    from keystone_tpu.ops.nlp.corenlp import CoreNLPFeatureExtractor as JExtractor

    got = CoreNLPFeatureExtractor(orders).apply(text)
    assert got == JExtractor(orders).apply(text)


def test_corenlp_extractor_contract():
    ext = CoreNLPFeatureExtractor(orders=[1, 2])
    out = ext.apply("The cats were running. Dogs barked loudly!")
    assert {"cat", "be", "run", "dog", "bark", "the cat"} <= set(out)
    assert "run dog" not in out
    out = CoreNLPFeatureExtractor([1]).apply("Yesterday we visited Qozvix together.")
    assert ENTITY_TAG in out and "qozvix" not in out
    out = CoreNLPFeatureExtractor([1]).apply("Mark the boxes carefully.")
    assert "mark" in out and "PERSON" not in out


# ------------------------------------------------------------- LDA, Sparsify


def _lda_problem():
    rng = np.random.default_rng(0)
    x = np.vstack([rng.normal(loc=c, size=(60, 4)) for c in ([0, 0, 0, 0], [4, 1, 0, 2], [1, 5, 3, 0])])
    y = np.repeat(np.arange(3), 60).astype(np.int32)
    return x.astype(np.float32), y


def test_lda_equals_the_jax_package():
    x, y = _lda_problem()
    model = LinearDiscriminantAnalysis(2, device=CPU).fit(ArrayDataset(x, device=CPU),
                                                          ArrayDataset(y, device=CPU))
    jmodel = JLDA(2).fit(JArrayDataset(x), JArrayDataset(y))
    w = model.weights.numpy()
    want = np.asarray(jmodel.weights)
    assert w.shape == (4, 2) and w.dtype == np.float32
    assert np.linalg.norm(w - want) <= 1e-5 * np.linalg.norm(want)
    proj = model.apply_batch(ArrayDataset(x, device=CPU)).data.numpy()
    jproj = np.asarray(jmodel.apply_batch(JArrayDataset(x)).data)
    assert np.linalg.norm(proj - jproj) <= 1e-5 * np.linalg.norm(jproj)
    # The first discriminant separates the classes.
    means = [proj[y == c, 0].mean() for c in range(3)]
    assert len({round(m, 3) for m in means}) == 3


def test_sparsify_rows_equal_the_jax_package():
    x = np.array([[0.0, 1.5, 0.0], [2.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    got = Sparsify().apply_batch(ArrayDataset(x, num_examples=2, device=CPU)).collect()
    want = JSparsify().apply_batch(JArrayDataset(x, num_examples=2)).collect()
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape == (1, 3) and (a != b).nnz == 0
    rows = Sparsify().apply_batch(ObjectDataset([x[0], torch.from_numpy(x[1])])).collect()
    assert [r.toarray().tolist() for r in rows] == [[x[0].tolist()], [x[1].tolist()]]
