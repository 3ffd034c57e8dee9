"""Port parity: the text featurizers of ``keystone_tpu_torch`` hash every
term to the same feature as ``keystone_tpu`` — CSR rows are identical."""

import numpy as np
import pytest

from keystone_tpu.data.dataset import ObjectDataset as JObjectDataset
from keystone_tpu.ops.nlp import text as jtext
from keystone_tpu_torch.data.dataset import ObjectDataset
from keystone_tpu_torch.ops.nlp import text as ttext
from keystone_tpu_torch.workflow.executor import PipelineEnv


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _docs(seed, n=40):
    rng = np.random.RandomState(seed)
    words = ["Alpha", "beta", "GAMMA", "δέλτα", "e_1", "zeta-2", "ηta", "x"]
    docs = []
    for _ in range(n):
        toks = [words[i] for i in rng.randint(0, len(words), size=rng.randint(0, 12))]
        docs.append("  " + rng.choice([" ", ", ", "; ", "\t"]).join(toks) + " ")
    return docs


def _assert_same_rows(a_rows, b_rows):
    assert len(a_rows) == len(b_rows)
    for a, b in zip(a_rows, b_rows):
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize(
    "term",
    ["", "a", "hello", "Ünïcødé", "x" * 300, 0, 7, -3, 2**40, ("a",), ("a", "b"),
     ("the", "quick", "fox"), (1, "b"), 3.5],
)
def test_term_hash_bit_identical(term):
    assert ttext.term_hash(term) == jtext.term_hash(term)


def test_hashing_tf_rows_identical():
    docs = _docs(0)

    def rows(mod, dataset_cls):
        feat = (
            mod.Trim().to_pipeline().then(mod.LowerCase()).then(mod.Tokenizer())
            .then(mod.HashingTF(257))
        )
        return feat(dataset_cls(docs)).get().collect()

    _assert_same_rows(rows(ttext, ObjectDataset), rows(jtext, JObjectDataset))


@pytest.mark.parametrize("orders", [(1,), (1, 2), (2, 3), (1, 2, 3)])
def test_ngrams_hashing_tf_identical_and_matches_unfused(orders):
    lines = [jtext.Tokenizer().apply(d.lower()) for d in _docs(1)]
    fused_t = [ttext.NGramsHashingTF(orders, 101).apply(t) for t in lines]
    fused_j = [jtext.NGramsHashingTF(orders, 101).apply(t) for t in lines]
    _assert_same_rows(fused_t, fused_j)
    unfused = [
        ttext.HashingTF(101).apply(ttext.NGramsFeaturizer(orders).apply(t)) for t in lines
    ]
    _assert_same_rows(fused_t, unfused)


def test_ngrams_and_term_frequency_match():
    tokens = ["a", "b", "a", "c", "b", "a"]
    for orders in ((1,), (1, 2, 3), (2,)):
        assert ttext.NGramsFeaturizer(orders).apply(tokens) == (
            jtext.NGramsFeaturizer(orders).apply(tokens)
        )
    assert ttext.TermFrequency(lambda c: c * 2).apply(tokens) == (
        jtext.TermFrequency(lambda c: c * 2).apply(tokens)
    )
    with pytest.raises(ValueError):
        ttext.NGramsFeaturizer((1, 3))


def test_block_sparse_features_identical(monkeypatch):
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_BLOCK", "4x8")
    lines = [jtext.Tokenizer().apply(d) for d in _docs(2, n=30)]
    rows = [jtext.HashingTF(64).apply(t) for t in lines]
    b_t = ttext.block_sparse_features(rows)
    b_j = jtext.block_sparse_features(rows)
    assert b_t.block_shape == b_j.block_shape == (4, 8)
    np.testing.assert_array_equal(b_t.indptr, b_j.indptr)
    np.testing.assert_array_equal(b_t.indices, b_j.indices)
    np.testing.assert_array_equal(b_t.blocks, b_j.blocks)
