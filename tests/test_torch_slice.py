"""Port parity for the whole slice: text → hashing-TF → block least
squares (block-sparse and dense in-core paths) → predictions, in
``keystone_tpu_torch`` on the CPU against ``keystone_tpu``.

Tolerances (relative Frobenius): 1e-5 on the ELL / Gram / BCD pieces
and on the block-sparse path's weights and scores (measured 2.1e-6 and
9.6e-7). The dense in-core and densify paths compare at ``SOLVE_TOL`` =
1e-4: their per-block fp32 Gram products over the dense matrix and
Cholesky solves round in another order in XLA (on an 8-device CPU mesh)
than in PyTorch's BLAS/LAPACK, and the measured
weight difference, 9.5e-6 (scores 4.0e-6), leaves too thin a margin
under 1e-5 for a change of BLAS threading.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.evaluation.multiclass import MulticlassClassifierEvaluator as JEvaluator
from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JEstimator
from keystone_tpu.ops.nlp import text as jtext
from keystone_tpu.ops.util.labels import ClassLabelIndicators as JIndicators
from keystone_tpu.ops.util.labels import MaxClassifier as JMax
from keystone_tpu.ops.util.vectors import Densify as JDensify
from keystone_tpu.parallel import linalg as jlinalg
from keystone_tpu_torch.convert import mapper_from_numpy
from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.nlp import text as ttext
from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.ops.util.vectors import Densify
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.workflow.executor import PipelineEnv

TOL = 1e-5
SOLVE_TOL = 1e-4
CPU = torch.device("cpu")
N_TOPICS, DOCS, K, D, BLOCK, REG = 32, 16, 4, 512, 128, 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def topic_corpus(topics, docs_per_topic, seed, vocab_per_topic=12):
    """The block-sparse bench corpus: topic-grouped documents of 5–14
    tokens from a 12-word vocabulary per topic; label = topic % K."""
    rng = np.random.RandomState(seed)
    docs, labels = [], []
    for topic in range(topics):
        vocab = [f"t{topic}w{j}" for j in range(vocab_per_topic)]
        for _ in range(docs_per_topic):
            length = 5 + int(rng.randint(0, 10))
            docs.append(" ".join(vocab[int(rng.randint(0, vocab_per_topic))] for _ in range(length)))
            labels.append(topic % K)
    return docs, np.asarray(labels, np.int32)


def _featurizer(mod):
    return mod.Trim().to_pipeline().then(mod.LowerCase()).then(mod.Tokenizer()).then(
        mod.HashingTF(D)
    )


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


@pytest.fixture
def slice_env(monkeypatch):
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_BLOCK", "16x16")
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_THRESHOLD", "0.5")
    train, train_labels = topic_corpus(N_TOPICS, DOCS, 11)
    test, test_labels = topic_corpus(N_TOPICS, 4, 12)
    return train, train_labels, test, test_labels


def _fit_both(train, train_labels, jax_data=None, torch_data=None):
    j_rows = _featurizer(jtext)(train).get() if jax_data is None else jax_data
    j_y = JIndicators(K)(JArrayDataset(train_labels)).get()
    j_model = JEstimator(BLOCK, num_iter=1, reg=REG).fit(j_rows, j_y)
    t_rows = _featurizer(ttext)(train).get() if torch_data is None else torch_data
    t_y = ClassLabelIndicators(K)(ArrayDataset(train_labels, device=CPU)).get()
    t_model = BlockLeastSquaresEstimator(BLOCK, num_iter=1, reg=REG, device=CPU).fit(t_rows, t_y)
    return j_model, t_model


def _assert_models_agree(j_model, t_model, test, test_labels, tol):
    for name in ("weights", "intercept", "feature_mean"):
        got = getattr(t_model, name).numpy()
        want = np.asarray(getattr(j_model, name))
        assert got.shape == want.shape, name
        assert _rel(got, want) <= tol, (name, _rel(got, want))
    j_scores = np.asarray((_featurizer(jtext).then(JDensify()).then(j_model))(test).get().data)
    t_scores = (_featurizer(ttext).then(Densify(device=CPU)).then(t_model))(test).get().data
    assert _rel(t_scores.numpy(), j_scores) <= tol
    j_pred = (_featurizer(jtext).then(JDensify()).then(j_model) >> JMax())(test).get()
    t_pred = (_featurizer(ttext).then(Densify(device=CPU)).then(t_model) >> MaxClassifier())(
        test
    ).get()
    np.testing.assert_array_equal(t_pred.data.numpy(), np.asarray(j_pred.data)[: len(test)])
    j_err = JEvaluator(K).evaluate(j_pred, test_labels).total_error
    t_err = MulticlassClassifierEvaluator(K).evaluate(t_pred, test_labels).total_error
    assert t_err == j_err
    return t_err


def test_slice_blocksparse_path_matches_jax(slice_env, monkeypatch):
    from keystone_tpu.ops.pallas import blocksparse as jbs
    from keystone_tpu_torch.ops.cuda import blocksparse as tbs

    train, train_labels, test, test_labels = slice_env
    calls = {"jax": 0, "torch": 0}
    j_totals, t_totals = jbs.bsr_gram_totals, tbs.bsr_gram_totals

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        return wrapped

    monkeypatch.setattr(jbs, "bsr_gram_totals", count("jax", j_totals))
    monkeypatch.setattr(tbs, "bsr_gram_totals", count("torch", t_totals))
    j_model, t_model = _fit_both(train, train_labels)
    assert calls == {"jax": 1, "torch": 1}  # both took the sparse path
    err = _assert_models_agree(j_model, t_model, test, test_labels, TOL)
    assert err < 0.2


def test_slice_dense_in_core_path_matches_jax(slice_env, monkeypatch):
    train, train_labels, test, test_labels = slice_env
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE", "off")
    dense = JDensify().apply_batch(_featurizer(jtext)(train).get()).data
    j_model, t_model = _fit_both(
        train, train_labels,
        jax_data=JArrayDataset(dense),
        torch_data=ArrayDataset(torch.from_numpy(dense)),
    )
    _assert_models_agree(j_model, t_model, test, test_labels, SOLVE_TOL)


def test_csr_rows_densify_path_matches_jax(slice_env, monkeypatch):
    train, train_labels, test, test_labels = slice_env
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_THRESHOLD", "0.001")  # too dense → densify
    j_model, t_model = _fit_both(train, train_labels)
    _assert_models_agree(j_model, t_model, test, test_labels, SOLVE_TOL)


def test_gram_finish_and_bcd_from_gram_match_jax():
    rng = np.random.RandomState(4)
    n, d, k = 300, 96, 3
    x = rng.randn(n, d).astype(np.float32) * rng.rand(d).astype(np.float32)
    y = rng.randn(n, k).astype(np.float32)
    j_carry = jlinalg.gram_stream_step(jlinalg.gram_stream_init(d, k), x, y)
    t_carry = tlinalg.gram_stream_step(
        tlinalg.gram_stream_init(d, k, CPU), torch.from_numpy(x), torch.from_numpy(y)
    )
    for got, want in zip(t_carry, j_carry):
        assert _rel(got.numpy(), np.asarray(want)) <= TOL
    j_fin = jlinalg.gram_stream_finish(j_carry, n)
    t_fin = tlinalg.gram_stream_finish(t_carry, n)
    for got, want in zip(t_fin, j_fin):
        assert _rel(got.numpy(), np.asarray(want)) <= TOL
    for epochs, block in ((1, 32), (2, 48), (1, 96)):
        w_j = jlinalg.bcd_from_gram(j_fin[0], j_fin[1], reg=0.5, num_epochs=epochs, block_size=block)
        w_t = tlinalg.bcd_from_gram(t_fin[0], t_fin[1], reg=0.5, num_epochs=epochs, block_size=block)
        assert _rel(w_t.numpy(), np.asarray(w_j)) <= TOL
    s_j = jlinalg.solve_spd(j_fin[0], j_fin[1], reg=0.5)
    s_t = tlinalg.solve_spd(t_fin[0], t_fin[1], reg=0.5)
    assert _rel(s_t.numpy(), np.asarray(s_j)) <= TOL


def test_block_coordinate_descent_matches_bcd_from_gram():
    rng = np.random.RandomState(8)
    n, d, k = 200, 64, 2
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    y = torch.from_numpy(rng.randn(n, k).astype(np.float32))
    xc, yc = x - x.mean(0), y - y.mean(0)
    w = tlinalg.block_coordinate_descent(xc, yc, reg=0.3, num_epochs=2, block_size=16)
    w_gram = tlinalg.bcd_from_gram(xc.T @ xc, xc.T @ yc, reg=0.3, num_epochs=2, block_size=16)
    assert _rel(w.numpy(), w_gram.numpy()) <= TOL


@pytest.mark.parametrize("n", [1, 7, 8, 29])
def test_mm_t_sums_row_chunks(monkeypatch, n):
    monkeypatch.setattr(tlinalg, "ROW_CHUNK", 8)
    rng = np.random.RandomState(n)
    a = torch.from_numpy(rng.randn(n, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    assert _rel(tlinalg.mm_t(a, b).numpy(), a.numpy().T @ b.numpy()) <= TOL


def test_mapper_from_numpy_reproduces_jax_predictions(slice_env):
    train, train_labels, test, _ = slice_env
    j_rows = _featurizer(jtext)(train).get()
    j_model = JEstimator(BLOCK, num_iter=1, reg=REG).fit(
        j_rows, JIndicators(K)(JArrayDataset(train_labels)).get()
    )
    mapper = mapper_from_numpy(
        np.asarray(j_model.weights), j_model.block_size,
        intercept=np.asarray(j_model.intercept),
        feature_mean=np.asarray(j_model.feature_mean), device=CPU,
    )
    x = JDensify().apply_batch(_featurizer(jtext)(test).get()).data
    want = np.asarray(j_model.apply_arrays(x))
    got = mapper.apply_arrays(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= TOL


def test_pipeline_api_fit_once_and_fitted_pipeline(slice_env):
    train, train_labels, test, _ = slice_env
    y = ClassLabelIndicators(K)(ArrayDataset(train_labels, device=CPU)).get()
    est = BlockLeastSquaresEstimator(BLOCK, num_iter=1, reg=REG, device=CPU)
    fits = []
    fit = est.fit

    def counting_fit(data, labels):
        fits.append(1)
        return fit(data, labels)

    est.fit = counting_fit
    pipe = _featurizer(ttext).then(Densify(device=CPU)).then_label_estimator(est, train, y) >> (
        MaxClassifier()
    )
    first = pipe(test).get().data
    second = pipe(test).get().data
    fitted = pipe.fit()
    assert len(fits) == 1  # an estimator bound to data fits once
    torch.testing.assert_close(first, second)
    torch.testing.assert_close(fitted.apply_batch(ObjectDataset(test)).data, first)
    assert int(fitted.apply(test[0])) == int(first[0])
