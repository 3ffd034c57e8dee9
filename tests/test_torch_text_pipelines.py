"""The text pipelines of the port on the CPU (``pipelines/text.py``,
``data/loaders/text.py``, ``ops/util/sparse.py``,
``evaluation/binary.py``): mirrors of ``tests/pipelines/test_text.py``
on the same corpora, and parity with the JAX package — the same feature
space (ties included), the same loaded records, the same binary metrics
and the same predicted labels — plus the two CLI workloads.

Bounds: exact equality throughout (feature spaces, records, metrics,
predicted labels); the Newsgroups model's log-posteriors ≤ 1e-5 relative
of the JAX model's.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ObjectDataset as JObjectDataset
from keystone_tpu.data.loaders import text as jloaders
from keystone_tpu.evaluation.binary import BinaryClassifierEvaluator as JBinary
from keystone_tpu.ops.util import sparse as jsparse
from keystone_tpu.pipelines import text as jtext
from keystone_tpu.workflow import executor as jexec
from keystone_tpu_torch.data.dataset import ObjectDataset
from keystone_tpu_torch.data.loaders import text as loaders
from keystone_tpu_torch.evaluation import BinaryClassificationMetrics, BinaryClassifierEvaluator
from keystone_tpu_torch.ops.util import sparse as tsparse
from keystone_tpu_torch.pipelines import text
from keystone_tpu_torch.workflow import executor as texec

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

POS_WORDS = ["great", "excellent", "love", "wonderful", "amazing", "perfect"]
NEG_WORDS = ["terrible", "awful", "hate", "broken", "worst", "refund"]
FILLER = ["the", "product", "arrived", "yesterday", "and", "it", "was", "box"]


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "profile-store.jsonl"))
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()
    yield
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()


def make_reviews(n, seed):
    """``tests/pipelines/test_text.py``'s generator."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        pos = rng.random() < 0.5
        words = list(rng.choice(POS_WORDS if pos else NEG_WORDS, size=4)) + list(
            rng.choice(FILLER, size=6)
        )
        rng.shuffle(words)
        rows.append({"reviewText": " ".join(words), "overall": 5.0 if pos else 1.0})
    return rows


def write_reviews(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def make_newsgroups(root):
    """``tests/pipelines/test_text.py``'s two-group corpus."""
    rng = np.random.default_rng(2)
    for cls, vocab in [
        ("comp.graphics", ["pixel", "render", "opengl", "shader"]),
        ("rec.autos", ["engine", "wheel", "brake", "clutch"]),
    ]:
        for split in ("train", "test"):
            d = root / split / cls
            d.mkdir(parents=True, exist_ok=True)
            for i in range(30 if split == "train" else 8):
                words = rng.choice(vocab, size=12)
                (d / f"doc{i}.txt").write_text(" ".join(words))


def _labels(result):
    data = result.get().data if hasattr(result, "get") else result.data
    return np.asarray(data.cpu() if isinstance(data, torch.Tensor) else data).ravel()


# ------------------------------------------------- mirrors of test_text.py


def test_amazon_reviews_pipeline(tmp_path):
    train_p, test_p = tmp_path / "train.json", tmp_path / "test.json"
    write_reviews(train_p, make_reviews(300, 0))
    write_reviews(test_p, make_reviews(80, 1))
    config = text.AmazonReviewsConfig(
        train_location=str(train_p), test_location=str(test_p), common_features=500, num_iters=30,
    )
    res = text.run_amazon(config, device=CPU)
    assert res["metrics"].accuracy > 0.9


def test_newsgroups_pipeline(tmp_path):
    make_newsgroups(tmp_path)
    config = text.NewsgroupsConfig(
        train_location=str(tmp_path / "train"), test_location=str(tmp_path / "test"),
        common_features=200,
    )
    res = text.run_newsgroups(config, device=CPU)
    assert res["metrics"].total_error < 0.1


def test_amazon_loader_threshold(tmp_path):
    p = tmp_path / "r.json"
    write_reviews(p, [{"reviewText": "ok", "overall": 4.0}, {"reviewText": "bad", "overall": 2.0}])
    data = loaders.load_amazon_reviews(str(p))
    assert data.labels.collect() == [1, 0]
    assert data.data.collect() == ["ok", "bad"]


@pytest.mark.parametrize("run", ["run_amazon", "run_newsgroups"])
def test_runs_without_train_location_raise_the_jax_message(run):
    config_cls = text.AmazonReviewsConfig if run == "run_amazon" else text.NewsgroupsConfig
    jconfig_cls = jtext.AmazonReviewsConfig if run == "run_amazon" else jtext.NewsgroupsConfig
    with pytest.raises(ValueError) as port:
        getattr(text, run)(config_cls(), device=CPU)
    with pytest.raises(ValueError) as ref:
        getattr(jtext, run)(jconfig_cls())
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------- parity with JAX


def test_amazon_predictions_equal_the_jax_pipelines(tmp_path):
    train_p, test_p = tmp_path / "train.json", tmp_path / "test.json"
    write_reviews(train_p, make_reviews(300, 0))
    write_reviews(test_p, make_reviews(80, 1))
    kw = dict(train_location=str(train_p), test_location=str(test_p), common_features=500, num_iters=30)
    ours = text.run_amazon(text.AmazonReviewsConfig(**kw), device=CPU)
    ref = jtext.run_amazon(jtext.AmazonReviewsConfig(**kw))
    test = loaders.load_amazon_reviews(str(test_p))
    np.testing.assert_array_equal(
        _labels(ours["pipeline"](test.data)), _labels(ref["pipeline"](JObjectDataset(test.data.collect())))
    )
    for field in ("tp", "fp", "tn", "fn"):
        assert getattr(ours["metrics"], field) == getattr(ref["metrics"], field)


def test_newsgroups_predictions_equal_the_jax_pipelines(tmp_path):
    make_newsgroups(tmp_path)
    kw = dict(train_location=str(tmp_path / "train"), test_location=str(tmp_path / "test"),
              common_features=200)
    ours = text.run_newsgroups(text.NewsgroupsConfig(**kw), device=CPU)
    ref = jtext.run_newsgroups(jtext.NewsgroupsConfig(**kw))
    test = loaders.load_newsgroups(str(tmp_path / "test"))
    np.testing.assert_array_equal(
        _labels(ours["pipeline"](test.data)), _labels(ref["pipeline"](JObjectDataset(test.data.collect())))
    )
    np.testing.assert_array_equal(ours["metrics"].confusion_matrix, ref["metrics"].confusion_matrix)


def test_newsgroups_model_matches_jax(tmp_path):
    from keystone_tpu.ops.learning.naive_bayes import NaiveBayesModel as JNBModel
    from keystone_tpu_torch.ops.learning.naive_bayes import NaiveBayesModel

    make_newsgroups(tmp_path)
    config = dict(n_grams=2, common_features=200)
    train = loaders.load_newsgroups(str(tmp_path / "train"))
    jtrain = jloaders.load_newsgroups(str(tmp_path / "train"))
    ours = text.build_newsgroups(text.NewsgroupsConfig(**config), train, device=CPU).fit()
    ref = jtext.build_newsgroups(jtext.NewsgroupsConfig(**config), jtrain).fit()

    def model(fitted, cls):
        ops = fitted.graph.operators.values()
        found = [m for op in ops for m in getattr(op, "members", (op,)) if isinstance(m, cls)]
        assert len(found) == 1
        return found[0]

    t, j = model(ours, NaiveBayesModel), model(ref, JNBModel)
    assert np.max(np.abs(t.pi.numpy() - np.asarray(j.pi))) <= 1e-5
    assert np.max(np.abs(t.theta.numpy() - np.asarray(j.theta))) <= 1e-5


def _docs(n=60, seed=3):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(30)]
    return [[(str(w), 1.0) for w in rng.choice(vocab, size=int(rng.integers(3, 12)))] for _ in range(n)]


@pytest.mark.parametrize("num_features", [1, 5, 17, 30, 100])
def test_common_sparse_features_equal_the_jax_space_ties_included(num_features):
    docs = _docs()
    ours = tsparse.CommonSparseFeatures(num_features).fit(ObjectDataset(docs))
    ref = jsparse.CommonSparseFeatures(num_features).fit(JObjectDataset(docs))
    assert list(ours.feature_space.items()) == list(ref.feature_space.items())
    for doc in docs[:10]:
        a, b = ours.apply(doc), ref.apply(doc)
        assert (a != b).nnz == 0 and a.shape == b.shape


def test_common_sparse_features_break_ties_by_first_appearance():
    docs = [[("b", 1.0), ("a", 1.0)], [("a", 1.0), ("c", 1.0)], [("c", 1.0), ("b", 1.0)]]
    ours = tsparse.CommonSparseFeatures(2).fit(ObjectDataset(docs))
    assert ours.feature_space == jsparse.CommonSparseFeatures(2).fit(JObjectDataset(docs)).feature_space
    assert list(ours.feature_space) == ["b", "a"]


def test_csr_rows_have_the_jax_arrays():
    """``utils/sparse.csr_row`` builds CSR directly; its arrays equal the
    JAX package's COO-built rows."""
    from keystone_tpu.utils.sparse import csr_row as jcsr_row
    from keystone_tpu_torch.utils.sparse import csr_row

    rng = np.random.default_rng(5)
    for size in (0, 1, 7, 60):
        values = {int(j): float(rng.random()) for j in rng.choice(500, size=size, replace=False)}
        a, b = csr_row(values, 500), jcsr_row(values, 500)
        assert a.shape == b.shape and a.has_sorted_indices == b.has_sorted_indices
        for name in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert getattr(a, name).dtype == getattr(b, name).dtype


def test_all_sparse_features_and_vectorizer_equal_jax():
    docs = _docs(20)
    ours = tsparse.AllSparseFeatures().fit(ObjectDataset(docs))
    ref = jsparse.AllSparseFeatures().fit(JObjectDataset(docs))
    assert list(ours.feature_space.items()) == list(ref.feature_space.items())
    pairs = [("w1", 2.0), ("unknown", 5.0), ("w1", 1.0), ("w3", 0.5)]
    assert (ours.apply(pairs) != ref.apply(pairs)).nnz == 0


def test_loaders_match_jax(tmp_path):
    rows = make_reviews(25, 4) + [{"reviewText": "meh", "overall": 3.5}, {"overall": 2.0}]
    p = tmp_path / "reviews.json"
    write_reviews(p, rows)
    with open(p, "a") as f:
        f.write("\n   \n")
    for threshold in (3.5, 4.0):
        ours = loaders.load_amazon_reviews(str(p), threshold)
        ref = jloaders.load_amazon_reviews(str(p), threshold)
        assert ours.labels.collect() == ref.labels.collect()
        assert ours.data.collect() == ref.data.collect()
    make_newsgroups(tmp_path / "ng")
    (tmp_path / "ng" / "train" / "not.a.group").mkdir()
    ours = loaders.load_newsgroups(str(tmp_path / "ng" / "train"))
    ref = jloaders.load_newsgroups(str(tmp_path / "ng" / "train"))
    assert ours.labels.collect() == ref.labels.collect()
    assert ours.data.collect() == ref.data.collect()
    assert loaders.NEWSGROUPS_CLASSES == jloaders.NEWSGROUPS_CLASSES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_evaluator_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pred, act = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    ours = BinaryClassifierEvaluator().evaluate(torch.as_tensor(pred), ObjectDataset(list(act)))
    ref = JBinary().evaluate(pred, JObjectDataset(list(act)))
    for name in ("tp", "fp", "tn", "fn", "accuracy", "error", "recall", "precision", "specificity"):
        assert getattr(ours, name) == getattr(ref, name)
    assert ours.f_score(0.5) == ref.f_score(0.5)
    assert ours.summary() == ref.summary()
    merged = ours.merge(ours)
    assert merged.tp == 2 * ours.tp


def test_binary_metrics_nan_on_empty_denominators():
    m = BinaryClassificationMetrics(0.0, 0.0, 3.0, 0.0)
    assert np.isnan(m.recall) and np.isnan(m.precision) and m.specificity == 1.0
    with pytest.raises(ValueError, match="length"):
        BinaryClassifierEvaluator().evaluate([1, 0], [1])


# ----------------------------------------------------------------- CLI


def test_cli_lists_the_text_workloads():
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "--list"], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    names = {line.split()[0] for line in out.splitlines() if line.strip()}
    assert {"amazon-reviews", "newsgroups"} <= names


def test_cli_runs_newsgroups_on_the_cpu(tmp_path):
    make_newsgroups(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "newsgroups",
         "--train-location", str(tmp_path / "train"), "--test-location", str(tmp_path / "test"),
         "--common-features", "200", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["workload"] == "newsgroups" and line["seconds"] > 0


def test_cli_without_train_location_exits_with_the_jax_message():
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "amazon-reviews", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "amazon-reviews needs --train-location" in proc.stderr
