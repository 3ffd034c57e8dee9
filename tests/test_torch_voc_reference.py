"""The benchmark's VOC 2007 SIFT + Fisher-vector configuration
(``kbench/configs/voc_sift_fisher.json``) at a tiny size on the CPU: the
port's fit, ``pipelines/voc.py::build_pipeline(...).fit()`` as the cell
runs it (``kbench/systems/voc_sift_fisher.py``), against the plain
reference (``kbench/reference/voc_sift_fisher.py``), both loaded by path
as the benchmark loads them.

Tiny: 24 images of 64×64 (734 descriptors each), 8 PCA dimensions, 4
Gaussians, 2,000 PCA and GMM samples (83 an image), 64-wide blocks.
"""

import ast
import copy

import numpy as np
import pytest
import torch

from kbench.harness.checks import score_gap
from kbench.harness.layout import KBENCH_DIR, Layout

TINY = dict(train_rows=24, image_shape=[64, 64, 3], desc_dim=8, vocab_size=4, num_pca_samples=2000,
            num_gmm_samples=2000, block_size=64, check={"train_rows": 8, "heldout_rows": 8})
SEEDS = [2**31 + 5, 3_000_000_019]
CPU = torch.device("cpu")

#: The port against the float64 reference, score_gap of the training
#: sample and the held-out images. Read 1.3e-6–3.8e-5 (train) and
#: 3.1e-6–6.3e-5 (held out) on these and five more seeds. 5e-4 holds the
#: worst of them with 8× room. (With float32 SIFT one of those seeds read
#: 7.8e-4 / 1.8e-3: at 8 of 128 dimensions its PCA subspace is
#: near-degenerate, and descriptor values one quantization step off
#: turned it.)
PORT_TOL = 5e-4


@pytest.fixture(autouse=True)
def _fresh_env(monkeypatch):
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", "off")
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _parts():
    layout = Layout()
    config = layout.load_json(layout.bench_dir / "configs" / "voc_sift_fisher.json")
    config.update(copy.deepcopy(TINY))
    return config, layout.module("systems", "voc_sift_fisher"), layout.module("reference", "voc_sift_fisher")


def _fit(seed):
    config, system, reference = _parts()
    data = system.make_data(config, seed, CPU)
    fitted = system.fit(config, data, CPU, seed, None)
    sets = system.eval_sets(config, data, seed)
    got = {name: system.apply(fitted, x).to(torch.float64) for name, x in sets.items()}
    return config, system, reference, data, sets, got


@pytest.mark.parametrize("seed", SEEDS)
def test_port_scores_agree_with_the_fp64_reference(seed):
    config, system, reference, data, sets, got = _fit(seed)
    want = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "fp64", CPU)
    gaps = {name: score_gap(got[name], want[name]) for name in sets}
    assert set(gaps) == {"train", "heldout"} and all(g < PORT_TOL for g in gaps.values()), gaps
    assert got["train"].shape == (8, int(config["num_classes"]))


@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_separates_from_the_port(seed):
    """The control (TF32 products) reads at least 10× as far from the
    port as the reference held in IEEE float32 does."""
    config, system, reference, data, sets, got = _fit(seed)
    ieee = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "fp32", CPU)
    tf32 = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "tf32", CPU)
    for name in sets:
        assert score_gap(tf32[name], got[name]) >= 10 * score_gap(ieee[name], got[name]), name


@pytest.mark.parametrize("seed", SEEDS)
def test_iteration_counts_and_seed_rows_equal_the_references(seed):
    config, system, reference, data, sets, got = _fit(seed)
    program = data["anchors"]["program"]
    k = int(config["vocab_size"])
    reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "fp64", CPU)
    report = data["anchors"]["report_fp64"]
    assert (report["lloyd_iterations"], report["em_iterations"]) == (
        program["lloyd_iterations"], program["em_iterations"])
    assert program["lloyd_iterations"] == config["gmm"]["lloyd_iterations"] and program["em_iterations"] > 1
    assert report["seed_rows_followed"] == k and report["seed_worst_miss"] == 0.0
    # EM starts from the reference's own moments; the port's, taken in
    # float64, are the same start.
    assert max(report["init_gaps"]) < 1e-4
    # With no rows given, the reference's own D² draws are the port's rows.
    own = {"x": data["x"], "labels": data["labels"], "anchors": {}}
    reference.fit_and_score(config, own, sets, seed, "fp64", CPU)
    np.testing.assert_array_equal(own["anchors"]["fp64"]["seed_rows"], program["seed_rows"])
    assert own["anchors"]["fp64"]["em_iterations"] == program["em_iterations"]
    assert report["em_near_ties"] == [] and own["anchors"]["report_fp64"]["em_near_ties"] == []


def test_a_program_that_seeds_wrongly_reads_far_from_the_reference(monkeypatch):
    """Seed rows that are not D² draws of the same uniform numbers (each
    the next row of the sample) are not followed: the reference seeds on
    its own and the scores part."""
    from keystone_tpu_torch.ops.learning import kmeans

    original = kmeans._kmeanspp_rows
    monkeypatch.setattr(kmeans, "_kmeanspp_rows", lambda x, k, seed: (original(x, k, seed) + 1) % len(x))
    seed = SEEDS[0]
    config, system, reference, data, sets, got = _fit(seed)
    want = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "fp64", CPU)
    assert data["anchors"]["report_fp64"]["seed_diverged_at"] == 0
    assert max(score_gap(got[name], want[name]) for name in sets) > 10 * PORT_TOL


def test_a_program_whose_em_starts_elsewhere_is_not_followed(monkeypatch):
    """A mixture fit that skips the Lloyd step starts EM from moments far
    from the reference's; the reference starts from its own and the
    scores part."""
    from keystone_tpu_torch.ops.learning import gmm, kmeans

    class NoLloyd(kmeans.KMeansPlusPlusEstimator):
        def __init__(self, num_means, max_iterations, **kw):
            super().__init__(num_means, 0, **kw)

    monkeypatch.setattr(gmm, "KMeansPlusPlusEstimator", NoLloyd)
    seed = SEEDS[0]
    config, system, reference, data, sets, got = _fit(seed)
    want = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "fp64", CPU)
    report = data["anchors"]["report_fp64"]
    assert min(report["init_gaps"]) > 1e-2
    # Read 1.0e-2 on this seed at this size (EM from the two starts ran
    # 12 and 13 iterations).
    assert max(score_gap(got[name], want[name]) for name in sets) > PORT_TOL


def test_the_cell_refuses_a_port_that_records_no_seed_rows(monkeypatch):
    """The check needs the mixture's seed rows; a port without them fails
    at its first fit instead of reading far from the reference."""
    from keystone_tpu_torch.ops.learning import gmm

    original = gmm.GaussianMixtureModelEstimator.fit

    def bare(self, data):
        model = original(self, data)
        model.fit_info = None
        return model

    monkeypatch.setattr(gmm.GaussianMixtureModelEstimator, "fit", bare)
    config, system, _ = _parts()
    data = system.make_data(config, SEEDS[0], CPU)
    with pytest.raises(RuntimeError, match="seed rows"):
        system.fit(config, data, CPU, SEEDS[0], None)


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse((KBENCH_DIR / "reference" / "voc_sift_fisher.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "typing", "contextlib", "numpy", "torch", "kbench"}, tops


@pytest.mark.parametrize("slack, follows", [(0.0, False), (1e9, True)])
def test_em_stop_near_ties_follow_the_given_fit_within_the_slack(slack, follows, monkeypatch):
    """With every gain counted a near-tie the reference stops where the
    given fit stopped; with none it keeps its own stop."""
    config, system, reference, data, sets, got = _fit(SEEDS[0])
    program = data["anchors"]["program"]
    monkeypatch.setattr(reference, "EM_STOP_SLACK", slack)
    given = dict(program, em_updates=program["em_updates"] - 2)
    inputs = {"x": data["x"], "labels": data["labels"], "anchors": {"program": given}}
    reference.fit_and_score(config, inputs, sets, SEEDS[0], "fp64", CPU)
    report = inputs["anchors"]["report_fp64"]
    want = given["em_updates"] if follows else program["em_updates"]
    assert (report["em_updates"], report["em_iterations"]) == (want, want + 1)
    assert bool(report["em_near_ties"]) == follows


def test_later_seed_rows_one_past_the_references_are_refused_at_a_full_size_share():
    """At 2·10⁶ rows a row holds on average 5e-7 of the D² weights, below
    ``SEED_CDF_SLACK``, as at the cell's 10⁶. Given rows that keep row 0
    and take each later centre one row past the reference's own are
    followed only while the same uniform number falls within the slack of
    the given row's share; from the first draw where it does not, the
    reference draws its own rows."""
    _, _, reference = _parts()
    n, k, seed = 2_000_000, 64, 3
    assert 1.0 / n < reference.SEED_CDF_SLACK
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(n, 2)))
    own = reference.kmeanspp_rows(x, k, seed, "fp64", None, {})
    given = own.copy()
    given[1:] = (own[1:] + 1) % n
    report = {}
    rows = reference.kmeanspp_rows(x, k, seed, "fp64", given, report)
    j = report["seed_diverged_at"]
    assert 1 <= j < k
    np.testing.assert_array_equal(rows[:j], given[:j])
    assert rows[j] != given[j]
    assert report["seed_rows_followed"] == j and report["seed_worst_miss"] <= reference.SEED_CDF_SLACK
