"""The spans and the counter that the VOC SIFT + Fisher fit path opens and
counts, on the CPU, at the tiny size of ``test_torch_voc_reference.py``.

- ``sift:extract`` (``images``, ``descriptors``) round each image chunk
  of ``SIFTExtractor``;
- ``sample:draw`` (``items``, ``take``) round each ``ColumnSampler`` draw;
- ``pca:fit`` (``rows``) round each column PCA fit;
- ``fisher:encode`` (``images``) round each image chunk of ``FisherVector``;
- ``keystone_gmm_steps_total{step="seed_draw"|"lloyd"|"em"}``: one
  ``seed_draw`` a k-means++ centre, one ``lloyd`` a Lloyd iteration, one
  ``em`` an EM iteration, whether a session is open or not;
- ``kmeans:seed``, ``kmeans:lloyd`` and ``gmm:em`` as before.

``Pipeline.fit()`` also runs the plan's sample interpreter, which takes
up to 100 training images through the chain's prefix to let the column
PCA and the Fisher estimator choose their implementations: its SIFT,
sampler and PCA spans come on top of the fit's own.
"""

import copy
from collections import Counter

import pytest
import torch

from kbench.harness.layout import Layout
from keystone_tpu_torch.obs import names, spans
from keystone_tpu_torch.ops.images.fisher import FisherVector
from keystone_tpu_torch.ops.images.sift import SIFTExtractor

TINY = dict(train_rows=24, image_shape=[64, 64, 3], desc_dim=8, vocab_size=4, num_pca_samples=2000,
            num_gmm_samples=2000, block_size=64, check={"train_rows": 8, "heldout_rows": 8})
SEED = 2**31 + 5
CPU = torch.device("cpu")
STEPS = ("seed_draw", "lloyd", "em")


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
    system = layout.module("systems", "voc_sift_fisher")
    return config, system, system.make_data(config, SEED, CPU)


def _steps():
    counter = names.metric(names.GMM_STEPS)
    return {step: counter.value(step=step) for step in STEPS}


def _traced_fit():
    config, system, data = _parts()
    with spans.tracing_session("voc") as session:
        fitted = system.fit(config, data, CPU, SEED, None)
    return config, system, data, fitted, session, spans.recent_sessions()[-1]


def test_fit_spans_carry_the_configurations_counts():
    config, system, data, fitted, session, summary = _traced_fit()
    n = int(config["train_rows"])
    per_image = SIFTExtractor(scale_step=0).grid_counts(64, 64)
    take = int(config["num_pca_samples"]) // n
    found = {name: [s.attributes for s in session.spans() if s.name == name]
             for name in ("sift:extract", "sample:draw", "pca:fit", "fisher:encode")}
    # Every chunk's descriptors are its images' at every scale; the fit
    # takes every training image through SIFT.
    assert all(a["descriptors"] == a["images"] * sum(per_image) and a["images"] <= SIFTExtractor.image_chunk
               for a in found["sift:extract"])
    assert sum(a["images"] for a in found["sift:extract"]) >= n
    # Two samplers (PCA, GMM) in the plan's sample interpreter and two in
    # the fit, each over the training images, keeping samples // images.
    assert found["sample:draw"] == [{"items": n, "take": take}] * 4
    assert found["pca:fit"] == [{"rows": n * take}] * 2
    # The Fisher encoder runs once, after its mixture, over every image.
    assert found["fisher:encode"] == [{"images": n}] and n <= FisherVector.image_chunk
    counts = Counter(s.name for s in session.spans())
    assert counts["kmeans:seed"] == counts["kmeans:lloyd"] == counts["gmm:em"] == 1
    em = [s for s in session.spans() if s.name == "gmm:em"][0]
    info = data["anchors"]["program"]
    assert em.attributes["iterations"] == info["em_iterations"]
    series = {step: summary.counters.get(f"keystone_gmm_steps_total{{step={step}}}") for step in STEPS}
    assert series == {"seed_draw": int(config["vocab_size"]), "lloyd": int(config["gmm"]["lloyd_iterations"]),
                      "em": info["em_iterations"]}
    assert len(info["seed_rows"]) == int(config["vocab_size"])


def test_the_counter_counts_without_a_session():
    config, system, data = _parts()
    before = _steps()
    system.fit(config, data, CPU, SEED, None)
    after = _steps()
    info = data["anchors"]["program"]
    assert {s: after[s] - before[s] for s in STEPS} == {
        "seed_draw": int(config["vocab_size"]), "lloyd": 1, "em": info["em_iterations"]}
    assert spans.active_session() is None


def test_scores_are_bit_identical_with_tracing_on_and_off():
    config, system, data, fitted, session, summary = _traced_fit()
    sets = system.eval_sets(config, data, SEED)
    traced = {k: system.apply(fitted, v) for k, v in sets.items()}
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    PipelineEnv.reset()
    plain = system.fit(config, data, CPU, SEED, None)
    for name, x in sets.items():
        assert torch.equal(system.apply(plain, x), traced[name])


def test_the_counter_is_the_ports_own():
    assert names.GMM_STEPS in names.PORT_ONLY
    assert names.SCHEMA[names.GMM_STEPS][0] == "counter" and names.SCHEMA[names.GMM_STEPS][2] == ("step",)
