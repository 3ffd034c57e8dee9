"""The spans and counters inside the port's fit path, on the CPU.

A block coordinate descent opens one ``bcd:block`` span per block update
(attributes ``block``, ``pass``, ``rows``, ``width``, ``reused``) with
``bcd:rhs`` (twice), ``bcd:gram``, ``bcd:factor``, ``bcd:solve`` and
``bcd:update`` inside it on the first pass, and on later passes, which
solve with the factor the first pass kept, no ``bcd:gram`` or
``bcd:factor``. It counts its Grams, factorisations, reused factors and
block updates in ``keystone_bcd_steps_total`` whether a session is open
or not. The
rematerialising conv-block solver opens ``conv:block`` per filter block
with ``conv:patches`` / ``conv:stats`` / ``conv:product`` / ``conv:pool``
per image chunk, and ``conv:standardize``; the TIMIT featurizer's build
is ``build:featurizer`` with a ``build:draw`` and a ``build:upload`` per
branch; ``Pipeline.fit()`` plans inside ``plan`` and ``plan:verify``.
With device annotations on, each span of a session is a
``keystone/<name>`` range of ``torch.profiler``; with them off, or with
no session, there is none and nothing is recorded. The fits' weights are
bit for bit the same with tracing on and off.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import device as tdevice
from keystone_tpu_torch.obs import names, spans
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator
from keystone_tpu_torch.parallel import linalg
from keystone_tpu_torch.pipelines.timit import TimitConfig, build_featurizer

CPU = torch.device("cpu")
BCD_STEPS = ("gram", "factor", "factor_reuse", "block_update")
STEP_SPANS = ["bcd:factor", "bcd:gram", "bcd:rhs", "bcd:rhs", "bcd:solve", "bcd:update"]
REUSED_STEP_SPANS = ["bcd:rhs", "bcd:rhs", "bcd:solve", "bcd:update"]
TWO_PASSES = {"gram": 3, "factor": 3, "factor_reuse": 3, "block_update": 6}


@pytest.fixture(autouse=True)
def _annotations_follow_the_env(monkeypatch):
    monkeypatch.delenv("KEYSTONE_DEVICE_ANNOTATIONS", raising=False)
    tdevice.set_device_annotations(None)
    yield
    tdevice.set_device_annotations(None)


def _steps():
    counter = names.metric(names.BCD_STEPS)
    return {step: counter.value(step=step) for step in BCD_STEPS}


def _bcd_problem(n=40, d=12, k=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g), torch.randn(n, k, generator=g)


def _bcd(a, y):
    return linalg.block_coordinate_descent(a, y, reg=0.1, num_epochs=2, block_size=4)


def _children(session):
    by_parent = {}
    for record in session.spans():
        by_parent.setdefault(record.parent_id, []).append(record)
    return by_parent


def _conv_problem(n=24, num_filters=6, seed=1):
    rng = np.random.default_rng(seed)
    filters = rng.normal(size=(num_filters, 6 * 6 * 3)).astype(np.float32) * 0.1
    fz = tcore.FusedConvFeaturizer(tcore.Convolver(filters, 3, normalize_patches=True, device=CPU),
                                   tcore.SymmetricRectifier(alpha=0.25),
                                   tcore.Pooler(13, 14, None, "sum"), filter_block=2)
    images = rng.random((n, 32, 32, 3)).astype(np.float32)
    y = rng.normal(size=(n, 3)).astype(np.float32)
    return fz, images, y


def _conv_fit(fz, images, y):
    # 2 filters a block (16 features), 3 blocks; 10 images a chunk, 3 chunks.
    est = ConvBlockLeastSquaresEstimator(fz, block_size=16, num_iter=1, reg=0.5, image_chunk=10, device=CPU)
    return est.fit(ArrayDataset(images, device=CPU), ArrayDataset(y, device=CPU))


def test_in_core_bcd_span_tree_and_counts():
    a, y = _bcd_problem()
    before = _steps()
    with spans.tracing_session("bcd") as session:
        _bcd(a, y)
    after = _steps()
    assert {s: after[s] - before[s] for s in BCD_STEPS} == TWO_PASSES
    blocks = session.find("bcd:block")
    assert sorted((b.attributes["pass"], b.attributes["block"]) for b in blocks) == [
        (p, b) for p in range(2) for b in range(3)]
    assert all(b.attributes["rows"] == 40 and b.attributes["width"] == 4 for b in blocks)
    children = _children(session)
    for block in blocks:
        # The first pass forms each block's Gram and factor; the second
        # solves with the kept factor.
        first = block.attributes["pass"] == 0
        assert block.attributes["reused"] is not first
        assert sorted(c.name for c in children[block.span_id]) == (STEP_SPANS if first else REUSED_STEP_SPANS)
    # The session's summary counts the same steps.
    summary = spans.recent_sessions()[-1]
    assert summary.name == "bcd"
    assert summary.span_count["bcd:block"] == 6 and summary.span_count["bcd:rhs"] == 12
    assert summary.counters[f"{names.BCD_STEPS}{{step=gram}}"] == 3


def test_bcd_counts_without_a_session():
    a, y = _bcd_problem()
    before = _steps()
    _bcd(a, y)
    after = _steps()
    assert {s: after[s] - before[s] for s in BCD_STEPS} == TWO_PASSES


def test_bcd_from_gram_spans_its_factors_and_solves():
    a, y = _bcd_problem()
    before = _steps()
    with spans.tracing_session("gram") as session:
        linalg.bcd_from_gram(a.T @ a, a.T @ y, 0.1, 2, 4)
    after = _steps()
    assert {s: after[s] - before[s] for s in BCD_STEPS} == {"gram": 0, "factor": 3, "factor_reuse": 3, "block_update": 6}
    assert Counter(s.name for s in session.spans()) == {"bcd:factor": 3, "bcd:solve": 6}


def test_conv_block_fit_span_tree():
    fz, images, y = _conv_problem()
    before = _steps()
    with spans.tracing_session("conv") as session:
        _conv_fit(fz, images, y)
    after = _steps()
    assert after["gram"] - before["gram"] == 3
    children = _children(session)
    blocks = session.find("conv:block")
    assert sorted(b.attributes["block"] for b in blocks) == [0, 1, 2]
    for block in blocks:
        inside = Counter(c.name for c in children[block.span_id])
        assert inside == {"conv:patches": 3, "conv:stats": 3, "conv:product": 3, "conv:pool": 3}
    assert [c.attributes["images"] for c in session.find("conv:patches")][:3] == [10, 10, 4]
    assert all(c.attributes["filters"] == 2 for c in session.find("conv:pool"))
    assert sorted(s.attributes["block"] for s in session.find("conv:standardize")) == [0, 1, 2]
    assert len(session.find("bcd:block")) == 3


def test_timit_build_spans_draws_and_uploads():
    config = TimitConfig(num_cosines=3, num_cosine_features=8, seed=4)
    with spans.tracing_session("build") as session:
        build_featurizer(config, 5, device=CPU)
    (root,) = session.find("build:featurizer")
    assert root.attributes["branches"] == 3
    inside = _children(session)[root.span_id]
    assert Counter(c.name for c in inside) == {"build:draw": 3, "build:upload": 3}
    assert all(c.attributes["bytes"] == 4 * (8 * 5 + 8) for c in inside if c.name == "build:upload")


def test_pipeline_fit_opens_plan_and_verify():
    a, y = _bcd_problem()
    pipe = BlockLeastSquaresEstimator(4, num_iter=1, reg=0.1, device=CPU).with_data(
        ArrayDataset(a), ArrayDataset(y))
    with spans.tracing_session("fit") as session:
        pipe.fit()
    (plan,) = [s for s in session.spans() if s.name == "plan"]
    assert plan.attributes["nodes"] > 0
    children = _children(session)
    names_inside = {c.name for c in children[plan.span_id]}
    assert "plan:verify" in names_inside
    assert any(n.startswith("optimize:") for n in names_inside)
    assert spans.recent_sessions()[-1].span_count["plan"] == 1


def _keystone_ranges(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events() if e.name.startswith("keystone/"))


def _traced_bcd():
    a, y = _bcd_problem()
    with spans.tracing_session("bcd"):
        _bcd(a, y)


def test_profiler_ranges_mirror_the_spans_with_annotations_on():
    tdevice.set_device_annotations(True)
    ranges = _keystone_ranges(_traced_bcd)
    assert ranges["keystone/bcd:block"] == 6 and ranges["keystone/bcd:gram"] == 3
    assert ranges["keystone/bcd:factor"] == 3 and ranges["keystone/bcd:rhs"] == 12


def test_no_ranges_with_annotations_off():
    tdevice.set_device_annotations(False)
    assert _keystone_ranges(_traced_bcd) == {}


def test_no_ranges_and_no_spans_without_a_session():
    tdevice.set_device_annotations(True)
    a, y = _bcd_problem()
    closed = len(spans.recent_sessions())
    assert _keystone_ranges(lambda: _bcd(a, y)) == {}
    assert spans.active_session() is None and len(spans.recent_sessions()) == closed


def _traced(fn):
    """``fn()`` under a session, with annotations on, inside a profiler."""
    tdevice.set_device_annotations(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with spans.tracing_session("traced"):
                return fn()
    finally:
        tdevice.set_device_annotations(None)


def test_weights_are_bit_identical_with_tracing_on_and_off():
    a, y = _bcd_problem()
    assert torch.equal(_bcd(a, y), _traced(lambda: _bcd(a, y)))
    fz, images, y = _conv_problem()
    plain = _conv_fit(fz, images, y)
    traced = _traced(lambda: _conv_fit(fz, images, y))
    assert torch.equal(plain.weights, traced.weights)
    assert torch.equal(plain.linear.feature_mean, traced.linear.feature_mean)
