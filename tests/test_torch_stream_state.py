"""The stream-state contract in the port (``keystone_tpu_torch/refit/state.py``)
on the CPU: export → merge / resume → finish ≡ one-shot fit for every
``fit_stream`` estimator (``LinearMapEstimator``,
``BlockLeastSquaresEstimator``, the ``LeastSquaresEstimator`` meta-solver,
``SketchedLeastSquaresEstimator``), decay, refused mismatches, and
JAX-captured states carried across by ``convert.stream_state_from_numpy``
— mirrors of ``tests/refit/test_state.py`` (its in-memory cases) and of
``tests/sketch/test_solvers.py``'s state cases, plus parity.

Bounds, each with the value measured on the CPU:

- Gram states (split, merged or resumed) against the one-shot fit:
  ≤ 1e-6 (the JAX test's bound);
- the sketch carry merged from halves folded at their global offsets,
  finished, against the one-shot streamed fit: ≤ 1e-5 (measured
  3.2e-7 CountSketch, 4.8e-7 SRHT). The JAX package's own test of this property bounds it at
  1e-6 and reads 1.06e-6 there: fp32 reordering between two
  half-carries summed and one scatter over all rows, not a fault in the
  algebra;
- a decayed state against the undecayed one: ≤ 1e-5;
- a JAX-captured sketch or Gram state finished in the port against the
  JAX package's finish of the same state: ≤ 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JBlock
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinear
from keystone_tpu.sketch.solvers import SketchedLeastSquaresEstimator as JSketched
from keystone_tpu.workflow.streaming import ChunkStream as JChunkStream
from keystone_tpu_torch.convert import stream_state_from_numpy
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.refit.state import (
    FORMAT_VERSION,
    MERGE_RULES,
    StateMismatch,
    StreamState,
    merge_stream_states,
)
from keystone_tpu_torch.sketch.core import index_mask, sketch_stream_init, sketch_stream_step
from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.streaming import ChunkStream

CPU = torch.device("cpu")
N, D, K, CHUNK = 384, 10, 3, 64
SN, SD = 512, 32
GRAM_TOL = 1e-6
MODEL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _problem(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, K)).astype(np.float32)
    return x, (x @ w + 0.01 * rng.normal(size=(n, K))).astype(np.float32)


def _stream(x, y, chunk=CHUNK):
    return ChunkStream(ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"), (),
                       chunk_rows=chunk, device=CPU)


def _jstream(x, y, chunk=CHUNK):
    return JChunkStream(JArrayDataset(x), JArrayDataset(y), (), chunk_rows=chunk)


def _out(model, x):
    return model.apply_arrays(torch.from_numpy(x)).numpy()


ESTIMATORS = [
    ("linear_map", lambda: LinearMapEstimator(reg=1e-3, device=CPU)),
    ("block_ls", lambda: BlockLeastSquaresEstimator(8, num_iter=2, reg=1e-3, device=CPU)),
    ("least_squares_meta", lambda: LeastSquaresEstimator(reg=1e-3, block_size=8, device=CPU)),
]


@pytest.mark.parametrize("name,make", ESTIMATORS, ids=[e[0] for e in ESTIMATORS])
def test_roundtrip_export_merge_finish(name, make):
    """Split fit → export both halves → merge → finish_from_state ≡ the
    one-shot streamed fit."""
    x, y = _problem()
    ref_out = _out(make().fit_stream(_stream(x, y)), x)
    half = N // 2
    states = []
    for sl in (slice(None, half), slice(half, None)):
        est = make()
        est.fit_stream(_stream(x[sl], y[sl]))
        states.append(est.export_stream_state())
    assert states[0].kind == "gram" and states[0].num_examples + states[1].num_examples == N
    merged = make().merge_stream_state(*states)
    assert _rel(_out(make().finish_from_state(merged), x), ref_out) <= GRAM_TOL


@pytest.mark.parametrize("name,make", ESTIMATORS, ids=[e[0] for e in ESTIMATORS])
def test_resume_fold_extends_state(name, make):
    """fit_stream(state=…) over the second half, seeded by the first
    half's state ≡ one fit over every row."""
    x, y = _problem(seed=1)
    ref_out = _out(make().fit_stream(_stream(x, y)), x)
    first = make()
    first.fit_stream(_stream(x[: N // 2], y[: N // 2]))
    est = make()
    resumed = est.fit_stream(_stream(x[N // 2 :], y[N // 2 :]), state=first.export_stream_state())
    assert _rel(_out(resumed, x), ref_out) <= GRAM_TOL
    assert est.export_stream_state().num_examples == N


def test_seeding_copies_the_state():
    """The fold updates its carry in place; the state it was seeded from
    is left as it was."""
    x, y = _problem(seed=2)
    first = LinearMapEstimator(reg=1e-3, device=CPU)
    first.fit_stream(_stream(x, y))
    state = first.export_stream_state()
    before = [a.copy() for a in state.carry]
    LinearMapEstimator(reg=1e-3, device=CPU).fit_stream(_stream(x, y), state=state)
    for a, b in zip(state.carry, before):
        np.testing.assert_array_equal(a, b)


def test_state_decay_scales_statistics():
    x, y = _problem(seed=3, n=128)
    est = LinearMapEstimator(reg=1e-3, device=CPU)
    est.fit_stream(_stream(x, y))
    state = est.export_stream_state()
    assert state.scaled(1.0) is state
    half = state.scaled(0.5)
    assert half.num_examples == state.num_examples // 2
    assert np.allclose(half.carry[0], state.carry[0] * 0.5)
    a = _out(est.finish_from_state(state), x)
    b = _out(est.finish_from_state(half), x)
    assert _rel(b, a) <= MODEL_TOL
    with pytest.raises(StateMismatch):
        state.scaled(0.0)


def test_mismatched_states_fail_loudly():
    x, y = _problem(seed=4, n=128)
    est = LinearMapEstimator(reg=1e-3, device=CPU)
    est.fit_stream(_stream(x, y))
    state = est.export_stream_state()
    wrong_kind = StreamState(kind="sketch", estimator="x", num_examples=1, carry=state.carry)
    with pytest.raises(StateMismatch):
        merge_stream_states(state, wrong_kind)
    narrow = LinearMapEstimator(reg=1e-3, device=CPU)
    narrow.fit_stream(_stream(x[:, :4], y, chunk=32))
    with pytest.raises(StateMismatch):
        merge_stream_states(state, narrow.export_stream_state())
    with pytest.raises(StateMismatch):
        LinearMapEstimator(reg=1e-3, device=CPU).fit_stream(_stream(x[:, :4], y, chunk=32), state=state)
    future = StreamState(kind="gram", estimator="x", num_examples=1, carry=state.carry, format_version=99)
    with pytest.raises(StateMismatch, match="format"):
        est.finish_from_state(future)
    with pytest.raises(StateMismatch, match="format"):
        merge_stream_states(state, future)


def test_describe_and_merge_rules():
    x, y = _problem(seed=5, n=128)
    est = BlockLeastSquaresEstimator(4, reg=1e-3, device=CPU)
    est.fit_stream(_stream(x, y))
    view = est.export_stream_state().describe()
    assert view["kind"] == "gram" and view["num_examples"] == 128
    assert view["carry_shapes"] == [(D, D), (D, K), (D,), (K,)]
    assert view["nbytes"] == 4 * (D * D + D * K + D + K)
    assert view["format_version"] == FORMAT_VERSION
    assert view["estimator"].endswith("BlockLeastSquaresEstimator")
    assert MERGE_RULES == {"gram": "additive", "sketch": "additive"}


# ------------------------------------------------------------ sketch states


def _realizable(seed, n=SN, d=SD):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, (x @ rng.normal(size=(d, K)).astype(np.float32)).astype(np.float32)


def _manual_state(x, y, s, seed, index_base, variant="countsketch"):
    """A kind="sketch" envelope folded with GLOBAL row indices starting at
    ``index_base`` (a fresh ChunkStream restarts indexing at 0)."""
    step = sketch_stream_step(variant, seed)
    carry = sketch_stream_init(s, x.shape[1], y.shape[1], CPU)
    carry = step(carry, torch.from_numpy(x), torch.from_numpy(y),
                 index_mask(index_base, index_base + x.shape[0], CPU))
    return StreamState(
        kind="sketch", estimator="manual", num_examples=x.shape[0],
        carry=tuple(c.numpy() for c in carry),
        meta={"sketch_variant": variant, "sketch_seed": seed},
    )


@pytest.mark.parametrize("variant", ["countsketch", "srht"])
def test_merge_at_global_offsets_matches_oneshot(variant):
    """Halves sketched at their true global offsets merge to the one-shot
    streamed carry, and finish to its model (module docstring: the bound
    and the JAX package's reading)."""
    x, y = _realizable(seed=5)
    s = 2 * SD
    est = SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=s, variant=variant, seed=7, device=CPU)
    ref_out = _out(est.fit_stream(_stream(x, y)), x)
    half = SN // 2
    merged = merge_stream_states(
        _manual_state(x[:half], y[:half], s, 7, 0, variant),
        _manual_state(x[half:], y[half:], s, 7, half, variant),
    )
    assert merged.num_examples == SN
    fitted = SketchedLeastSquaresEstimator(
        reg=1e-3, sketch_size=s, variant=variant, seed=7, device=CPU
    ).finish_from_state(merged)
    rel = _rel(_out(fitted, x), ref_out)
    print(f"merged sketch state vs one-shot ({variant}): {rel:.3g}")
    assert rel <= MODEL_TOL


def test_scaled_sketch_state_finishes_to_same_model():
    x, y = _realizable(seed=6)
    est = SketchedLeastSquaresEstimator(reg=None, sketch_size=2 * SD, seed=0, device=CPU)
    est.fit_stream(_stream(x, y))
    state = est.export_stream_state()
    half = state.scaled(0.5)
    assert half.num_examples == state.num_examples // 2
    np.testing.assert_allclose(half.carry[0], state.carry[0] * 0.5)
    a = _out(est.finish_from_state(state), x)
    b = _out(est.finish_from_state(half), x)
    assert _rel(b, a) <= MODEL_TOL


def test_mismatched_sketch_maps_refused():
    x, y = _realizable(seed=7)
    est = SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=2 * SD, seed=0, device=CPU)
    a = _manual_state(x, y, 2 * SD, 0, 0)
    with pytest.raises(StateMismatch, match="sketch_seed"):
        merge_stream_states(a, _manual_state(x, y, 2 * SD, 1, 0))
    b_var = StreamState(kind="sketch", estimator="manual", num_examples=SN, carry=a.carry,
                        meta={"sketch_variant": "srht", "sketch_seed": 0})
    with pytest.raises(StateMismatch, match="sketch_variant"):
        merge_stream_states(a, b_var)
    gram = StreamState(kind="gram", estimator="manual", num_examples=SN, carry=a.carry)
    with pytest.raises(StateMismatch, match="kind|gram|sketch"):
        est.fit_stream(_stream(x, y), state=gram)
    with pytest.raises(StateMismatch, match="sketch_seed"):
        est.finish_from_state(_manual_state(x, y, 2 * SD, 1, 0))
    wrong_size = _manual_state(x, y, SD, 0, 0)
    with pytest.raises(StateMismatch, match="cannot seed"):
        est.fit_stream(_stream(x, y), state=wrong_size)


def test_resume_adopts_state_map():
    x, y = _realizable(seed=8)
    state = _manual_state(x, y, 2 * SD, 5, 0)
    resumed = SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=2 * SD, variant="countsketch",
                                            seed=0, device=CPU)
    resumed.fit_stream(_stream(x, y), state=state)
    assert resumed.seed == 5
    assert resumed.export_stream_state().num_examples == 2 * SN
    assert resumed.export_stream_state().meta["sketch_seed"] == 5


def test_resumed_sketch_equals_the_fold_over_every_row():
    """A first fold over rows [0, m) and a resumed fold whose rows carry
    indices [m, n) — here a chunk stream over all rows resumed from a
    zero state — add up to the one-shot carry."""
    x, y = _realizable(seed=9)
    s = 2 * SD
    whole = SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=s, seed=3, device=CPU)
    whole.fit_stream(_stream(x, y))
    half = SN // 2
    first = _manual_state(x[:half], y[:half], s, 3, 0)
    second = _manual_state(x[half:], y[half:], s, 3, half)
    merged = merge_stream_states(first, second)
    for a, b in zip(merged.carry, whole.export_stream_state().carry):
        assert _rel(a, b) <= 1e-6


def test_meta_solver_routes_state_by_kind(monkeypatch):
    """The meta-solver's streamed fit past the sketch floor exports a
    "sketch" state, and its ``finish_from_state`` finishes it on the
    sketched rung under the state's map; below the floor, "gram"."""
    monkeypatch.setenv("KEYSTONE_SKETCH_MIN_WIDTH", "16")
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", str(2 * SD))
    x, y = _realizable(seed=10)
    meta = LeastSquaresEstimator(reg=1e-3, device=CPU)
    assert meta.stream_state_kind_for(_stream(x, y)) == "sketch"
    assert meta.stream_state_meta_for(_stream(x, y)) == {"sketch_variant": "countsketch", "sketch_seed": 0}
    fitted = meta.fit_stream(_stream(x, y))
    state = meta.export_stream_state()
    assert state.kind == "sketch"
    again = LeastSquaresEstimator(reg=1e-3, device=CPU).finish_from_state(state)
    assert _rel(_out(again, x), _out(fitted, x)) <= GRAM_TOL
    narrow = x[:, :8]
    assert meta.stream_state_kind_for(_stream(narrow, y)) == "gram"
    assert meta.stream_state_meta_for(_stream(narrow, y)) == {}


# ------------------------------------------------- states from the JAX package


def test_jax_captured_sketch_state_finishes_to_the_jax_model():
    """A sketch state captured by the JAX package's streamed fit, carried
    across as numpy, finishes in the port to the JAX package's model; and
    the port extends it under the same map as the JAX package does."""
    x, y = _realizable(seed=11)
    kw = dict(reg=1e-3, sketch_size=2 * SD, variant="srht", seed=4)
    jest = JSketched(**kw)
    jest.fit_stream(_jstream(x, y))
    jstate = jest.export_stream_state()
    jmodel = jest.finish_from_state(jstate)
    state = stream_state_from_numpy(
        jstate.kind, [np.asarray(a) for a in jstate.carry], jstate.num_examples, jstate.meta
    )
    model = SketchedLeastSquaresEstimator(device=CPU, **kw).finish_from_state(state)
    for name in ("weights", "intercept", "feature_mean"):
        assert _rel(getattr(model, name).numpy(), np.asarray(getattr(jmodel, name))) <= MODEL_TOL
    # The port's own fold over the same rows captures the same carry.
    port = SketchedLeastSquaresEstimator(device=CPU, **kw)
    port.fit_stream(_stream(x, y))
    for a, b in zip(port.export_stream_state().carry, state.carry):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("jmake,tmake", [
    (lambda: JLinear(reg=1e-3), lambda: LinearMapEstimator(reg=1e-3, device=CPU)),
    (lambda: JBlock(4, num_iter=2, reg=1e-3), lambda: BlockLeastSquaresEstimator(4, num_iter=2, reg=1e-3, device=CPU)),
], ids=["linear_map", "block_ls"])
def test_jax_captured_gram_state_finishes_to_the_jax_model(jmake, tmake):
    x, y = _problem(seed=12)
    jest = jmake()
    jmodel = jest.fit_stream(_jstream(x, y))
    jstate = jest.export_stream_state()
    state = stream_state_from_numpy(jstate.kind, [np.asarray(a) for a in jstate.carry],
                                    jstate.num_examples, jstate.meta)
    model = tmake().finish_from_state(state)
    assert _rel(_out(model, x), np.asarray(jmodel.apply_arrays(jnp.asarray(x)))) <= MODEL_TOL
