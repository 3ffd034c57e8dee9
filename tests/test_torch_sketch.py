"""The sketch tier of the port (``keystone_tpu_torch/sketch/``) on the CPU,
held to the JAX package (``keystone_tpu/sketch/``) on the same seeded
numpy inputs: the row hash, the CountSketch buckets and signs, the SRHT
rows and mix, the fold carries, the sketched solvers and the
meta-solver's sketched rung — mirrors of ``tests/sketch/test_core.py``,
``test_solvers.py`` (the estimator cases) and ``test_ladder.py``, plus
parity. The stream-state cases are in ``test_torch_stream_state.py``.

Bounds, each with the value measured on the CPU:

- the row hash, buckets, signs, the SRHT sampled rows and mix matrix:
  exactly equal;
- fold carries against the JAX package's: ≤ 1e-6 relative (measured
  ≤ 2.8e-7: fp32 scatter and product order);
- fitted models (W, intercept, feature mean) against the JAX package's:
  ≤ 1e-5 relative (streamed primal ≤ 1.0e-6, dual ≤ 4.9e-7; in-core
  after 16 PCG iterations at s = 4d 6.2e-7, and at ``refine_iters=0``
  with s < d 3.9e-7; the lstsq rung after an injected OOM ≤ 1.5e-6).
  PCG is held where 16 iterations converge: at s = 2d on the JAX test's
  data the solve is still 1.6e-4 from float64 after 16 iterations, and
  fp32 round-off in the two packages' iterations then parts them by as
  much (1.5e-4), each as far from float64 as the other. On rows of
  effective rank 16 with noise 0.01 at λ = 1e-4 the dual's W is barely
  regularized and two fp32 runs part by 5e-3 (their predictions by
  1.3e-4), so that case keeps only the JAX test's bound;
- the minimum-norm ``lstsq`` rung on a rank-deficient system: ≤ 1e-5
  (measured 4.8e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning import cost as jcost
from keystone_tpu.ops.learning.least_squares import LeastSquaresEstimator as JLeastSquares
from keystone_tpu.ops.stats.core import LinearRectifier as JLinearRectifier
from keystone_tpu.reliability import FaultSpec as JFaultSpec
from keystone_tpu.reliability import injected as jinjected
from keystone_tpu.sketch import core as jcore
from keystone_tpu.sketch import solvers as jsolvers
from keystone_tpu.workflow import executor as jexec
from keystone_tpu.workflow.optimize import DataStats as JDataStats
from keystone_tpu.workflow.streaming import ChunkStream as JChunkStream
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import names as tnames
from keystone_tpu_torch.ops.learning import cost as tcost
from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.ops.stats.core import LinearRectifier
from keystone_tpu_torch.reliability import FaultSpec, injected
from keystone_tpu_torch.sketch import core
from keystone_tpu_torch.sketch.solvers import (
    SketchedLeastSquaresEstimator,
    default_sketch_size,
    lstsq_min_norm,
    sketch_min_width,
)
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.optimize import DataStats
from keystone_tpu_torch.workflow.streaming import ChunkStream, StreamingFallback

CPU = torch.device("cpu")
S, D, K = 64, 24, 3
N, SD, CHUNK = 512, 32, 64
CARRY_TOL = 1e-6
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


def _t(a):
    return ArrayDataset(a, device="cpu")


def _rows(n, seed=0, d=D, k=K):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, k)).astype(np.float32)


def _fold(x, y, variant, seed, chunk, s=S, index_base=0):
    """Fold (x, y) through the port's stream step in ``chunk``-row pieces
    whose mask lanes carry the rows' absolute indices."""
    step = core.sketch_stream_step(variant, seed)
    carry = core.sketch_stream_init(s, x.shape[1], y.shape[1], CPU)
    for start in range(0, x.shape[0], chunk):
        stop = min(start + chunk, x.shape[0])
        carry = step(carry, torch.from_numpy(x[start:stop]), torch.from_numpy(y[start:stop]),
                     core.index_mask(index_base + start, index_base + stop, CPU))
    return tuple(c.numpy().copy() for c in carry)


def _jax_fold(x, y, variant, seed, s=S, index_base=0, mask=None):
    step = jcore.sketch_stream_step(variant, seed)
    if mask is None:
        mask = jnp.arange(index_base + 1, index_base + x.shape[0] + 1, dtype=jnp.float32)[:, None]
    carry = step(jcore.sketch_stream_init(s, x.shape[1], y.shape[1]), jnp.asarray(x), jnp.asarray(y), mask)
    return tuple(np.asarray(c) for c in carry)


# ----------------------------------------------------------- hash and core

#: Indices near 0, around 2²⁴ and over the whole 32-bit range.
HASH_INDICES = np.concatenate([
    np.arange(0, 512),
    np.arange((1 << 24) - 256, (1 << 24) + 256),
    np.random.default_rng(0).integers(0, 1 << 32, 2048),
    np.array([(1 << 32) - 1, (1 << 31), (1 << 31) - 1]),
]).astype(np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 123456789])
@pytest.mark.parametrize("salt", [0, 1])
def test_row_hash_equals_jax(seed, salt):
    want = np.asarray(jcore._row_hash(jnp.asarray(HASH_INDICES.astype(np.uint32)), seed, salt))
    got = core._row_hash(torch.from_numpy(HASH_INDICES.astype(np.int64)), seed, salt).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_parity_fold_equals_popcount():
    x = torch.from_numpy(HASH_INDICES.astype(np.int64))
    want = np.array([bin(int(v)).count("1") & 1 for v in HASH_INDICES])
    np.testing.assert_array_equal(core._parity(x).numpy(), want)


@pytest.mark.parametrize("s", [64, 4096, 1000])
def test_countsketch_buckets_and_signs_equal_jax(s):
    idx1 = np.concatenate([np.arange(1, 300), np.arange((1 << 24) - 100, (1 << 24) + 1), np.zeros(7)])
    mask = idx1.astype(np.float32)[:, None]
    bucket, sign = core.countsketch_hash(torch.from_numpy(mask), s, 11)
    idx = jnp.maximum(jnp.asarray(idx1, jnp.int32) - 1, 0).astype(jnp.uint32)
    jbucket = np.asarray(jcore._row_hash(idx, 11, 0) % jnp.uint32(s)).astype(np.int64)
    jsign = (1.0 - 2.0 * np.asarray(jcore._row_hash(idx, 11, 1) & jnp.uint32(1)).astype(np.float32)) * (idx1 > 0)
    np.testing.assert_array_equal(bucket.numpy(), jbucket)
    np.testing.assert_array_equal(sign.numpy(), jsign.astype(np.float32))
    assert (sign.numpy()[-7:] == 0).all()


@pytest.mark.parametrize("s,seed", [(32, 7), (512, 0)])
def test_srht_sample_rows_equal_jax(s, seed):
    got = core.srht_sample_rows(s, seed)
    assert got.dtype == np.uint32 and got.shape == (s,)
    np.testing.assert_array_equal(got, jcore.srht_sample_rows(s, seed))


def test_srht_mix_matrix_equals_jax():
    """The JAX step folded over identity rows returns its mix matrix
    exactly (each entry ±1/√s times one 1): the port's is equal."""
    rows = 40
    eye = np.eye(rows, dtype=np.float32)
    want = _jax_fold(eye, np.zeros((rows, 1), np.float32), "srht", 3, s=S, index_base=1000)[0]
    got = core.srht_mix_matrix(core.index_mask(1000, 1000 + rows, CPU), S, 3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", core.VARIANTS)
@pytest.mark.parametrize("index_base", [0, 37, (1 << 24) - 200])
def test_stream_step_carries_match_jax(variant, index_base):
    """One chunk with pad rows at a non-zero index base: every carry leaf
    within 1e-6 of the JAX package's."""
    x, y = _rows(90, seed=5)
    pad = 26
    xp = np.concatenate([x, np.zeros((pad, D), np.float32)])
    yp = np.concatenate([y, np.zeros((pad, K), np.float32)])
    lane = np.concatenate([np.arange(index_base + 1, index_base + 91), np.zeros(pad)]).astype(np.float32)
    want = _jax_fold(xp, yp, variant, 9, mask=jnp.asarray(lane)[:, None])
    step = core.sketch_stream_step(variant, 9)
    got = step(core.sketch_stream_init(S, D, K, CPU), torch.from_numpy(xp), torch.from_numpy(yp),
               torch.from_numpy(lane)[:, None])
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= CARRY_TOL


@pytest.mark.parametrize("variant", core.VARIANTS)
@pytest.mark.parametrize("chunk", [7, 32, 128])
def test_chunked_equals_whole(variant, chunk):
    x, y = _rows(128)
    whole = _fold(x, y, variant, seed=5, chunk=128)
    pieces = _fold(x, y, variant, seed=5, chunk=chunk)
    for a, b in zip(whole, pieces):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", core.VARIANTS)
def test_index_base_shifts_the_map(variant):
    x, y = _rows(96, seed=1)
    whole = _fold(x, y, variant, seed=2, chunk=96)
    shifted = _fold(x, y, variant, seed=2, chunk=96, index_base=96)
    assert not np.allclose(whole[0], shifted[0])
    half = 48
    a = _fold(x[:half], y[:half], variant, seed=2, chunk=half)
    b = _fold(x[half:], y[half:], variant, seed=2, chunk=half, index_base=half)
    for w, (pa, pb) in zip(whole, zip(a, b)):
        np.testing.assert_allclose(w, pa + pb, rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", core.VARIANTS)
def test_centering_identity(variant):
    x, y = _rows(80, seed=3)
    carry = tuple(torch.from_numpy(c) for c in _fold(x, y, variant, seed=0, chunk=80))
    sa_c, sy_c, mu_a, _ = core.sketch_stream_finish(carry, x.shape[0])
    np.testing.assert_allclose(mu_a.numpy(), x.mean(axis=0), atol=1e-5)
    centered = _fold(x - x.mean(axis=0), y - y.mean(axis=0), variant, seed=0, chunk=80)
    np.testing.assert_allclose(sa_c.numpy(), centered[0], atol=1e-3)
    np.testing.assert_allclose(sy_c.numpy(), centered[1], atol=1e-3)


@pytest.mark.parametrize("variant", core.VARIANTS)
def test_pad_rows_contribute_nothing(variant):
    x, y = _rows(40, seed=4)
    clean = _fold(x, y, variant, seed=9, chunk=40)
    pad = 24
    xp = torch.from_numpy(np.concatenate([x, np.zeros((pad, D), np.float32)]))
    yp = torch.from_numpy(np.concatenate([y, np.zeros((pad, K), np.float32)]))
    mask = torch.cat([torch.arange(1, 41, dtype=torch.float32), torch.zeros(pad)])[:, None]
    padded = core.sketch_stream_step(variant, 9)(core.sketch_stream_init(S, D, K, CPU), xp, yp, mask)
    for a, b in zip(clean, padded):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", core.VARIANTS)
def test_sketch_rows_matches_stream_step_and_jax(variant):
    x, _ = _rows(48, seed=6)
    sa, s1 = core.sketch_rows(torch.from_numpy(x), start_index=16, variant=variant, seed=3, s=S)
    carry = _fold(x, np.zeros((48, K), np.float32), variant, seed=3, chunk=48, index_base=16)
    np.testing.assert_allclose(sa.numpy(), carry[0], atol=1e-4)
    np.testing.assert_allclose(s1.numpy(), carry[2], atol=1e-4)
    jsa, js1 = jcore.sketch_rows(x, start_index=16, variant=variant, seed=3, s=S)
    assert _rel(sa.numpy(), np.asarray(jsa)) <= CARRY_TOL
    assert _rel(s1.numpy(), np.asarray(js1)) <= CARRY_TOL


def test_stream_step_is_one_object_per_map():
    assert core.sketch_stream_step("countsketch", 4) is core.sketch_stream_step("countsketch", 4)
    assert core.sketch_stream_step("countsketch", 4).needs_mask


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown sketch variant"):
        core.sketch_stream_step("gaussian", 0)
    with pytest.raises(ValueError, match="KEYSTONE_SKETCH_VARIANT"):
        SketchedLeastSquaresEstimator(variant="gaussian", device=CPU)


def test_srht_sample_rows_deterministic():
    a = core.srht_sample_rows(32, 7)
    np.testing.assert_array_equal(a, core.srht_sample_rows(32, 7))
    assert not np.array_equal(a, core.srht_sample_rows(32, 8))


def test_state_bytes_formula_and_index_cap():
    assert core.sketch_state_bytes(256, 8192, 8) == 4 * (256 * 8192 + 256 * 8 + 256 + 8192 + 8)
    assert core.sketch_state_bytes(4096, 204_800, 147) == 3_358_687_820
    assert core.sketch_state_bytes(512, 8192, 8) == jcore.sketch_state_bytes(512, 8192, 8) == 16_828_448
    assert core.MASK_INDEX_EXACT_ROWS == jcore.MASK_INDEX_EXACT_ROWS == 1 << 24


# ------------------------------------------------------------------ solvers


def _realizable(n=N, d=SD, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, K)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _low_rank(seed=2, n=512, d=128, r=16):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, r)).astype(np.float32)
    basis = rng.normal(size=(r, d)).astype(np.float32) / np.sqrt(r)
    x = (z @ basis + 0.01 * rng.normal(size=(n, d))).astype(np.float32)
    w = rng.normal(size=(d, K)).astype(np.float32) / np.sqrt(d)
    return x, (x @ w).astype(np.float32)


def _wide(seed=7, n=512, d=128):
    """Full-rank rows wider than the sketch: a well-conditioned s×s dual."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, K)).astype(np.float32) / np.sqrt(d)
    return x, (x @ w + 0.1 * rng.normal(size=(n, K))).astype(np.float32)


def _streams(x, y, chunk=CHUNK):
    return (
        ChunkStream(_t(x), _t(y), (), chunk_rows=chunk, device=CPU),
        JChunkStream(JArrayDataset(x), JArrayDataset(y), (), chunk_rows=chunk),
    )


def _assert_models_match(tm, jm, tol=MODEL_TOL):
    for name in ("weights", "intercept", "feature_mean"):
        assert _rel(getattr(tm, name).numpy(), np.asarray(getattr(jm, name))) <= tol, name


@pytest.mark.parametrize("variant", core.VARIANTS)
def test_streamed_primal_matches_jax_and_exact(variant):
    """s ≥ d: the stacked primal finish; the port's model equals the JAX
    package's, and on noiseless realizable rows both equal the exact
    Gram rung's predictions (the JAX test's 1e-4)."""
    x, y = _realizable()
    ts, js = _streams(x, y)
    kw = dict(reg=1e-6, sketch_size=2 * SD, variant=variant, seed=1)
    tm = SketchedLeastSquaresEstimator(device=CPU, **kw).fit_stream(ts)
    jm = jsolvers.SketchedLeastSquaresEstimator(**kw).fit_stream(js)
    _assert_models_match(tm, jm)
    exact = LinearMapEstimator(reg=1e-6, device=CPU).fit_stream(_streams(x, y)[0])
    xt = torch.from_numpy(x)
    assert _rel(tm.apply_arrays(xt).numpy(), exact.apply_arrays(xt).numpy()) <= 1e-4


@pytest.mark.parametrize("variant", core.VARIANTS)
def test_streamed_dual_matches_jax(variant):
    """s < d: the s×s dual finish on full-rank rows; the model equals the
    JAX package's."""
    x, y = _wide()
    ts, js = _streams(x, y)
    kw = dict(reg=1e-3, sketch_size=64, variant=variant, seed=1)
    tm = SketchedLeastSquaresEstimator(device=CPU, **kw).fit_stream(ts)
    jm = jsolvers.SketchedLeastSquaresEstimator(**kw).fit_stream(js)
    _assert_models_match(tm, jm)


@pytest.mark.parametrize("variant", core.VARIANTS)
def test_streamed_dual_bounded_on_low_rank_rows(variant):
    """The JAX test's case: with effective rank 16 ≪ s the sketch keeps
    the row-space energy, and predictions lie within 0.05 of the labels.
    (λ = 1e-4 on rows of noise 0.01 leaves K's noise directions barely
    regularized, so W itself is not held to the JAX package's here.)"""
    x, y = _low_rank()
    kw = dict(reg=1e-4, sketch_size=64, variant=variant, seed=1)
    tm = SketchedLeastSquaresEstimator(device=CPU, **kw).fit_stream(_streams(x, y)[0])
    preds = tm.apply_arrays(torch.from_numpy(x)).numpy()
    assert np.isfinite(preds).all() and _rel(preds, y) < 0.05


@pytest.mark.parametrize("iters,s", [(16, 4 * SD), (0, SD // 2)])
def test_incore_precondition_matches_jax(iters, s):
    rng = np.random.default_rng(3)
    x, y0 = _realizable(seed=3)
    y = y0 + 0.05 * rng.normal(size=y0.shape).astype(np.float32)
    kw = dict(reg=1e-3, sketch_size=s, seed=1, refine_iters=iters)
    tm = SketchedLeastSquaresEstimator(device=CPU, **kw).fit(_t(x), _t(y))
    jm = jsolvers.SketchedLeastSquaresEstimator(**kw).fit(JArrayDataset(x), JArrayDataset(y))
    _assert_models_match(tm, jm)


def test_incore_precondition_matches_exact():
    """The JAX test's case: PCG on the full operator reaches ≤ 1e-3 of the
    exact ridge even at s = 2d."""
    rng = np.random.default_rng(3)
    x, y0 = _realizable(seed=3)
    y = y0 + 0.05 * rng.normal(size=y0.shape).astype(np.float32)
    exact = LinearMapEstimator(reg=1e-3, device=CPU).fit(_t(x), _t(y))
    est = SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=2 * SD, seed=1, device=CPU)
    xt = torch.from_numpy(x)
    preds = est.fit(_t(x), _t(y)).apply_arrays(xt).numpy()
    assert _rel(preds, exact.apply_arrays(xt).numpy()) <= 1e-3


def test_incore_divergence_guard_stays_finite():
    """s well below rank (an underdetermined fit): the residual guard
    keeps the answer finite; without refinement the sketch-only solve
    equals the JAX package's."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    y = rng.normal(size=(64, 2)).astype(np.float32)
    for iters in (0, 16):
        kw = dict(reg=1e-3, sketch_size=32, seed=0, refine_iters=iters)
        tm = SketchedLeastSquaresEstimator(device=CPU, **kw).fit(_t(x), _t(y))
        assert np.isfinite(tm.apply_arrays(torch.from_numpy(x)).numpy()).all(), f"iters={iters}"
        if iters == 0:
            jm = jsolvers.SketchedLeastSquaresEstimator(**kw).fit(JArrayDataset(x), JArrayDataset(y))
            _assert_models_match(tm, jm)


def test_lstsq_min_norm_equals_jax_on_a_rank_deficient_system():
    rng = np.random.default_rng(9)
    a = (rng.normal(size=(16, 4)) @ rng.normal(size=(4, 40))).astype(np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    want, *_ = jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(b), rcond=None)
    got = lstsq_min_norm(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(got.numpy(), np.asarray(want)) <= MODEL_TOL


@pytest.mark.parametrize("data,s", [("realizable", 2 * SD), ("wide", 64)])
def test_injected_oom_at_the_finish_lands_on_lstsq_like_jax(data, s):
    """An OOM at ``sketch.finish``'s first rung (primal for s ≥ d, dual
    for s < d) lands on the minimum-norm lstsq rung in both packages,
    with the same ``degradation`` record and model."""
    x, y = _realizable() if data == "realizable" else _wide()
    ts, js = _streams(x, y)
    kw = dict(reg=1e-4, sketch_size=s, seed=2)
    with injected(FaultSpec(match="sketch.finish", kind="oom", first_n=1)):
        tm = SketchedLeastSquaresEstimator(device=CPU, **kw).fit_stream(ts)
    with jinjected(JFaultSpec(match="sketch.finish", kind="oom", first_n=1)):
        jm = jsolvers.SketchedLeastSquaresEstimator(**kw).fit_stream(js)
    assert tm.degradation["rung"] == "lstsq"
    assert tm.degradation == jm.degradation
    _assert_models_match(tm, jm)


def test_row_index_cap_falls_back():
    class HugeStream:
        num_examples = core.MASK_INDEX_EXACT_ROWS + 1

    with pytest.raises(StreamingFallback, match="float32-exact"):
        SketchedLeastSquaresEstimator(reg=1e-3, device=CPU).fit_stream(HugeStream())


def test_default_sketch_size_bounds():
    for d, s in ((10, 128), (1000, 1000), (100_000, 4096), (204_800, 4096)):
        assert default_sketch_size(d) == jsolvers.default_sketch_size(d) == s


def test_sketch_size_resolution_order(monkeypatch):
    monkeypatch.delenv("KEYSTONE_SKETCH_SIZE", raising=False)
    est = SketchedLeastSquaresEstimator(device=CPU)
    assert est._resolve_sketch_size(50_000) == 4096
    est._tuned_sketch_size = 384
    assert est._resolve_sketch_size(50_000) == 384
    est.sketch_size = 256
    assert est._resolve_sketch_size(50_000) == 256
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", "128")
    assert est._resolve_sketch_size(50_000) == 128


def test_fit_records_metrics_and_repeated_fits_add_no_chunk_shape():
    x, y = _realizable()
    fits = tnames.metric(tnames.SKETCH_FITS)
    before = fits.value(variant="countsketch")
    est = SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=48, seed=3, device=CPU)
    est.fit_stream(_streams(x, y)[0])
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    est.fit_stream(_streams(x, y)[0])
    assert last_stream_report().compiles_steady_state == 0
    assert fits.value(variant="countsketch") - before == 2
    assert tnames.metric(tnames.SKETCH_SIZE).value() == 48
    assert tnames.metric(tnames.SKETCH_STATE_BYTES).value() == core.sketch_state_bytes(48, SD, K)


# ------------------------------------------------------- the sketched rung

#: Explicit weights for both packages, so their picks compare.
WEIGHTS = (jcost.DEFAULT_COST_WEIGHTS.cpu, jcost.DEFAULT_COST_WEIGHTS.mem, jcost.DEFAULT_COST_WEIGHTS.network)


def _picks(n, d, machines=1, tuned=None, k=8):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, d)).astype(np.float32)
    y = rng.normal(size=(32, k)).astype(np.float32)
    t = LeastSquaresEstimator(reg=1e-3, num_machines=machines, weights=tcost.CostWeights(*WEIGHTS), device=CPU)
    j = JLeastSquares(reg=1e-3, num_machines=machines, weights=jcost.CostWeights(*WEIGHTS))
    if tuned:
        t._tuned_sketch_size = j._tuned_sketch_size = tuned
    tp = t.optimize([_t(x), _t(y)], DataStats(n, 1, [n]))
    jp = j.optimize([JArrayDataset(x), JArrayDataset(y)], JDataStats(n_total=n, num_shards=1, n_per_shard=[n]))
    assert type(tp).__name__ == type(jp).__name__
    return tp, jp


def test_sketched_rung_wins_past_crossover(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", "256")
    tp, _ = _picks(n=4096, d=8192)
    assert isinstance(tp, SketchedLeastSquaresEstimator)
    assert tp.device == CPU


def test_width_floor_gates_the_rung(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", "256")
    tp, _ = _picks(n=4096, d=4096)
    assert not isinstance(tp, SketchedLeastSquaresEstimator)


def test_pricing_uses_resolved_sketch_size(monkeypatch):
    monkeypatch.delenv("KEYSTONE_SKETCH_SIZE", raising=False)
    tp, _ = _picks(n=2048, d=8192, machines=8)
    assert not isinstance(tp, SketchedLeastSquaresEstimator)
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", "512")
    tp, _ = _picks(n=2048, d=8192, machines=8)
    assert isinstance(tp, SketchedLeastSquaresEstimator)


def test_tuned_sketch_size_rides_the_pricing_and_the_pick(monkeypatch):
    monkeypatch.delenv("KEYSTONE_SKETCH_SIZE", raising=False)
    tp, jp = _picks(n=2048, d=8192, machines=8, tuned=512)
    assert isinstance(tp, SketchedLeastSquaresEstimator)
    assert tp._resolve_sketch_size(8192) == jp._resolve_sketch_size(8192) == 512


def test_every_candidate_priced_like_jax(monkeypatch):
    monkeypatch.delenv("KEYSTONE_SKETCH_SIZE", raising=False)
    tp, jp = _picks(n=100_000, d=1024)
    assert tp.predicted_cost.candidates == jp.predicted_cost.candidates
    reason = next(r for name, _, r in tp.predicted_cost.candidates if name == "sketched")
    assert "KEYSTONE_SKETCH_MIN_WIDTH" in reason


def test_stream_solver_collapse_by_width(monkeypatch):
    monkeypatch.delenv("KEYSTONE_SKETCH_SIZE", raising=False)
    est = LeastSquaresEstimator(reg=1e-3, device=CPU)
    assert not isinstance(est._stream_solver(4096), SketchedLeastSquaresEstimator)
    inner = est._stream_solver(sketch_min_width())
    assert isinstance(inner, SketchedLeastSquaresEstimator) and inner.device == CPU
    est._tuned_sketch_size = 384
    assert est._stream_solver(8192)._resolve_sketch_size(8192) == 384


# ------------------------------------------------------------ the slice

SLICE_N, SLICE_D, SLICE_K, SLICE_CHUNK, SLICE_S, SLICE_LATENT = 1024, 512, 8, 128, 64, 16


def _slice_problem():
    """The JAX bench leg's rows (``bench.py::_bench_sketched``) scaled down
    to d = 512: low-rank rows shifted +8σ so the rectifier is the
    identity on them."""
    rng = np.random.default_rng(31)
    z = rng.normal(size=(SLICE_N, SLICE_LATENT)).astype(np.float32)
    basis = rng.normal(size=(SLICE_LATENT, SLICE_D)).astype(np.float32) / np.sqrt(SLICE_LATENT)
    x = (z @ basis + 0.01 * rng.normal(size=(SLICE_N, SLICE_D)) + 8.0).astype(np.float32)
    w = rng.normal(size=(SLICE_D, SLICE_K)).astype(np.float32) / np.sqrt(SLICE_D)
    return x, (np.maximum(x, 0.0) @ w).astype(np.float32)


def test_slice_pipeline_fits_through_the_sketched_rung_like_jax(monkeypatch):
    """LinearRectifier(0) → LeastSquaresEstimator(reg=1e-3) through
    ``Pipeline.fit()`` in both packages: the optimizer picks the sketched
    rung, the streaming batch streams it, the plans are equal, and the
    predictions agree to 1e-5."""
    monkeypatch.setenv("KEYSTONE_SKETCH_MIN_WIDTH", "256")
    monkeypatch.setenv("KEYSTONE_SKETCH_SIZE", str(SLICE_S))
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(SLICE_CHUNK))
    x, y = _slice_problem()
    weights = dict(num_machines=1)
    tpipe = LinearRectifier(0.0).to_pipeline().then_label_estimator(
        LeastSquaresEstimator(reg=1e-3, weights=tcost.CostWeights(*WEIGHTS), device=CPU, **weights),
        _t(x), _t(y),
    )
    fits = tnames.metric(tnames.SKETCH_FITS)
    before = fits.value(variant="countsketch")
    tfit = tpipe.fit()
    assert fits.value(variant="countsketch") - before == 1
    tplan = sorted(str(op.label) for op in tfit.graph.operators.values())
    jexec.PipelineEnv.reset()
    try:
        jpipe = JLinearRectifier(0.0).to_pipeline().then_label_estimator(
            JLeastSquares(reg=1e-3, weights=jcost.CostWeights(*WEIGHTS), **weights),
            JArrayDataset(x), JArrayDataset(y),
        )
        jfit = jpipe.fit()
        jplan = sorted(str(op.label) for op in jfit.graph.operators.values())
        want = np.asarray(jfit.apply_batch(JArrayDataset(x[:256])).data)[:256]
    finally:
        jexec.PipelineEnv.reset()
    assert tplan == jplan
    got = tfit.apply_batch(_t(x[:256])).data.numpy()[:256]
    assert _rel(got, want) <= MODEL_TOL
    assert _rel(got, y[:256]) < 0.05
