"""The port's single-device linear algebra (``keystone_tpu_torch/parallel/linalg.py``)
on the CPU: mirrors of the single-device cases of ``tests/parallel/test_linalg.py``,
each also held against the JAX package's function on the same numpy
inputs (the JAX side on the conftest's 8-device CPU mesh), plus the
precision modes and the plain versions of the solver-product binding
(``ops/cuda/gemm.py``).

Tolerances: the mirrors keep the JAX tests' bounds against numpy; parity
with the JAX package is ≤ 1e-5 relative unless a case says otherwise.
Where the port and the JAX package run different factorisations (QR's
row signs, the JAX package's 8-shard reductions) the comparison is of
sign-free quantities.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keystone_tpu.parallel import linalg as jlinalg
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch.ops.cuda import gemm as tgemm
from keystone_tpu_torch.parallel import linalg as tlinalg

CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def centered_ridge(a, b, lam):
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ac, bc = a64 - a64.mean(0), b64 - b64.mean(0)
    return np.linalg.solve(ac.T @ ac + lam * np.eye(a.shape[1]), ac.T @ bc)


# ---------------------------------------------------------------- gram/solve


def test_gram(mesh):
    a, b = rand((64, 12)), rand((64, 3), seed=1)
    ata, atb = tlinalg.gram(t(a), t(b))
    np.testing.assert_allclose(ata.numpy(), a.T @ a, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(atb.numpy(), a.T @ b, rtol=1e-4, atol=1e-4)
    with use_mesh(mesh):
        j_ata, j_atb = jlinalg.gram(jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(b))
    assert rel(ata, j_ata) <= TOL and rel(atb, j_atb) <= TOL


def test_gram_with_padding(mesh):
    a = rand((61, 5))
    padded = np.concatenate([a, np.zeros((3, 5), np.float32)])
    ata, none = tlinalg.gram(t(padded))
    assert none is None
    np.testing.assert_allclose(ata.numpy(), a.T @ a, rtol=1e-4, atol=1e-4)
    with use_mesh(mesh):
        A = jlinalg.prepare_row_sharded(a)
        assert A.shape[0] == 64
        j_ata, _ = jlinalg.gram(A)
    assert rel(ata, j_ata) <= TOL
    assert rel(tlinalg.gram(t(a))[0], ata) <= TOL


def test_normal_equations_solve(mesh):
    a, x_true = rand((128, 10)), rand((10, 4), seed=2)
    b = a @ x_true
    x = tlinalg.normal_equations_solve(t(a), t(b), reg=0.0)
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-2, atol=1e-3)
    with use_mesh(mesh):
        jx = jlinalg.normal_equations_solve(
            jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(b), reg=0.0
        )
    assert rel(x, jx) <= 1e-4  # unregularised: cond(AᵀA) ≈ 10 amplifies the shards' order


def test_ridge_matches_closed_form(mesh):
    a, b, lam = rand((96, 8)), rand((96, 2), seed=3), 0.5
    expected = np.linalg.solve(a.T @ a + lam * np.eye(8), a.T @ b)
    x = tlinalg.normal_equations_solve(t(a), t(b), reg=lam)
    np.testing.assert_allclose(x.numpy(), expected, rtol=1e-3, atol=1e-3)
    with use_mesh(mesh):
        jx = jlinalg.normal_equations_solve(
            jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(b), reg=lam
        )
    assert rel(x, jx) <= TOL


def test_tsqr_r_gram_identity(mesh):
    """RᵀR = AᵀA (QR's row signs cancel), for the port and the JAX package."""
    a = rand((80, 6))
    r = tlinalg.tsqr_r(t(a)).numpy()
    np.testing.assert_allclose(r.T @ r, a.T @ a, rtol=1e-3, atol=1e-3)
    with use_mesh(mesh):
        jr = np.asarray(jlinalg.tsqr_r(jlinalg.prepare_row_sharded(a)))
    assert rel(r.T @ r, jr.T @ jr) <= TOL
    np.testing.assert_allclose(np.abs(np.diag(r)), np.abs(np.diag(jr)), rtol=1e-5)


def test_tsqr_svd_matches_local(mesh):
    a = rand((120, 7))
    _, s_expected, vt_expected = np.linalg.svd(a, full_matrices=False)
    s, vt = (v.numpy() for v in tlinalg.tsqr_svd(t(a)))
    np.testing.assert_allclose(s, s_expected, rtol=1e-3, atol=1e-3)
    with use_mesh(mesh):
        js, jvt = (np.asarray(v) for v in jlinalg.tsqr_svd(jlinalg.prepare_row_sharded(a)))
    assert rel(s, js) <= TOL
    for i in range(7):  # rows of Vᵀ are defined up to sign
        vi = vt[i]
        assert min(np.linalg.norm(vi - vt_expected[i]), np.linalg.norm(vi + vt_expected[i])) < 1e-2
        assert min(np.linalg.norm(vi - jvt[i]), np.linalg.norm(vi + jvt[i])) < 1e-4


# ----------------------------------------------------------------------- BCD


def test_bcd_converges_to_ridge_solution(mesh):
    a, x_true, lam = rand((160, 12)), rand((12, 3), seed=5), 0.1
    y = a @ x_true
    expected = np.linalg.solve(a.T @ a + lam * np.eye(12), a.T @ y)
    w = tlinalg.block_coordinate_descent(t(a), t(y), reg=lam, num_epochs=30, block_size=4)
    np.testing.assert_allclose(w.numpy(), expected, rtol=5e-2, atol=5e-3)
    with use_mesh(mesh):
        jw = jlinalg.block_coordinate_descent(
            jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(y),
            reg=lam, num_epochs=30, block_size=4,
        )
    assert rel(w, jw) <= TOL


def test_bcd_single_block_equals_exact(mesh):
    a, y, lam = rand((64, 6)), rand((64, 2), seed=7), 0.3
    expected = np.linalg.solve(a.T @ a + lam * np.eye(6), a.T @ y)
    w = tlinalg.block_coordinate_descent(t(a), t(y), reg=lam, num_epochs=1, block_size=6)
    np.testing.assert_allclose(w.numpy(), expected, rtol=1e-3, atol=1e-3)
    with use_mesh(mesh):
        jw = jlinalg.block_coordinate_descent(
            jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(y),
            reg=lam, num_epochs=1, block_size=6,
        )
    assert rel(w, jw) <= TOL


def test_rematerialized_bcd_matches_materialized(mesh):
    """Blocks computed by ``block_fn`` on demand (here slices of shared
    numpy panels; on the JAX side a ``lax.dynamic_slice`` at the shard's
    row offset) give the materialized BCD's weights."""
    n, d, k, bs = 64, 24, 3, 8
    a, y = rand((n, d), seed=21), rand((n, k), seed=9)
    panels = [a[:, b * bs : (b + 1) * bs] for b in range(d // bs)]

    def block_fn(b, row_offset, rows):
        assert row_offset == 0 and rows == n
        return t(panels[b])

    w_remat = tlinalg.block_coordinate_descent_rematerialized(
        block_fn, t(y), reg=0.1, num_epochs=2, block_size=bs, num_blocks=d // bs
    )
    w_mat = tlinalg.block_coordinate_descent(t(a), t(y), reg=0.1, num_epochs=2, block_size=bs)
    assert rel(w_remat, w_mat) <= 1e-6

    stacked = jnp.asarray(np.stack(panels))  # (num_blocks, n, bs)

    def j_block_fn(b, row_offset, rows):
        return jax.lax.dynamic_slice(stacked[b], (row_offset, 0), (rows, bs))

    with use_mesh(mesh):
        jw = jlinalg.block_coordinate_descent_rematerialized(
            j_block_fn, jlinalg.prepare_row_sharded(y), reg=0.1, num_epochs=2,
            block_size=bs, num_blocks=d // bs,
        )
    assert rel(w_remat, jw) <= TOL


def test_rematerialized_bcd_rejects_a_wrong_panel():
    y = t(rand((16, 2)))
    with pytest.raises(ValueError, match="block_fn"):
        tlinalg.block_coordinate_descent_rematerialized(
            lambda b, off, rows: torch.zeros(rows, 3), y, reg=0.1, num_epochs=1,
            block_size=4, num_blocks=2,
        )


def test_streaming_bcd_matches_in_core(mesh):
    """Host-streamed feature blocks (centering and a short last block
    included) solve to the in-core BCD's predictions, in the port and in
    the JAX package."""
    from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JEstimator
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator

    rng = np.random.default_rng(0)
    n, d, k = 200, 50, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    fits = {}
    for stream in (False, True):
        before = tlinalg.block_coordinate_descent_streaming.blocks_uploaded
        model = BlockLeastSquaresEstimator(
            16, num_iter=3, reg=0.1, device="cpu", host_streaming=stream
        ).fit(ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"))
        uploaded = tlinalg.block_coordinate_descent_streaming.blocks_uploaded - before
        assert uploaded == (3 * 4 if stream else 0)  # 3 epochs × 4 blocks
        fits[stream] = model.apply_arrays(t(x)).numpy()
    np.testing.assert_allclose(fits[True], fits[False], atol=1e-5)
    with use_mesh(mesh):
        j = JEstimator(16, num_iter=3, reg=0.1, host_streaming=True).fit(
            JArrayDataset(x), JArrayDataset(y)
        )
        jp = np.asarray(j.apply_arrays(jnp.asarray(x)))
    assert rel(fits[True], jp) <= TOL


def test_streaming_bcd_improves_residual_over_epochs(mesh):
    rng = np.random.default_rng(1)
    n, d, k = 160, 24, 2
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = x @ rng.normal(size=(d, k)).astype(np.float32)
    w1, mu_a, mu_b = tlinalg.block_coordinate_descent_streaming(
        x, y, reg=1e-6, num_epochs=1, block_size=8, device="cpu"
    )
    w5, _, _ = tlinalg.block_coordinate_descent_streaming(
        t(x), t(y), reg=1e-6, num_epochs=5, block_size=8, device="cpu"
    )
    xc, yc = x - mu_a.numpy(), y - mu_b.numpy()
    r1 = np.linalg.norm(xc @ w1.numpy() - yc)
    r5 = np.linalg.norm(xc @ w5.numpy() - yc)
    assert r5 < r1 and r5 < 1e-2 * np.linalg.norm(yc)
    with use_mesh(mesh):
        jw5, jmu_a, jmu_b = jlinalg.block_coordinate_descent_streaming(
            x, y, reg=1e-6, num_epochs=5, block_size=8, mesh=mesh
        )
    assert rel(mu_a, jmu_a) <= 1e-6 and rel(mu_b, jmu_b) <= 1e-6
    # Five epochs at λ = 1e-6 amplify the shards' summation order.
    assert rel(w5, jw5) <= 1e-4


def test_streaming_bcd_without_centering_and_num_examples():
    """``center=False`` keeps zero means; ``num_examples`` masks pad rows."""
    x, y = rand((40, 6), seed=4), rand((40, 2), seed=5)
    w, mu_a, mu_b = tlinalg.block_coordinate_descent_streaming(
        x, y, reg=0.2, num_epochs=1, block_size=6, center=False, device="cpu"
    )
    assert not mu_a.any() and not mu_b.any()
    np.testing.assert_allclose(
        w.numpy(), np.linalg.solve(x.T @ x + 0.2 * np.eye(6), x.T @ y), rtol=1e-4, atol=1e-5
    )
    padded_x = np.concatenate([x, np.full((8, 6), 9.0, np.float32)])
    padded_y = np.concatenate([y, np.full((8, 2), 9.0, np.float32)])
    wp, _, _ = tlinalg.block_coordinate_descent_streaming(
        padded_x, padded_y, reg=0.2, num_epochs=1, block_size=6, num_examples=40, device="cpu"
    )
    wc, _, _ = tlinalg.block_coordinate_descent_streaming(
        x, y, reg=0.2, num_epochs=1, block_size=6, device="cpu"
    )
    assert rel(wp, wc) <= 1e-6


# ------------------------------------------------------------ refined solve


def test_centered_solve_refined_matches_unrefined_when_well_conditioned(mesh):
    a, b = rand((120, 10)), rand((120, 3), seed=4)
    w0, mu_a, mu_b = tlinalg.centered_solve_refined(t(a), t(b), 120, 0.1)
    w2, _, _ = tlinalg.centered_solve_refined(t(a), t(b), 120, 0.1, refine_steps=2)
    expect = centered_ridge(a, b, 0.1)
    np.testing.assert_allclose(w0.numpy(), expect, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(w2.numpy(), expect, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mu_a.numpy(), a.mean(0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mu_b.numpy(), b.mean(0), rtol=1e-4, atol=1e-5)
    with use_mesh(mesh):
        A, B = jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(b)
        jw2, jmu_a, _ = jlinalg.centered_solve_refined(A, B, 120, 0.1, refine_steps=2)
    assert rel(w2, jw2) <= TOL and rel(mu_a, jmu_a) <= 1e-6


def test_refinement_recovers_ill_conditioned_accuracy(mesh):
    rng = np.random.default_rng(0)
    n, d, k = 512, 32, 4
    u, _ = np.linalg.qr(rng.normal(size=(n, d)))
    v, _ = np.linalg.qr(rng.normal(size=(d, d)))
    a = ((u * np.logspace(0, -3, d)) @ v.T).astype(np.float32)
    b = (a @ rng.normal(size=(d, k)) + 0.01 * rng.normal(size=(n, k))).astype(np.float32)
    lam = 1e-8
    w64 = centered_ridge(a, b, lam)
    w0, _, _ = tlinalg.centered_solve_refined(t(a), t(b), n, lam, refine_steps=0)
    w2, _, _ = tlinalg.centered_solve_refined(t(a), t(b), n, lam, refine_steps=2)
    e0, e2 = rel(w0, w64), rel(w2, w64)
    assert e2 < 0.05 * e0 and e2 < 1e-4, (e0, e2)
    with use_mesh(mesh):
        jw2, _, _ = jlinalg.centered_solve_refined(
            jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(b), n, lam, refine_steps=2
        )
    # Both refined solutions sit at the float64 one's roundoff: compare
    # their distances to it, not each other bit for bit.
    assert rel(jw2, w64) < 1e-4 and abs(e2 - rel(jw2, w64)) < 1e-4


def test_refine_guard_falls_back_to_ieee_gram_on_stalled_refinement(mesh, monkeypatch):
    """The fast Gram corrupted through ``_TEST_GRAM_PERTURB``: without
    refinement the solve is garbage; with two steps refinement stalls and
    the guard re-solves from an IEEE Gram — the same outcome as the JAX
    package's guard on the same inputs."""
    a, b = rand((160, 10)), rand((160, 3), seed=9)
    expect = centered_ridge(a, b, 0.1)
    monkeypatch.setattr(tlinalg, "_TEST_GRAM_PERTURB", 100.0)
    monkeypatch.setattr(jlinalg, "_TEST_GRAM_PERTURB", 100.0)
    w_bad, _, _ = tlinalg.centered_solve_refined(
        t(a), t(b), 160, 0.1, gram_precision="default", refine_steps=0
    )
    checks, fired = tlinalg.centered_solve_refined.guard_checks, tlinalg.centered_solve_refined.guard_fired
    w, _, _ = tlinalg.centered_solve_refined(t(a), t(b), 160, 0.1, gram_precision="default", refine_steps=2)
    assert tlinalg.centered_solve_refined.guard_checks == checks + 1
    assert tlinalg.centered_solve_refined.guard_fired == fired + 1
    bad_err, guard_err = rel(w_bad, expect), rel(w, expect)
    assert bad_err > 0.2, bad_err
    np.testing.assert_allclose(w.numpy(), expect, rtol=1e-4, atol=1e-5)
    assert guard_err < 1e-3 * bad_err
    with use_mesh(mesh):
        jw, _, _ = jlinalg.centered_solve_refined(
            jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(b), 160, 0.1,
            gram_precision=jax.lax.Precision.DEFAULT, refine_steps=2,
        )
    assert rel(w, jw) <= TOL


def test_refine_guard_stays_quiet_on_healthy_refinement():
    a, b = rand((160, 10)), rand((160, 3), seed=9)
    checks, fired = tlinalg.centered_solve_refined.guard_checks, tlinalg.centered_solve_refined.guard_fired
    tlinalg.centered_solve_refined(t(a), t(b), 160, 0.1, gram_precision="default", refine_steps=2)
    tlinalg.centered_solve_refined(t(a), t(b), 160, 0.1, gram_precision="highest", refine_steps=2)
    # Only the non-IEEE Gram is guarded, and healthy refinement passes.
    assert tlinalg.centered_solve_refined.guard_checks == checks + 1
    assert tlinalg.centered_solve_refined.guard_fired == fired


def test_centered_solve_refined_with_row_padding(mesh):
    a, b = rand((61, 6)), rand((61, 2), seed=5)
    pa = np.concatenate([a, np.zeros((3, 6), np.float32)])
    pb = np.concatenate([b, np.zeros((3, 2), np.float32)])
    w, mu_a, _ = tlinalg.centered_solve_refined(t(pa), t(pb), 61, 0.05, refine_steps=2)
    np.testing.assert_allclose(w.numpy(), centered_ridge(a, b, 0.05), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mu_a.numpy(), a.mean(0), rtol=1e-5, atol=1e-6)
    with use_mesh(mesh):
        jw, _, _ = jlinalg.centered_solve_refined(
            jlinalg.prepare_row_sharded(a), jlinalg.prepare_row_sharded(b), 61, 0.05, refine_steps=2
        )
    assert rel(w, jw) <= TOL


# ------------------------------------------------------- streaming Gram steps


def test_gram_stream_block_step_sums_to_the_full_step():
    """A loop over ``block_index`` rebuilds :func:`gram_stream_step`'s
    carry, and each block equals the JAX package's block step."""
    rng = np.random.default_rng(3)
    n, d, k, b = 96, 24, 3, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    full = tlinalg.gram_stream_step(tlinalg.gram_stream_init(d, k, CPU), t(x), t(y))
    blocks = []
    for i in range(d // b):
        carry = (torch.zeros(b, d), torch.zeros(b, k), torch.zeros(b), torch.zeros(k))
        blocks.append(tlinalg.gram_stream_block_step(carry, t(x), t(y), i))
        j_carry = (jnp.zeros((b, d)), jnp.zeros((b, k)), jnp.zeros((b,)), jnp.zeros((k,)))
        j_block = jlinalg.gram_stream_block_step(j_carry, jnp.asarray(x), jnp.asarray(y), jnp.int32(i))
        for got, want in zip(blocks[-1], j_block):
            assert rel(got, want) <= TOL or not np.asarray(want).any()
    for leaf in range(3):
        assert rel(torch.cat([blk[leaf] for blk in blocks]), full[leaf]) <= 1e-6
    assert rel(sum(blk[3] for blk in blocks), full[3]) <= 1e-6
    assert tlinalg.gram_stream_step.model_layout == jlinalg.gram_stream_step.model_layout
    assert tlinalg.gram_stream_step.model_block_step is tlinalg.gram_stream_block_step


def test_gram_of_block_sparse_matrix_matches_the_jax_package():
    """``gram`` on a host BlockSparseMatrix goes through ``bsr_gram_totals``
    (the plain ELL version on the CPU; the JAX package's lax path)."""
    from keystone_tpu.utils.sparse import BlockSparseMatrix as JBSR
    from keystone_tpu_torch.utils.sparse import BlockSparseMatrix

    rng = np.random.default_rng(8)
    a = rng.normal(size=(48, 40)).astype(np.float32)
    a[rng.random((48, 40)) < 0.8] = 0.0
    b = rng.normal(size=(48, 3)).astype(np.float32)
    bsr = BlockSparseMatrix.from_dense(a, (8, 8))
    g, none = tlinalg.gram(bsr, device="cpu")
    g2, c = tlinalg.gram(bsr, t(b))
    assert none is None
    np.testing.assert_allclose(g.numpy(), a.T @ a, rtol=1e-5, atol=1e-4)
    assert rel(g2, g) == 0.0 and rel(c, a.T @ b) <= TOL
    jg, jc = jlinalg.gram(JBSR.from_dense(a, (8, 8)), jnp.asarray(b))
    assert rel(g, jg) <= TOL and rel(c, jc) <= TOL


# ----------------------------------------------------------- precision modes


@pytest.mark.parametrize(
    "mode,kind", [("highest", "ieee_fp32"), ("high", "tf32"), ("default", "bf16"), ("refine", "ieee_fp32")]
)
def test_precision_for_mode_and_per_call_read(mode, kind, monkeypatch):
    monkeypatch.delenv("KEYSTONE_SOLVER_PRECISION", raising=False)
    assert tlinalg.precision_for_mode(mode) == kind
    assert tlinalg.precision() == "ieee_fp32"  # the default mode, refine
    with tlinalg.solver_mode_scope(mode):
        assert tlinalg.precision() == kind
    monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", mode.upper())
    assert tlinalg.precision() == kind


def test_cpu_products_ignore_the_mode(monkeypatch):
    """CPU tensors run ``torch.matmul`` in their own type under every
    mode, as the JAX package's CPU backend does."""
    a, b = t(rand((300, 16))), t(rand((300, 5), seed=1))
    want_t = a.T @ b
    for mode in ("highest", "high", "default", "refine"):
        monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", mode)
        assert torch.equal(tlinalg.mm(a.T, b), a.T @ b)
        assert rel(tlinalg.mm_t(a, b), want_t) <= 1e-6
        out = torch.ones(16, 5)
        assert rel(tlinalg.addmm_t_(out, a, b), want_t + 1) <= 1e-6


def test_unknown_precisions_raise(monkeypatch):
    with pytest.raises(ValueError, match="precision"):
        tlinalg.centered_solve_refined(t(rand((8, 2))), t(rand((8, 1))), 8, 0.1, gram_precision="fast")
    monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", "fastest")
    with pytest.raises(ValueError, match="KEYSTONE_SOLVER_PRECISION"):
        tlinalg.mm(torch.ones(2, 2), torch.ones(2, 2))


# ------------------------------------------------ plain versions of the binding


def test_round_inputs_rounds_to_nearest_even():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, float("inf"), float("nan"), -2.5])
    got = tgemm.round_inputs(x, "tf32")
    assert got[:3].tolist() == [1.0, 1.0 + 2**-9, 1.0] and got[3] == float("inf")
    assert torch.isnan(got[4]) and got[5] == -2.5
    bf = tgemm.round_inputs(torch.tensor([1.0 + 2**-8, 1.0 + 3 * 2**-8]), "bf16")
    assert bf.tolist() == [1.0, 1.0 + 2**-6]
    assert tgemm.round_inputs(x, "ieee_fp32") is x


@pytest.mark.parametrize("kind,bound", [("ieee_fp32", 1e-6), ("tf32", 2e-3), ("bf16", 1e-2)])
def test_reference_products_against_float64(kind, bound):
    """The plain versions' error from float64 at the kind's rounding: TF32
    keeps 10 mantissa bits, bf16 7."""
    a, b = rand((5000, 24), seed=11), rand((5000, 6), seed=12)
    want = a.astype(np.float64).T @ b.astype(np.float64)
    got = tgemm.gemm_tn_chunked(t(a), t(b), kind)
    assert rel(got, want) <= bound
    assert rel(tgemm.gemm(t(a).T, t(b), kind), got) <= 1e-5
    if kind != "ieee_fp32":
        assert rel(got, want) > 1e-6  # the inputs really were rounded


def test_reference_dtypes_and_accumulation():
    a, b = t(rand((100, 4))), t(rand((100, 3), seed=1))
    assert tgemm.gemm_tn_chunked(a.double(), b.double(), "bf16").dtype == torch.float64
    bf = tgemm.gemm_tn_chunked(a.bfloat16(), b.bfloat16())
    assert bf.dtype == torch.float32
    out = torch.ones(4, 3)
    acc = tgemm.gemm_tn_chunked(a, b, "ieee_fp32", out=out, beta=1.0, rows=7)
    assert acc is out and rel(acc, a.T @ b + 1) <= 1e-6
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        tgemm.gemm(a.half(), b.half().T)
    with pytest.raises(ValueError, match="kind"):
        tgemm.gemm(a.T, b, "fp16")
