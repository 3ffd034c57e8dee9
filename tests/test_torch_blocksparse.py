"""Port parity: the BSR container, the padded-ELL matmul's plain version
and the block-sparse Gram statistics of ``keystone_tpu_torch`` against
``keystone_tpu`` (its ``impl="lax"`` path, which the JAX package's own
CPU tests use). Tolerance: 1e-5 relative Frobenius, fp32 sums in
another order."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from keystone_tpu.ops.pallas import blocksparse as jbs
from keystone_tpu.utils.sparse import BlockSparseMatrix as JBSR
from keystone_tpu_torch.ops.cuda import blocksparse as tbs
from keystone_tpu_torch.utils import sparse as tsparse
from keystone_tpu_torch.utils.sparse import BlockSparseMatrix as TBSR

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _block_sparse_dense(rng, m, d, bm, bn, density):
    nbr, nbc = -(-m // bm), -(-d // bn)
    keep = rng.rand(nbr, nbc) < density
    keep[0, 0] = True
    vals = rng.randn(nbr, bm, nbc, bn).astype(np.float32)
    return (vals * keep[:, None, :, None]).reshape(nbr * bm, nbc * bn)[:m, :d]


def _with_duplicates(cls, rng, shape, block_shape):
    """A BSR with two stored blocks at the same (i, j) and an empty row."""
    bm, bn = block_shape
    indptr = np.array([0, 3, 3, 5], np.int32)
    indices = np.array([1, 1, 0, 2, 0], np.int32)
    blocks = rng.randn(5, bm, bn).astype(np.float32)
    return cls(shape, block_shape, indptr, indices, blocks)


def _assert_same_bsr(t, j):
    assert t.shape == j.shape and t.block_shape == j.block_shape
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.blocks, j.blocks)


# ----------------------------------------------------------- the container


@pytest.mark.parametrize("m,d,bm,bn", [(50, 70, 8, 16), (32, 48, 4, 8), (17, 9, 3, 5)])
def test_container_exactly_equal(m, d, bm, bn):
    rng = np.random.RandomState(m + d)
    a = _block_sparse_dense(rng, m, d, bm, bn, 0.3)
    t = TBSR.from_dense(a, (bm, bn))
    j = JBSR.from_dense(a, (bm, bn))
    _assert_same_bsr(t, j)
    rows = [sp.csr_matrix(a[i : i + 1]) for i in range(m)]
    _assert_same_bsr(TBSR.from_csr_rows(rows, (bm, bn)), JBSR.from_csr_rows(rows, (bm, bn)))
    _assert_same_bsr(t.transpose(), j.transpose())
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    np.testing.assert_array_equal(t.to_dense(), a)
    for ell_t, ell_j in zip(t.to_ell(), j.to_ell()):
        np.testing.assert_array_equal(ell_t, ell_j)
    for ell_t, ell_j in zip(t.to_ell(7), j.to_ell(7)):
        np.testing.assert_array_equal(ell_t, ell_j)
    assert t.density() == j.density()
    assert t.blocks_skipped() == j.blocks_skipped()
    assert tsparse.is_sparse_rows(rows) and not tsparse.is_sparse_rows([])


def test_container_duplicate_blocks_accumulate():
    t = _with_duplicates(TBSR, np.random.RandomState(3), (20, 19), (8, 7))
    j = _with_duplicates(JBSR, np.random.RandomState(3), (20, 19), (8, 7))
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    _assert_same_bsr(t.transpose(), j.transpose())
    np.testing.assert_array_equal(t.transpose().to_dense(), j.to_dense().T)
    for ell_t, ell_j in zip(t.to_ell(), j.to_ell()):
        np.testing.assert_array_equal(ell_t, ell_j)
    dense = tbs.bsr_to_dense(t, torch.device("cpu"))
    assert tuple(dense.shape) == t.padded_shape
    np.testing.assert_array_equal(dense.numpy()[:20, :19], j.to_dense())


@pytest.mark.parametrize("threshold", [0.01, 0.2, 0.99])
def test_density_probe_matches(threshold):
    from keystone_tpu.utils.sparse import block_density_exceeds as j_exceeds

    a = _block_sparse_dense(np.random.RandomState(5), 130, 64, 8, 16, 0.2)
    assert tsparse.block_density_exceeds(a, (8, 16), threshold, band_rows=2) == j_exceeds(
        a, (8, 16), threshold, band_rows=2
    )


# ------------------------------------------------------------ ELL matmul


@pytest.mark.parametrize("bm,bn", [(8, 8), (16, 16), (4, 8), (8, 4)])
def test_ell_matmul_reference_matches_jax_lax(bm, bn):
    rng = np.random.RandomState(bm * 31 + bn)
    a = _block_sparse_dense(rng, 6 * bm, 9 * bn, bm, bn, 0.3)
    idx, blocks = JBSR.from_dense(a, (bm, bn)).to_ell(max_blocks_per_row=6)
    b = rng.randn(9 * bn, 37).astype(np.float32)
    ref = np.asarray(jbs.ell_matmul(idx, blocks, b, impl="lax"))
    out = tbs.ell_matmul(torch.from_numpy(idx), torch.from_numpy(blocks), torch.from_numpy(b))
    assert _rel(out.numpy(), ref) <= TOL
    assert _rel(out.numpy(), a @ b) <= TOL


def test_ell_matmul_cpu_uses_plain_version_without_counting():
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(rng.randint(0, 3, size=(2, 2)).astype(np.int32))
    blocks = torch.from_numpy(rng.randn(2, 2, 3, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(15, 4).astype(np.float32))
    before = tbs.ell_matmul.launches
    out = tbs.ell_matmul(idx, blocks, b)
    assert tbs.ell_matmul.launches == before
    torch.testing.assert_close(out, tbs.ell_matmul_reference(idx, blocks, b), rtol=0, atol=0)


def test_ell_matmul_rejects_bad_arguments():
    idx = torch.zeros(2, 2, dtype=torch.int32)
    blocks = torch.zeros(2, 2, 3, 5)
    with pytest.raises(TypeError):
        tbs.ell_matmul(idx.long(), blocks, torch.zeros(15, 4))
    with pytest.raises(ValueError, match="multiple of bn"):
        tbs.ell_matmul(idx, blocks, torch.zeros(14, 4))
    with pytest.raises(ValueError, match="do not match"):
        tbs.ell_matmul(torch.zeros(3, 2, dtype=torch.int32), blocks, torch.zeros(15, 4))


@pytest.mark.parametrize("bm,bn", [(8, 8), (4, 8)])
def test_bsr_matmul_matches_jax(bm, bn):
    rng = np.random.RandomState(11)
    a = _block_sparse_dense(rng, 45, 70, bm, bn, 0.25)
    b = rng.randn(70, 6).astype(np.float32)
    ref = np.asarray(jbs.bsr_matmul(JBSR.from_dense(a, (bm, bn)), b, impl="lax"))
    out = tbs.bsr_matmul(TBSR.from_dense(a, (bm, bn)), torch.from_numpy(b))
    assert out.shape == (45, 6)
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("dense_given", [False, True])
def test_bsr_gram_totals_match_jax(dense_given):
    rng = np.random.RandomState(7)
    a = _block_sparse_dense(rng, 61, 50, 8, 16, 0.3)
    y = rng.randn(61, 3).astype(np.float32)
    j = jbs.bsr_gram_totals(
        JBSR.from_dense(a, (8, 16)), y, a_dense=a if dense_given else None, impl="lax"
    )
    t = tbs.bsr_gram_totals(
        TBSR.from_dense(a, (8, 16)), torch.from_numpy(y),
        a_dense=torch.from_numpy(a) if dense_given else None,
    )
    for got, want, exact in zip(t, j, (a.T @ a, a.T @ y, a.sum(0), y.sum(0))):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), np.asarray(want)) <= TOL
        assert _rel(got.numpy(), exact) <= TOL


def test_block_shape_and_threshold_knobs_match(monkeypatch):
    for raw in ("", "16x16", "8x128", "4", "3,5"):
        monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_BLOCK", raw)
        for d in (None, 16, 512, 16384):
            assert tbs.default_block_shape(d) == jbs.default_block_shape(d)
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_THRESHOLD", "0.125")
    assert tbs.density_threshold() == jbs.density_threshold() == 0.125
    monkeypatch.delenv("KEYSTONE_BLOCKSPARSE_THRESHOLD")
    assert tbs.density_threshold() == tbs.DEFAULT_DENSITY_THRESHOLD == jbs.DEFAULT_DENSITY_THRESHOLD
    assert tbs.DEFAULT_BLOCK_SHAPE == jbs.DEFAULT_BLOCK_SHAPE
