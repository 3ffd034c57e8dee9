"""Per-row slot counts in the padded-ELL matmul of ``keystone_tpu_torch``,
held against the JAX package's ``impl="lax"`` path on the same numpy
inputs. With counts, slot k of block row i takes part only where
k < counts[i], so whatever lies in the padded slots is never read.
Tolerance: 1e-5 relative Frobenius (fp32 sums in another order)."""

import numpy as np
import pytest
import torch

from keystone_tpu.ops.pallas import blocksparse as jbs
from keystone_tpu.utils.sparse import BlockSparseMatrix as JBSR
from keystone_tpu_torch.ops.cuda import blocksparse as tbs
from keystone_tpu_torch.utils.sparse import BlockSparseMatrix as TBSR

TOL = 1e-5
CPU = torch.device("cpu")
TILES = [(8, 8), (16, 16), (4, 8), (8, 4)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _dense_with_empty_rows(rng, bm, bn, nbr=7, nbc=9, density=0.35):
    """Block-sparse dense matrix whose block rows 1 and 4 are empty."""
    keep = rng.rand(nbr, nbc) < density
    keep[0, :2] = True
    keep[[1, 4]] = False
    vals = rng.randn(nbr, bm, nbc, bn).astype(np.float32)
    return (vals * keep[:, None, :, None]).reshape(nbr * bm, nbc * bn)


def _bsr(cls, case, rng, bm, bn):
    if case == "duplicates":  # two stored blocks at (0, 1), an empty row 1
        indptr = np.array([0, 3, 3, 5], np.int32)
        indices = np.array([1, 1, 0, 2, 0], np.int32)
        blocks = rng.randn(5, bm, bn).astype(np.float32)
        return cls((3 * bm, 3 * bn), (bm, bn), indptr, indices, blocks)
    return cls.from_dense(_dense_with_empty_rows(rng, bm, bn), (bm, bn))


def _ell(bsr, max_blocks):
    """(indices, blocks, counts) of ``bsr`` on the CPU: counts from
    ``ell_tensors``, the slots padded by ``to_ell(max_blocks)``."""
    _, _, counts = tbs.ell_tensors(bsr, CPU)
    idx, blocks = (torch.from_numpy(a) for a in bsr.to_ell(max_blocks))
    return idx, blocks, counts


def _with_junk(idx, blocks, counts, nbc, junk, rng):
    """Copies of the ELL with the padded slots filled with junk: random
    blocks (or NaN) at random indices, out-of-range ones included."""
    idx, blocks = idx.copy(), blocks.copy()
    padded = np.arange(idx.shape[1])[None, :] >= counts[:, None]
    fill = rng.randn(int(padded.sum()), *blocks.shape[2:]).astype(np.float32)
    blocks[padded] = np.nan if junk == "nan" else fill
    idx[padded] = rng.choice([0, nbc - 1, nbc, -3], size=int(padded.sum()))
    return idx, blocks


# ------------------------------------------------------------ ell_tensors


@pytest.mark.parametrize("case,max_blocks", [("empty_rows", None), ("duplicates", None),
                                             ("empty_rows", 7), ("duplicates", 6)])
def test_ell_tensors_counts_are_stored_blocks_in_leading_slots(case, max_blocks):
    rng = np.random.RandomState(3)
    bsr = _bsr(TBSR, case, rng, 8, 4)
    idx, blocks, counts = tbs.ell_tensors(bsr, CPU)
    if max_blocks is not None:
        idx, blocks, _ = _ell(bsr, max_blocks)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.diff(bsr.indptr))
    k_slots = idx.shape[1]
    assert k_slots == max(int(counts.max()), max_blocks or 1)
    for i in range(bsr.n_block_rows):
        lo, hi = bsr.indptr[i], bsr.indptr[i + 1]
        n = hi - lo
        np.testing.assert_array_equal(idx[i, :n].numpy(), bsr.indices[lo:hi])
        np.testing.assert_array_equal(blocks[i, :n].numpy(), bsr.blocks[lo:hi])
        assert not idx[i, n:].any() and not blocks[i, n:].any()  # padding: zero at column 0
    jidx, jblocks = _bsr(JBSR, case, np.random.RandomState(3), 8, 4).to_ell(max_blocks)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(blocks.numpy(), jblocks)


# ------------------------------------------------------------ plain version


@pytest.mark.parametrize("bm,bn", TILES)
def test_reference_with_counts_matches_jax_lax(bm, bn):
    rng = np.random.RandomState(bm * 31 + bn)
    a = _dense_with_empty_rows(rng, bm, bn)
    bsr = TBSR.from_dense(a, (bm, bn))
    idx, blocks, counts = _ell(bsr, 6)
    b = rng.randn(a.shape[1], 37).astype(np.float32)
    ref = np.asarray(jbs.ell_matmul(idx.numpy(), blocks.numpy(), b, impl="lax"))
    out = tbs.ell_matmul(idx, blocks, torch.from_numpy(b), counts)
    assert _rel(out.numpy(), ref) <= TOL
    assert _rel(out.numpy(), a @ b) <= TOL


@pytest.mark.parametrize("junk", ["random", "nan"])
@pytest.mark.parametrize("bm,bn", TILES)
def test_counts_never_read_padded_slots(bm, bn, junk):
    rng = np.random.RandomState(bm * 7 + bn)
    a = _dense_with_empty_rows(rng, bm, bn)
    bsr = TBSR.from_dense(a, (bm, bn))
    idx, blocks, counts = (t.numpy() for t in _ell(bsr, 6))
    b = rng.randn(a.shape[1], 19).astype(np.float32)
    want = np.asarray(jbs.ell_matmul(idx, blocks, b, impl="lax"))  # padded slots zeroed
    jidx, jblocks = _with_junk(idx, blocks, counts, bsr.n_block_cols, junk, rng)
    out = tbs.ell_matmul(
        torch.from_numpy(jidx), torch.from_numpy(jblocks), torch.from_numpy(b),
        torch.from_numpy(counts),
    )
    assert np.isfinite(out.numpy()).all()
    assert _rel(out.numpy(), want) <= TOL
    assert not out.numpy().reshape(-1, bm, 19)[[1, 4]].any()  # rows of count 0 are zero


def test_counts_and_all_slots_differ_only_on_nonfinite_panel_zero():
    """The documented difference: a padded slot (zero block at column 0)
    adds 0·NaN = NaN without counts, and nothing with them."""
    rng = np.random.RandomState(1)
    idx = torch.tensor([[2, 0], [1, 0]], dtype=torch.int32)
    blocks = torch.from_numpy(rng.randn(2, 2, 3, 4).astype(np.float32))
    blocks[:, 1] = 0.0
    counts = torch.tensor([1, 1], dtype=torch.int32)
    b = torch.from_numpy(rng.randn(12, 5).astype(np.float32))
    torch.testing.assert_close(tbs.ell_matmul(idx, blocks, b), tbs.ell_matmul(idx, blocks, b, counts))
    b[0, 0] = float("nan")  # panel 0, read only by the padded slots
    assert torch.isnan(tbs.ell_matmul(idx, blocks, b)).any()
    assert torch.isfinite(tbs.ell_matmul(idx, blocks, b, counts)).all()


# ------------------------------------------------------------ BSR operations


@pytest.fixture
def counts_seen(monkeypatch):
    """Record the ``counts`` each ELL matmul of the BSR operations
    receives."""
    seen = []
    real = tbs._ell_matmul_host_counts

    def spy(indices, blocks, b, counts):
        seen.append(counts)
        return real(indices, blocks, b, counts)

    monkeypatch.setattr(tbs, "_ell_matmul_host_counts", spy)
    return seen


@pytest.mark.parametrize("case", ["empty_rows", "duplicates"])
def test_bsr_matmul_passes_counts_and_matches_jax(case, counts_seen):
    jbsr = _bsr(JBSR, case, np.random.RandomState(9), 8, 4)
    tbsr = _bsr(TBSR, case, np.random.RandomState(9), 8, 4)
    b = np.random.RandomState(2).randn(tbsr.shape[1], 6).astype(np.float32)
    ref = np.asarray(jbs.bsr_matmul(jbsr, b, impl="lax"))
    out = tbs.bsr_matmul(tbsr, torch.from_numpy(b))
    assert [c is not None for c in counts_seen] == [True]
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("case", ["empty_rows", "duplicates"])
def test_bsr_gram_totals_pass_counts_and_match_jax(case, counts_seen):
    jbsr = _bsr(JBSR, case, np.random.RandomState(4), 8, 4)
    tbsr = _bsr(TBSR, case, np.random.RandomState(4), 8, 4)
    y = np.random.RandomState(5).randn(tbsr.shape[0], 3).astype(np.float32)
    want = jbs.bsr_gram_totals(jbsr, y, impl="lax")
    got = tbs.bsr_gram_totals(tbsr, torch.from_numpy(y))
    assert [c is not None for c in counts_seen] == [True, True]
    a = tbsr.to_dense()
    for g, w, exact in zip(got, want, (a.T @ a, a.T @ y, a.sum(0), y.sum(0))):
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel(g.numpy(), np.asarray(w)) <= TOL
        assert _rel(g.numpy(), exact) <= TOL


# ------------------------------------------------------------ the wrapper


@pytest.mark.parametrize(
    "counts,err,match",
    [
        (torch.tensor([1, 2], dtype=torch.int64), TypeError, "int32 counts"),
        (torch.tensor([1.0, 2.0]), TypeError, "int32 counts"),
        (torch.tensor([1, 2, 0], dtype=torch.int32), ValueError, "do not match"),
        (torch.tensor([[1, 2]], dtype=torch.int32), ValueError, "do not match"),
        (torch.tensor([1, -1], dtype=torch.int32), ValueError, "0..3"),
        (torch.tensor([4, 0], dtype=torch.int32), ValueError, "0..3"),
    ],
)
def test_wrapper_rejects_bad_counts(counts, err, match):
    idx = torch.zeros(2, 3, dtype=torch.int32)
    blocks = torch.zeros(2, 3, 4, 4)
    with pytest.raises(err, match=match):
        tbs.ell_matmul(idx, blocks, torch.zeros(8, 5), counts)
