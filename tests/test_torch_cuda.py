"""The CUDA ELL kernel against its plain PyTorch version, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` and skip on a
machine without a card. On the card, where JAX is not installed (so the
JAX test configuration in ``tests/conftest.py`` is left out):
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``.
Tolerance: 1e-5 relative Frobenius (fp32 FFMA in another summation
order than the plain version's batched products). With ``counts``, the
padded slots hold NaN blocks and out-of-range indices: the kernel must
never read them.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops.cuda import blocksparse as tbs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(rng, nbr, k_slots, bm, bn, nbc, n, duplicates=False):
    idx = rng.randint(0, nbc, size=(nbr, k_slots)).astype(np.int32)
    if duplicates:
        idx[:, 1] = idx[:, 0]
    blocks = rng.randn(nbr, k_slots, bm, bn).astype(np.float32)
    blocks[:, -1] = 0.0  # padded slot: zero block at column 0
    idx[:, -1] = 0
    b = rng.randn(nbc * bn, n).astype(np.float32)
    return idx, blocks, b


@pytest.mark.parametrize(
    "nbr,k_slots,bm,bn,nbc,n,duplicates",
    [
        (64, 5, 16, 16, 40, 300, False),
        (64, 5, 16, 16, 40, 20, True),
        (9, 4, 128, 8, 12, 131, False),
        (7, 3, 3, 5, 6, 37, True),
        (5, 3, 1, 1, 9, 1, False),
        (4, 2, 128, 128, 3, 64, True),
        (3, 2, 17, 33, 4, 130, False),
    ],
)
def test_kernel_matches_plain_version(cuda, nbr, k_slots, bm, bn, nbc, n, duplicates):
    rng = np.random.RandomState(nbr * 7 + bm)
    idx, blocks, b = (
        torch.from_numpy(a).to(cuda)
        for a in _case(rng, nbr, k_slots, bm, bn, nbc, n, duplicates)
    )
    before = tbs.ell_matmul.launches
    out = tbs.ell_matmul(idx, blocks, b)
    torch.cuda.synchronize()
    assert tbs.ell_matmul.launches == before + 1
    ref = tbs.ell_matmul_reference(idx, blocks, b)
    rel = float((out - ref).norm() / ref.norm().clamp_min(1e-30))
    assert rel <= 1e-5


def test_kernel_unaligned_operand_takes_scalar_path(cuda):
    rng = np.random.RandomState(1)
    idx, blocks, b = _case(rng, 16, 3, 16, 16, 8, 64)
    storage = torch.zeros(b.size + 1, device=cuda)
    b_off = storage[1:].view(b.shape)  # 4-byte offset: not 16-byte aligned
    b_off.copy_(torch.from_numpy(b))
    idx_t, blocks_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(blocks).to(cuda)
    out = tbs.ell_matmul(idx_t, blocks_t, b_off)
    ref = tbs.ell_matmul_reference(idx_t, blocks_t, b_off)
    assert float((out - ref).norm() / ref.norm()) <= 1e-5


def _counts_case(rng, nbr, k_slots, bm, bn, nbc, n):
    """Random per-row counts in 0..K (row 0 empty, row 1 full), junk —
    NaN blocks and out-of-range indices included — in the padded slots."""
    counts = rng.randint(0, k_slots + 1, size=nbr).astype(np.int32)
    counts[0], counts[min(1, nbr - 1)] = 0, k_slots
    idx = rng.randint(0, nbc, size=(nbr, k_slots)).astype(np.int32)
    blocks = rng.randn(nbr, k_slots, bm, bn).astype(np.float32)
    padded = np.arange(k_slots)[None, :] >= counts[:, None]
    blocks[padded] = np.nan
    idx[padded] = rng.choice([-7, nbc, 10**6], size=int(padded.sum()))
    b = rng.randn(nbc * bn, n).astype(np.float32)
    return idx, blocks, b, counts


@pytest.mark.parametrize(
    "nbr,k_slots,bm,bn,nbc,n,unaligned",
    [
        (64, 6, 16, 16, 40, 300, False),  # wide tile, ragged N
        (64, 6, 16, 16, 40, 20, False),   # narrow tile, N = 20
        (13, 4, 16, 16, 9, 1, False),     # narrow tile, N = 1
        (9, 4, 128, 8, 12, 131, False),   # bm = 128, bn = 8
        (5, 3, 3, 5, 6, 37, False),
        (16, 3, 16, 16, 8, 64, True),     # b not 16-byte aligned
        (16, 3, 16, 16, 8, 20, True),
    ],
)
def test_kernel_with_counts_skips_padded_slots(cuda, nbr, k_slots, bm, bn, nbc, n, unaligned):
    rng = np.random.RandomState(nbr * 13 + n)
    idx, blocks, b, counts = _counts_case(rng, nbr, k_slots, bm, bn, nbc, n)
    b_t = torch.from_numpy(b).to(cuda)
    if unaligned:
        storage = torch.zeros(b.size + 1, device=cuda)
        b_t = storage[1:].view(b.shape).copy_(b_t)
    idx_t, blocks_t, counts_t = (torch.from_numpy(a).to(cuda) for a in (idx, blocks, counts))
    before = tbs.ell_matmul.launches
    out = tbs.ell_matmul(idx_t, blocks_t, b_t, counts_t)
    torch.cuda.synchronize()
    assert tbs.ell_matmul.launches == before + 1
    ref = tbs.ell_matmul_reference(idx_t, blocks_t, b_t, counts_t)
    assert torch.isfinite(out).all()
    assert torch.equal(out.view(nbr, bm, n)[0], torch.zeros(bm, n, device=cuda))
    rel = float((out - ref).norm() / ref.norm().clamp_min(1e-30))
    assert rel <= 1e-5


def test_kernel_rejects_bad_counts(cuda):
    idx = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    blocks = torch.ones(2, 3, 4, 4, device=cuda)
    b = torch.ones(8, 5, device=cuda)
    for counts, err in (
        (torch.tensor([1, 4], dtype=torch.int32, device=cuda), ValueError),
        (torch.tensor([1, -1], dtype=torch.int32, device=cuda), ValueError),
        (torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda), ValueError),
        (torch.tensor([1, 2], device=cuda), TypeError),
        (torch.tensor([1, 2], dtype=torch.int32), ValueError),  # on the CPU
    ):
        with pytest.raises(err):
            tbs.ell_matmul(idx, blocks, b, counts)


def test_kernel_rejects_tiles_above_128(cuda):
    idx = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tiles 1..128"):
        tbs.ell_matmul(idx, torch.ones(1, 1, 129, 4, device=cuda), torch.ones(4, 3, device=cuda))


def test_streamed_fit_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """A streamed fit on the card (pinned uploads on a copy stream, a
    padded tail chunk) against the same streamed fit on the CPU, and the
    same fit from CUDA-resident records and labels, which uploads
    nothing. Tolerance 1e-5 relative (the streamed-fit parity bound)."""
    from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats.core import LinearRectifier, RandomSignNode
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    chunk, d, k = 512, 96, 3
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(chunk))
    monkeypatch.setenv("KEYSTONE_STREAM_PREFETCH", "2")
    rng = np.random.default_rng(17)
    n = 8 * chunk + 100
    imgs = rng.integers(0, 256, size=(n, d), dtype=np.uint8)
    y = (imgs.astype(np.float32) @ rng.normal(size=(d, k)).astype(np.float32)).astype(np.float32)

    def fit(device, data, labels):
        PipelineEnv.reset()
        feat = RandomSignNode.create(d, seed=3, device=device).to_pipeline().then(LinearRectifier(0.0))
        est = BlockLeastSquaresEstimator(64, num_iter=1, reg=1e-3, device=device)
        fitted = feat.then_label_estimator(est, data, labels).fit()
        preds = fitted.apply_batch(ArrayDataset(imgs.astype(np.float32), device=device)).data
        return preds.cpu().double(), last_stream_report()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    records = ObjectDataset([imgs[i] for i in range(n)])
    host_y = ArrayDataset(y, device="cpu")
    try:
        card, rep = fit(cuda, records, host_y)
        cpu, cpu_rep = fit(torch.device("cpu"), records, host_y)
        resident, res_rep = fit(cuda, ArrayDataset(imgs, device=cuda), ArrayDataset(y, device=cuda))
    finally:
        PipelineEnv.reset()
    assert rel(card, cpu) <= 1e-5 and rel(resident, card) <= 1e-5
    per_chunk = chunk * d + chunk * k * 4 + chunk * 4  # uint8 rows + labels + mask
    assert rep.chunks == cpu_rep.chunks == 9
    assert rep.bytes_transferred == cpu_rep.bytes_transferred == 9 * per_chunk
    assert rep.compiles_steady_state == 0 and rep.overlap_ok()
    assert rep.device_overlap_ok is True and len(rep.device_copy_ms) == 9
    assert res_rep.chunks == 9 and res_rep.bytes_transferred == 0
    assert res_rep.device_overlap_ok is None
