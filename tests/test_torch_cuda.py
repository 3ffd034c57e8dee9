"""The CUDA ELL kernel and the solver-product binding against their plain
PyTorch versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` and skip on a
machine without a card. On the card, where JAX is not installed (so the
JAX test configuration in ``tests/conftest.py`` is left out):
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``.
Tolerance: 1e-5 relative Frobenius (fp32 FFMA in another summation
order than the plain version's batched products). With ``counts``, the
padded slots hold NaN blocks and out-of-range indices: the kernel must
never read them.

The port's fits record observations in the profile store. The JAX test
configuration that points ``KEYSTONE_PROFILE_STORE`` at a temporary file
is not loaded on the card, so this module does that itself.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops.cuda import blocksparse as tbs

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _private_profile_store(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "profile-store.jsonl"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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


# ------------------------------------------------ solver-product binding
#
# Bounds: each product kind against its plain version (inputs rounded as
# the kind rounds them, then an fp32 product) ≤ 1e-5 relative for
# products of random matrices — summation order and the tensor cores' own
# accumulation (on an H100: 0.0 for ieee_fp32, ≤ 7e-7 for tf32). A Gram's
# diagonal sums are all positive, so the tensor cores' accumulation
# rounding does not average out there: ≤ 2e-5 for tf32 and bf16 Grams
# (measured 6.1e-6 and 8.9e-6 at 65,536 rows). Against float64 the kinds
# sit at their rounding.


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("kind", ["ieee_fp32", "tf32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(257, 1000, 131), (64, 4096, 256)])
def test_binding_matches_its_plain_version(cuda, kind, m, k, n):
    from keystone_tpu_torch.ops.cuda import gemm as tgemm

    g = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn(m, k, device=cuda, generator=g)
    at = torch.randn(k, m, device=cuda, generator=g)
    b = torch.randn(k, n, device=cuda, generator=g)
    c0 = torch.randn(m, n, device=cuda, generator=g)
    before = tgemm.launches[kind]
    plain = tgemm.gemm(a, b, kind)
    transposed = tgemm.gemm(at.T, b, kind)
    accumulated = tgemm.gemm(a, b, kind, out=c0.clone(), beta=1.0)
    torch.cuda.synchronize()
    assert tgemm.launches[kind] == before + 3
    assert _rel(plain, tgemm.gemm_reference(a, b, kind)) <= 1e-5
    assert _rel(transposed, tgemm.gemm_reference(at.T, b, kind)) <= 1e-5
    assert _rel(accumulated, c0 + tgemm.gemm_reference(a, b, kind)) <= 1e-5
    exact = a.double() @ b.double()
    assert _rel(plain, exact) <= {"ieee_fp32": 1e-6, "tf32": 2e-3, "bf16": 1e-2}[kind]


@pytest.mark.parametrize("kind", ["ieee_fp32", "tf32", "bf16"])
def test_chunked_gram_matches_its_plain_version(cuda, kind):
    from keystone_tpu_torch.ops.cuda import gemm as tgemm

    x = torch.randn(16384 + 77, 256, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    got = tgemm.gemm_tn_chunked(x, x, kind)
    assert _rel(got, tgemm.gemm_tn_chunked_reference(x, x, kind)) <= (1e-6 if kind == "ieee_fp32" else 2e-5)
    exact = x.double().T @ x.double()
    highest = tgemm.gemm_tn_chunked(x, x, "ieee_fp32")
    assert _rel(highest, exact) <= 1e-6
    if kind == "bf16":  # one bf16 pass: far from float64, not at fp32's error
        assert _rel(got, exact) >= 10 * _rel(highest, exact)


def test_binding_runs_on_the_current_stream_and_thread(cuda):
    import threading

    from keystone_tpu_torch.ops.cuda import gemm as tgemm

    x = torch.randn(8192, 128, device=cuda)
    want = x.double().T @ x.double()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        on_stream = tgemm.gemm_tn_chunked(x, x)
    stream.synchronize()
    assert _rel(on_stream, want) <= 1e-6
    seen = {}

    def worker():
        with torch.cuda.stream(torch.cuda.Stream()):
            seen["out"] = tgemm.gemm_tn_chunked(x, x)
            torch.cuda.current_stream().synchronize()

    thread = threading.Thread(target=worker)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive() and _rel(seen["out"], want) <= 1e-6


def test_float64_runs_ieee_fp64_through_mm(cuda):
    from keystone_tpu_torch.ops.cuda import gemm as tgemm
    from keystone_tpu_torch.parallel import linalg

    a = torch.randn(300, 40, device=cuda, dtype=torch.float64)
    b = torch.randn(40, 7, device=cuda, dtype=torch.float64)
    before = tgemm.launches["fp64"]
    for mode in ("default", "highest"):
        with linalg.solver_mode_scope(mode):
            assert _rel(linalg.mm(a, b), (a.cpu() @ b.cpu()).to(cuda)) <= 1e-12
            assert _rel(linalg.mm_t(a, a), (a.cpu().T @ a.cpu()).to(cuda)) <= 1e-12
    assert tgemm.launches["fp64"] == before + 4
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        linalg.mm(a.half(), b.half())


def test_solver_precision_survives_a_global_tf32_switch(cuda):
    """``torch.set_float32_matmul_precision("high")`` after the port is
    imported leaves its solver products in IEEE fp32: a small MNIST fit
    scores within 1e-5 of the same fit with the global at "highest"."""
    from keystone_tpu_torch.ops.cuda import gemm as tgemm
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig, build_featurizer, build_pipeline, synthetic_mnist,
    )
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    cfg = MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=10.0)
    scores = {}
    for precision in ("highest", "high"):
        torch.set_float32_matmul_precision(precision)
        try:
            PipelineEnv.reset()
            before = tgemm.launches["ieee_fp32"]
            fitted = build_pipeline(cfg, synthetic_mnist(1024, seed=0, device=cuda), device=cuda).fit()
            assert tgemm.launches["ieee_fp32"] > before
            assert torch.backends.cuda.matmul.allow_tf32 == (precision == "high")
            mapper = next(
                m for op in fitted.graph.operators.values()
                for m in getattr(op, "members", (op,)) if isinstance(m, BlockLinearMapper)
            )
            test = synthetic_mnist(256, seed=1, device=cuda)
            scores[precision] = mapper.apply_arrays(build_featurizer(cfg, device=cuda)(test.data).get().data)
        finally:
            torch.set_float32_matmul_precision("highest")
            PipelineEnv.reset()
    assert _rel(scores["high"], scores["highest"]) <= 1e-5


def test_lbfgs_products_stay_ieee_fp32_under_a_global_tf32_switch(cuda):
    """The L-BFGS loop's two products per objective evaluation go through
    the solver binding at the mode's kind (IEEE fp32 under ``refine``),
    never TF32, whatever the global says: the fit under "high" equals the
    fit under "highest" to 1e-5, and each evaluation makes two ieee_fp32
    calls and no tf32 call."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.cuda import gemm as tgemm
    from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSEstimator
    from keystone_tpu_torch.ops.learning.logistic import LogisticRegressionEstimator

    rng = np.random.default_rng(0)
    x = rng.normal(size=(8192, 256)).astype(np.float32)
    y = (x @ rng.normal(size=(256, 4)) + 0.1 * rng.normal(size=(8192, 4))).astype(np.float32)
    cls = np.argmax(y, axis=1).astype(np.int32)
    fits = {}
    for precision in ("highest", "high"):
        torch.set_float32_matmul_precision(precision)
        try:
            for name, make, labels in (
                ("dense", lambda: DenseLBFGSEstimator(reg=1e-3, num_iterations=20, device=cuda), y),
                ("logistic", lambda: LogisticRegressionEstimator(4, reg=1e-3, num_iterations=20, device=cuda), cls),
            ):
                before = dict(tgemm.launches)
                model = make().fit(ArrayDataset(x, device=cuda), ArrayDataset(labels, device=cuda))
                torch.cuda.synchronize()
                calls = {k: tgemm.launches[k] - before[k] for k in before}
                assert calls["ieee_fp32"] == 2 * model.lbfgs["evaluations"], calls
                assert calls["tf32"] == calls["bf16"] == 0, calls
                assert torch.backends.cuda.matmul.allow_tf32 == (precision == "high")
                fits[precision, name] = model.weights
        finally:
            torch.set_float32_matmul_precision("highest")
    for name in ("dense", "logistic"):
        assert _rel(fits["high", name], fits["highest", name]) <= 1e-5


# ------------------------------------------------ allocation failures, OOM ladder


def test_binding_allocation_failure_raises_out_of_memory(cuda):
    """cuBLAS's own text for ``CUBLAS_STATUS_ALLOC_FAILED`` matches no
    OOM pattern; the binding's wrapper raises ``OutOfMemoryError`` for it
    (and for a failed CUDA allocation), which the ladder degrades on."""
    from keystone_tpu_torch.ops.cuda import _build
    from keystone_tpu_torch.ops.cuda import gemm as tgemm
    from keystone_tpu_torch.reliability import ErrorClass, classify_error, is_oom

    lib = tgemm._lib()
    texts = {}
    for code in sorted(tgemm.ALLOC_FAILURES):
        texts[code] = lib.keystone_gemm_error(code).decode()
        with pytest.raises(torch.cuda.OutOfMemoryError) as info:
            tgemm._raise_on(code, lib, "gemm")
        assert is_oom(info.value) and texts[code] in str(info.value)
    alloc = tgemm.CUBLAS_ERR_BASE + 3
    assert texts[alloc] == "the resource allocation failed"
    assert classify_error(RuntimeError(texts[alloc])) is ErrorClass.PERMANENT
    assert texts[_build.CUDA_ERROR_MEMORY_ALLOCATION] == "out of memory"
    execution_failed = tgemm.CUBLAS_ERR_BASE + 13
    with pytest.raises(RuntimeError) as info:
        tgemm._raise_on(execution_failed, lib, "gemm")
    assert classify_error(info.value) is ErrorClass.PERMANENT


def test_injected_oom_degrades_the_sparse_fit_through_the_kernel(cuda, monkeypatch):
    """The block-sparse fit under an OOM injected at its first attempt:
    the ladder halves the block, the kernel launches only in the second
    attempt (twice), and the model equals a direct fit at the half block
    (≤ 1e-5 relative, measured with the kernel on both sides)."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.reliability import FaultSpec, injected

    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_BLOCK", "8x16")
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_THRESHOLD", "0.3")
    rng = np.random.RandomState(3)
    keep = rng.rand(64, 16) < 0.2
    keep[0, 0] = True
    x = (rng.randn(64, 8, 16, 16).astype(np.float32) * keep[:, None, :, None]).reshape(512, 256)
    y = rng.randn(512, 2).astype(np.float32)
    before = tbs.ell_matmul.launches
    with injected(FaultSpec(match="BlockLeastSquaresEstimator.solve", kind="oom", first_n=1)):
        model = BlockLeastSquaresEstimator(64, reg=1e-3, device=cuda).fit(
            ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"))
    assert tbs.ell_matmul.launches - before == 2
    assert model.degradation["rung"] == 32 and model.degradation["first_rung"] == 64
    direct = BlockLeastSquaresEstimator(32, reg=1e-3, device=cuda).fit(
        ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"))
    assert _rel(model.weights, direct.weights) <= 1e-5


def test_sketch_hash_and_carry_on_the_card_match_the_cpu(cuda):
    """CountSketch buckets and signs are equal on the card and the CPU;
    the carries (atomic scatter order on the card) agree to 1e-6."""
    from keystone_tpu_torch.sketch import core

    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 64)).astype(np.float32)
    y = rng.normal(size=(300, 3)).astype(np.float32)
    mask = core.index_mask(1000, 1300, torch.device("cpu"))
    for variant in core.VARIANTS:
        step = core.sketch_stream_step(variant, 3)
        want = step(core.sketch_stream_init(128, 64, 3, torch.device("cpu")),
                    torch.from_numpy(x), torch.from_numpy(y), mask)
        got = step(core.sketch_stream_init(128, 64, 3, cuda), torch.from_numpy(x).to(cuda),
                   torch.from_numpy(y).to(cuda), mask.to(cuda))
        for g, w in zip(got, want):
            assert float((g.cpu() - w).norm() / w.norm()) <= 1e-6
    bucket, sign = core.countsketch_hash(mask.to(cuda), 4096, 5)
    cpu_bucket, cpu_sign = core.countsketch_hash(mask, 4096, 5)
    assert torch.equal(bucket.cpu(), cpu_bucket) and torch.equal(sign.cpu(), cpu_sign)


def test_sketched_and_kernel_fits_on_the_card_match_the_cpu(cuda):
    """A streamed sketched fit (primal and dual finish) and a kernel ridge
    fit on the card against the same fits on the CPU: predictions ≤ 1e-5
    on well-conditioned rows."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.kernel import GaussianKernelGenerator, KernelRidgeRegression
    from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator
    from keystone_tpu_torch.workflow.streaming import ChunkStream

    rng = np.random.default_rng(1)
    x = rng.normal(size=(1024, 96)).astype(np.float32)
    y = (x @ rng.normal(size=(96, 4)) + 0.1 * rng.normal(size=(1024, 4))).astype(np.float32)
    cpu = torch.device("cpu")

    def rel(a, b):
        return float((a.cpu() - b.cpu()).norm() / b.cpu().norm())

    for s in (256, 64):
        models = [
            SketchedLeastSquaresEstimator(reg=1e-2, sketch_size=s, seed=2, device=dev).fit_stream(
                ChunkStream(ArrayDataset(x, device=dev), ArrayDataset(y, device=dev), (),
                            chunk_rows=128, device=dev))
            for dev in (cuda, cpu)
        ]
        preds = [m.apply_arrays(torch.from_numpy(x).to(m.weights.device)) for m in models]
        assert rel(preds[0], preds[1]) <= 1e-5
    krr = [
        KernelRidgeRegression(GaussianKernelGenerator(0.05, device=dev), 0.1, 128, 2, block_permuter=3).fit(
            ArrayDataset(x[:512], device=dev), ArrayDataset(y[:512], device=dev))
        for dev in (cuda, cpu)
    ]
    xt = torch.from_numpy(x[512:])
    assert rel(krr[0].apply_arrays(xt.to(cuda)), krr[1].apply_arrays(xt)) <= 1e-5


def _cifar_featurizer(device, num_filters=40, filter_block=16, seed=0):
    from keystone_tpu_torch.ops.images import Convolver, FusedConvFeaturizer, Pooler, SymmetricRectifier

    filters = np.random.default_rng(seed).normal(size=(num_filters, 108)).astype(np.float32) * 0.1
    return FusedConvFeaturizer(Convolver(filters, 3, device=device), SymmetricRectifier(alpha=0.25),
                               Pooler(13, 14, None, "sum"), filter_block=filter_block)


def test_conv_features_unchanged_under_a_global_tf32_switch(cuda):
    """The conv featurizer's products go through the solver binding at the
    mode's kind: switching ``cudnn.allow_tf32`` and
    ``cuda.matmul.allow_tf32`` on changes no feature (≤ 1e-6; the same
    calls are made, so they are expected bitwise equal)."""
    from keystone_tpu_torch.ops.cuda import gemm as tgemm

    fz = _cifar_featurizer(cuda)
    x = torch.from_numpy(np.random.default_rng(1).random((100, 32, 32, 3), dtype=np.float32) * 255).to(cuda)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, False
        before = tgemm.launches["ieee_fp32"]
        off = fz.apply_arrays(x)
        assert tgemm.launches["ieee_fp32"] > before
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        on = fz.apply_arrays(x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert _rel(on, off) <= 1e-6


def test_conv_block_fit_on_the_card_matches_the_cpu(cuda):
    """A small rematerializing conv-block fit (3 filter blocks, the last
    padded) on the card against the same fit on the CPU: predictions
    ≤ 1e-5; the featurizer's output ≤ 1e-5."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator

    cpu = torch.device("cpu")
    rng = np.random.default_rng(2)
    images = rng.random((96, 32, 32, 3), dtype=np.float32)
    y = rng.normal(size=(96, 4)).astype(np.float32)
    preds, feats = [], []
    for dev in (cuda, cpu):
        fz = _cifar_featurizer(dev)
        model = ConvBlockLeastSquaresEstimator(fz, block_size=8 * 16, num_iter=2, reg=1.0, image_chunk=40,
                                               device=dev).fit(ArrayDataset(images, device=dev),
                                                               ArrayDataset(y, device=dev))
        x = torch.from_numpy(images).to(dev)
        preds.append(model.apply_arrays(x).cpu())
        feats.append(fz.apply_arrays(x).cpu())
    assert _rel(feats[0], feats[1]) <= 1e-5
    assert _rel(preds[0], preds[1]) <= 1e-5


# ------------------------------------------------------------- the VOC path


@pytest.mark.parametrize(
    "row,k",
    [([0, 1, 1, 0, 1, 0, 0, 1], 3), ([0] * 10, 4), ([2.0, -1.0, 0.5, 0.5, 2.0, 7.0, 0.5, -1.0], 5)],
)
def test_top_k_orders_ties_lower_index_first_on_the_card(cuda, row, k):
    """The JAX package's ``lax.top_k`` order (lower index first among
    equal scores), on the card as on the CPU."""
    from keystone_tpu_torch.ops.util.labels import TopKClassifier

    scores = torch.tensor([row], dtype=torch.float32)
    order = sorted(range(len(row)), key=lambda i: (-row[i], i))[:k]
    got = TopKClassifier(k).apply_arrays(scores.to(cuda)).cpu()
    assert got.tolist() == [order]
    assert TopKClassifier(k).apply_arrays(scores).tolist() == [order]


@pytest.mark.parametrize("kind", ["ieee_fp32", "bf16"])
@pytest.mark.parametrize("transpose_a", [False, True])
def test_batched_binding_matches_its_plain_version(cuda, kind, transpose_a):
    """``gemm_batched`` (one strided batched cuBLAS call) against its plain
    version, with A as stored and as a transposed view (the Fisher
    statistics' [X | X∘X]ᵀ·q): ≤ 1e-5 relative, one launch counted."""
    from keystone_tpu_torch.ops.cuda import gemm as tgemm

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(5, 3001, 24) if transpose_a else (5, 24, 3001)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5, 3001, 17)).astype(np.float32))
    a_op = a.transpose(1, 2) if transpose_a else a
    before = tgemm.launches[kind]
    out = tgemm.gemm_batched(a_op.to(cuda), b.to(cuda), kind)
    torch.cuda.synchronize()
    assert tgemm.launches[kind] == before + 1
    assert out.shape == (5, 24, 17)
    assert _rel(out.cpu(), tgemm.gemm_batched_reference(a_op, b, kind)) <= 1e-5


def test_sift_and_fisher_vectors_unchanged_under_the_tf32_switches(cuda):
    """SIFT descriptors and Fisher vectors are bitwise equal with
    PyTorch's TF32 switches off and on (the convolutions and statistics go
    through the binding at an explicit kind), and within one quantization
    step of the CPU for ≥ 99.5% of entries, none further."""
    from keystone_tpu_torch.ops.images.fisher import FisherVector
    from keystone_tpu_torch.ops.images.sift import SIFTExtractor
    from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel

    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(4)
    x = np.stack([gaussian_filter(rng.random((96, 96)), 1.5) for _ in range(4)]).astype(np.float32)
    ext = SIFTExtractor(scale_step=0)
    gmm = GaussianMixtureModel(rng.normal(size=(128, 8)) * 20 + 40, rng.uniform(200, 400, size=(128, 8)),
                               np.full(8, 1 / 8), device=cuda)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    out = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
            desc = ext.apply_arrays(torch.from_numpy(x).to(cuda))
            out[flag] = (desc, FisherVector(gmm).apply_arrays(desc))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(out[False][0], out[True][0]) and torch.equal(out[False][1], out[True][1])
    diff = (out[False][0].cpu() - ext.apply_arrays(torch.from_numpy(x))).abs()
    assert float((diff <= 1).double().mean()) >= 0.995 and float(diff.max()) <= 1


def test_gmm_fit_on_the_card_matches_the_cpu(cuda):
    """The GMM fit (k-means++ seeding on the host, Lloyd and EM on the
    device) on the card against the CPU: the same EM iteration and update
    counts, parameters ≤ 1e-4 relative."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.obs.spans import tracing_session
    from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModelEstimator

    rng = np.random.default_rng(5)
    centres = rng.normal(size=(6, 8)) * 4.0
    x = (centres[rng.integers(0, 6, 4000)] + 0.6 * rng.normal(size=(4000, 8))).astype(np.float32)
    fits, counts = [], []
    for dev in (cuda, torch.device("cpu")):
        with tracing_session() as session:
            fits.append(GaussianMixtureModelEstimator(6, seed=1).fit(ArrayDataset(x, device=dev)))
        em = session.find("gmm:em")[0].attributes
        counts.append((em["iterations"], em["updates"]))
    assert counts[0] == counts[1]
    for name in ("means", "variances", "weights"):
        assert _rel(getattr(fits[0], name).cpu(), getattr(fits[1], name)) <= 1e-4


def test_lcs_on_the_card_matches_the_cpu_and_ignores_the_tf32_switches(cuda):
    """LCS descriptors (box means by ``avg_pool2d``, no convolution) on the
    card against the CPU: means ≤ 1e-5 relative to the largest, stds to an
    absolute 0.05 on the 0–255 scale (the cancellation in E[x²] − m²,
    ``tests/test_torch_imagenet.py``); bitwise equal with PyTorch's TF32
    switches off and on; the masked path's validity equal."""
    from keystone_tpu_torch.ops.images.lcs import LCSExtractor

    rng = np.random.default_rng(7)
    x = (rng.random((5, 96, 80, 3)) * 255).astype(np.float32)
    x[0, :30, :30] = 255.0
    ext = LCSExtractor()
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    out = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
            out[flag] = ext.apply_arrays(torch.from_numpy(x).to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(out[False], out[True])
    cpu = ext.apply_arrays(torch.from_numpy(x))
    card = out[False].cpu()
    assert float((card[..., 0::2] - cpu[..., 0::2]).abs().max()) <= 1e-5 * float(cpu.abs().max())
    assert float((card[..., 1::2] - cpu[..., 1::2]).abs().max()) <= 0.05
    dims = torch.tensor([[96, 80], [70, 64], [50, 51], [96, 40], [33, 80]])
    d_card, v_card = ext.apply_arrays_masked(torch.from_numpy(x).to(cuda), dims.to(cuda))
    d_cpu, v_cpu = ext.apply_arrays_masked(torch.from_numpy(x), dims)
    assert torch.equal(v_card.cpu(), v_cpu)
    assert float((d_card.cpu() - d_cpu).abs().max()) <= 0.05


def test_masked_sift_on_the_card_matches_the_cpu(cuda):
    """Masked SIFT over an edge-padded bucket on the card against the CPU:
    the reference's gate (≥ 99.5% of entries within 1, none further) and
    equal validity."""
    from keystone_tpu_torch.ops.images.sift import SIFTExtractor

    rng = np.random.default_rng(8)
    sizes = [(96, 90), (80, 96), (70, 70)]
    imgs = np.stack([np.pad(rng.random(s, dtype=np.float32), ((0, 96 - s[0]), (0, 96 - s[1])), mode="edge")
                     for s in sizes])
    dims = torch.tensor(sizes)
    ext = SIFTExtractor(scale_step=1)
    d_card, v_card = ext.apply_arrays_masked(torch.from_numpy(imgs).to(cuda), dims.to(cuda))
    d_cpu, v_cpu = ext.apply_arrays_masked(torch.from_numpy(imgs), dims)
    assert torch.equal(v_card.cpu(), v_cpu)
    diff = (d_card.cpu() - d_cpu).abs()
    assert float((diff <= 1).double().mean()) >= 0.995 and float(diff.max()) <= 1


@pytest.mark.parametrize("path", ["woodbury", "dense"])
def test_weighted_solve_on_the_card_matches_the_cpu(cuda, path, monkeypatch):
    """The mixture-weighted block solve on the card against the CPU, on
    each path, with the classes split over several groups: predictions
    ≤ 1e-4 relative (fp32 products and cuSOLVER factorizations in other
    orders on a system at λ = 1e-2), the absent class's intercept −1."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning import weighted

    rng = np.random.default_rng(9)
    n, d, classes = 600, 256, 40
    x = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, classes - 1, size=n)
    y = -np.ones((n, classes), np.float32)
    y[np.arange(n), labels] = 1.0
    monkeypatch.setattr(weighted, "CLASS_GROUP_BYTES", 8 << 20)
    preds = []
    for dev in (cuda, torch.device("cpu")):
        est = weighted.BlockWeightedLeastSquaresEstimator(128, 2, 1e-2, 0.25, solve_path=path)
        model = est.fit(ArrayDataset(x, device=dev), ArrayDataset(y, device=dev))
        assert est.last_solve_path == path
        assert float(model.intercept[classes - 1]) == -1.0
        preds.append(model.apply_arrays(torch.from_numpy(x).to(dev)).cpu())
    assert _rel(preds[0], preds[1]) <= 1e-4


def _flagship_buckets():
    from keystone_tpu_torch.data.buckets import bucketize_images

    rng = np.random.default_rng(10)
    records = [{"image": rng.integers(0, 256, (s, s, 3), dtype=np.uint8)} for s in (48, 64, 64, 80)]
    return bucketize_images(records, granularity=16, max_rows=4)


def test_streaming_encode_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The streaming flagship's fused encode on the card against the CPU,
    with the same codebooks (fitted on the CPU, carried by save → load):
    rows ≤ 1e-3 relative (the card's SIFT entries may sit one quantization
    step from the CPU's, which the signed Hellinger map amplifies), and
    the card's rows within 1e-5 of the op-by-op composition on the card
    is ``chip_smoke.py``'s gate."""
    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig
    from keystone_tpu_torch.pipelines.imagenet_streaming import StreamingFlagship

    buckets = _flagship_buckets()
    dicts = [{"image": b.images, "dims": b.dims} for b in buckets]
    fs_cpu = StreamingFlagship(ImageNetSiftLcsFVConfig(desc_dim=16, vocab_size=4), device="cpu")
    fs_cpu.fit_codebooks(dicts, per_image=16)
    path = str(tmp_path / "flagship.pkl")
    fs_cpu.save(path)
    fs_card, _ = StreamingFlagship.load(path, device=cuda)
    assert fs_card.codebooks.sift_pca.device.type == "cuda"
    on_card = fs_card.encode_buckets(dicts)
    assert _rel(torch.from_numpy(on_card), torch.from_numpy(fs_cpu.encode_buckets(dicts))) <= 1e-3


def test_synthetic_flagship_generator_on_the_card(cuda):
    """The on-device generator's templates on the card: the 8×8 fields
    bit for bit the CPU's (the threefry draw is integer arithmetic), the
    upsampled ones ≤ 2e-4 absolute from the CPU's; and the on-device run
    at the JAX test's small configuration learns its planted classes."""
    from keystone_tpu_torch.pipelines import imagenet_streaming as streaming

    labels = torch.tensor([0, 3, 17, 999])
    assert torch.equal(streaming.synth_templates(labels.to(cuda), 8).cpu(),
                       streaming.synth_templates(labels, 8))
    up = (streaming.synth_templates(labels.to(cuda), 256).cpu() - streaming.synth_templates(labels, 256))
    assert float(up.abs().max()) <= 2e-4
    out = streaming.run_flagship_ondevice(num_train=64, num_test=16, num_classes=4, image_size=48,
                                          batch=16, device=cuda)
    assert out["top5_err_percent"] <= 25.0 and out["fv_dim_combined"] == 4096


def test_checkpoint_written_from_cuda_tensors_loads_onto_the_card(cuda, tmp_path):
    from keystone_tpu_torch.ops.learning.linear import LinearMapper
    from keystone_tpu_torch.reliability.checkpoint import _MISS, CheckpointStore

    model = LinearMapper(torch.randn(64, 8, device=cuda), intercept=torch.randn(8, device=cuda))
    store = CheckpointStore(str(tmp_path), device=cuda)
    assert store.save(None, model, digest="abc")
    back = store.lookup(None, digest="abc")
    assert back is not _MISS and back.weights.is_cuda and back.intercept.is_cuda
    assert torch.equal(back.weights, model.weights)
    cpu_back = CheckpointStore(str(tmp_path), device="cpu").lookup(None, digest="abc")
    assert cpu_back.weights.device.type == "cpu" and torch.equal(cpu_back.weights, model.weights.cpu())


def test_dataset_fingerprint_of_a_card_dataset_copies_only_the_sampled_rows(cuda, monkeypatch):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.reliability import checkpoint, durable

    rows, width = 25_600, 1024  # 100 MiB of float32 on the card
    ds = ArrayDataset(torch.randn(rows, width, device=cuda))
    copied = []
    real = checkpoint._host_array

    def recording(value):
        if isinstance(value, torch.Tensor):
            copied.append(value.numel() * value.element_size())
        return real(value)

    monkeypatch.setattr(checkpoint, "_host_array", recording)
    fingerprint = durable.dataset_fingerprint(ds)
    assert sum(copied) <= durable.FINGERPRINT_SAMPLE_ROWS * width * 4
    host = ArrayDataset(ds.data.cpu())
    assert durable.dataset_fingerprint(host) == fingerprint


def test_kv305_resolves_on_a_binding_backed_linear_mapper(cuda):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator, LinearMapper
    from keystone_tpu_torch.workflow.verify import UNKNOWN, _apply_out_spec, verify_refit_publish

    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 16)).astype(np.float32)
    y = rng.normal(size=(512, 4)).astype(np.float32)
    incumbent = LinearMapEstimator(reg=1e-2, device=cuda).fit(ArrayDataset(x, device=cuda), ArrayDataset(y, device=cuda))
    example = np.zeros((16,), np.float32)
    gemm.reset_launches()
    spec = _apply_out_spec(incumbent, example)
    assert spec is not UNKNOWN and spec[0] == "arrays" and "(4,)" in spec[1]
    assert sum(gemm.launches.values()) >= 1  # the apply went through the binding
    drifted = LinearMapper(torch.randn(16, 5, device=cuda))
    (diag,) = verify_refit_publish(drifted, incumbent, example=example).errors()
    assert diag.code == "KV305"


def test_roofline_probe_on_the_card_stays_under_the_data_sheet(cuda, tmp_path, monkeypatch):
    """``obs/cost.py``'s probe on the card: every kind the binding offers
    measured, each under 1.05× the H100 SXM data sheet (the share
    ``chip_smoke.py`` gates), and stored under the card's name."""
    from keystone_tpu_torch.obs import cost, store

    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "ps.jsonl"))
    store.set_store(None)
    cost.set_roofline(None)
    roof = cost.get_roofline(refresh=True, device=cuda)
    try:
        assert roof.backend == f"cuda:{torch.cuda.get_device_name(cuda)}"
        sheet = {"ieee_fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp64": 67e12}
        for kind, peak in sheet.items():
            assert 0 < roof.peak_flops_by_kind[kind] <= 1.05 * peak
        assert 0 < roof.peak_bytes_per_s <= 1.05 * 3.35e12
        assert {k for k, _s, _m in store.get_store().entries(key_prefix="roofline:")} == {
            f"roofline:{roof.backend}"
        }
    finally:
        cost.reset_cost_observatory()
        store.set_store(None)


def test_ell_launch_facts_on_cuda_tensors_are_the_bound_counts(cuda):
    """The ELL wrapper's facts for a launch on the card: 2 × stored blocks
    × bm × bn × N FLOP and the bound's bytes, with the stored-block count
    read back from the card's counts only at finalize."""
    from keystone_tpu_torch.obs import cost
    from keystone_tpu_torch.ops.cuda import blocksparse as bs

    rng = np.random.RandomState(1)
    nbr, k, bm, bn, n, d_pad = 16, 6, 16, 16, 40, 64 * 16
    counts = torch.from_numpy(rng.randint(0, k + 1, nbr).astype(np.int32)).to(cuda)
    indices = torch.from_numpy(rng.randint(0, d_pad // bn, (nbr, k)).astype(np.int32)).to(cuda)
    blocks = torch.from_numpy(rng.randn(nbr, k, bm, bn).astype(np.float32)).to(cuda)
    b = torch.randn(d_pad, n, device=cuda)
    frame = cost.push_frame("node")
    before = bs.ell_matmul.launches
    try:
        bs.ell_matmul(indices, blocks, b, counts)
    finally:
        cost.pop_frame(frame)
    assert bs.ell_matmul.launches - before == 1
    _flops, _bytes, sites = cost._harvest_frame(frame)
    stored = int(counts.sum())
    assert sites["ell_matmul"]["flops"] == 2.0 * stored * bm * bn * n
    assert sites["ell_matmul"]["bytes"] == stored * 4 + nbr * 4 + stored * bm * bn * 4 + d_pad * n * 4 + nbr * bm * n * 4


def test_meta_twin_of_a_card_call_moves_no_counter_and_the_card_call_still_launches(cuda):
    """The wrappers' ``meta`` branch is a shape rule, not a fallback: the
    card call launches (its counter up by one) and agrees with the plain
    version; the same call on ``meta`` twins returns the card output's
    shape and dtype and moves no counter and no card byte."""
    from keystone_tpu_torch.ops.cuda import gemm

    rng = np.random.RandomState(3)
    idx, blocks, b = (torch.from_numpy(a).to(cuda) for a in _case(rng, 64, 5, 16, 16, 40, 300))
    counts = torch.full((64,), 4, dtype=torch.int32, device=cuda)
    a = torch.randn(300, 96, device=cuda)
    w = torch.randn(96, 40, device=cuda)
    meta = [torch.empty_like(t, device="meta") for t in (idx, blocks, b, counts, a, w)]
    torch.cuda.synchronize()
    ell_before, gemm_before = tbs.ell_matmul.launches, dict(gemm.launches)
    allocated = torch.cuda.memory_allocated()
    shapes = (
        tbs.ell_matmul(*meta[:4]),
        gemm.gemm(meta[4], meta[5]),
        gemm.gemm_tn_chunked(meta[4], meta[4]),
        gemm.gemm_batched(meta[4][None], meta[5][None]),
    )
    assert all(t.device.type == "meta" for t in shapes)
    assert tbs.ell_matmul.launches == ell_before and dict(gemm.launches) == gemm_before
    assert torch.cuda.memory_allocated() == allocated
    out = tbs.ell_matmul(idx, blocks, b, counts)
    prod = gemm.gemm(a, w)
    torch.cuda.synchronize()
    assert tbs.ell_matmul.launches == ell_before + 1
    assert gemm.launches["ieee_fp32"] == gemm_before["ieee_fp32"] + 1
    assert shapes[0].shape == out.shape and shapes[0].dtype == out.dtype
    assert shapes[1].shape == prod.shape and shapes[1].dtype == prod.dtype
    ref = tbs.ell_matmul_reference(idx, blocks, b, counts)
    assert float((out - ref).norm() / ref.norm()) <= 1e-5


def test_strict_fit_on_the_card_refuses_a_mis_sized_source_before_any_launch(cuda):
    """``Pipeline.fit``'s plan-time hook on card-resident data: a 783-wide
    MNIST source raises ``VerificationError`` (KV101) with no kernel
    launched, no binding call and no card byte allocated; the 784-wide
    one verifies clean and fits."""
    import os

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.data.loaders.csv import LabeledData
    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_pipeline
    from keystone_tpu_torch.workflow.verify import VerificationError

    rng = np.random.default_rng(0)
    labels = ArrayDataset(rng.integers(0, 10, 4096).astype(np.int32), device=cuda)
    config = MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=1.0)
    narrow = build_pipeline(
        config, LabeledData(labels, ArrayDataset(rng.standard_normal((4096, 783)).astype(np.float32), device=cuda)),
        device=cuda,
    )
    os.environ["KEYSTONE_VERIFY"] = "strict"
    try:
        torch.cuda.synchronize()
        before = (tbs.ell_matmul.launches, dict(gemm.launches), torch.cuda.memory_allocated())
        with pytest.raises(VerificationError, match="KV101"):
            narrow.fit()
        assert (tbs.ell_matmul.launches, dict(gemm.launches), torch.cuda.memory_allocated()) == before
        wide = LabeledData(labels, ArrayDataset(rng.standard_normal((4096, 784)).astype(np.float32), device=cuda))
        fitted = build_pipeline(config, wide, device=cuda).fit()
        assert fitted.apply_batch(wide.data).data.shape == (4096,)
    finally:
        os.environ.pop("KEYSTONE_VERIFY", None)


# ------------------------------------------------- the multi-device tier


def _card_mesh(shape=(8,), axes=("data",)):
    from keystone_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, axes, devices=[torch.device("cuda", 0)] * 8)


def test_collectives_on_8_shards_of_one_card(cuda):
    """Eight shards of ``cuda:0``: every collective keeps each shard on
    the card and equals its definition on the whole tensor."""
    from keystone_tpu_torch.parallel import collectives as coll

    mesh = _card_mesh()
    x = torch.randn(64, 16, device=cuda)
    xs = list(x.split(8))
    total = sum(xs[1:], xs[0].clone())
    assert all(torch.equal(t, total) for t in coll.allreduce_sum(xs, mesh))
    assert torch.equal(coll.all_gather(xs, mesh, tiled=True)[3], x)
    assert torch.equal(coll.ring_permute(xs, mesh, shift=1)[1], xs[0])
    assert torch.equal(torch.cat(coll.reduce_scatter(xs, mesh)), total)
    a2a = coll.all_to_all(xs, mesh, split_axis=0, concat_axis=1)
    assert torch.equal(a2a[2], torch.cat([t[2:3] for t in xs], dim=1))
    assert all(t.device.type == "cuda" for t in a2a)
    with pytest.raises(ValueError, match="lies on"):
        coll.allreduce_sum([t.cpu() for t in xs], mesh)


def test_sharded_solvers_on_the_card_match_one_shard(cuda, monkeypatch):
    """Gram, the refined centered solve, BCD (1-D and 2-D) over 8 shards
    of the card against the 1-shard results, at IEEE fp32 products."""
    from keystone_tpu_torch.parallel import linalg

    monkeypatch.setenv("KEYSTONE_SOLVER_PRECISION", "highest")
    g = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn(4100, 64, generator=g) + 0.5).to(cuda)
    y = torch.randn(4100, 4, generator=g).to(cuda)
    mesh = _card_mesh()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    g8, c8 = linalg.gram(x, y, mesh=mesh)
    g1, c1 = linalg.gram(x, y)
    assert rel(g8, g1) <= 1e-5 and rel(c8, c1) <= 1e-5
    w8 = linalg.centered_solve_refined(x, y, 4100, 1.0, refine_steps=2, mesh=mesh)[0]
    w1 = linalg.centered_solve_refined(x, y, 4100, 1.0, refine_steps=2)[0]
    assert rel(w8, w1) <= 1e-5
    xc, yc = x - x.mean(0), y - y.mean(0)
    b8 = linalg.block_coordinate_descent(xc, yc, 1.0, 2, 16, mesh=mesh)
    b1 = linalg.block_coordinate_descent(xc, yc, 1.0, 2, 16)
    assert rel(b8, b1) <= 1e-5
    w2d = linalg.block_coordinate_descent_2d(xc, yc, 1.0, 30, 16, mesh=_card_mesh((4, 2), ("data", "model")))
    assert w2d.device.type == "cuda"
    exact = torch.linalg.solve(xc.T @ xc + torch.eye(64, device=cuda), xc.T @ yc)
    assert rel(w2d, exact) <= 1e-4


def test_sharded_streamed_fit_on_the_card_matches_one_shard(cuda, monkeypatch):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.parallel.mesh import use_mesh
    from keystone_tpu_torch.workflow import BatchTransformer
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    class Scale(BatchTransformer):
        def apply_arrays(self, a):
            return a * 2.0

    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", "1024")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8192, 64)).astype(np.float32)
    y = (x @ rng.normal(size=(64, 3)) + 0.01 * rng.normal(size=(8192, 3))).astype(np.float32)

    def fit():
        PipelineEnv.reset()
        pipe = Scale().to_pipeline().then_label_estimator(
            LinearMapEstimator(reg=1e-3, device=cuda), ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"))
        return pipe.fit().apply_batch(ArrayDataset(x[:256], device=cuda)).data

    one = fit()
    assert last_stream_report().shards == 1
    with use_mesh(_card_mesh()):
        eight = fit()
        report = last_stream_report()
    assert (report.shards, report.compiles_steady_state) == (8, 0)
    assert report.collective_bytes == 4 * (64 * 64 + 64 * 3 + 64 + 3) * 7
    assert float((eight - one).norm() / one.norm()) <= 1e-5


def test_shard_loss_on_8_shards_of_the_card_recovers_the_uninterrupted_fit(cuda, monkeypatch):
    """A seeded loss of the last shard and of the seed-bearing shard 0,
    mid-fold on 8 shards of the card: the salvaged fold equals the
    uninterrupted 8-shard fold."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.parallel.mesh import use_mesh
    from keystone_tpu_torch.reliability.faultinject import FaultSpec, injected
    from keystone_tpu_torch.workflow import BatchTransformer
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    class Scale(BatchTransformer):
        def apply_arrays(self, a):
            return a * 2.0

    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", "1024")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8192, 64)).astype(np.float32)
    y = (x @ rng.normal(size=(64, 3)) + 0.01 * rng.normal(size=(8192, 3))).astype(np.float32)

    def fit(*specs):
        PipelineEnv.reset()
        pipe = Scale().to_pipeline().then_label_estimator(
            LinearMapEstimator(reg=1e-3, device=cuda), ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"))
        with injected(*specs):
            return pipe.fit().apply_batch(ArrayDataset(x[:256], device=cuda)).data

    with use_mesh(_card_mesh()):
        whole = fit()
        for index in ("7", "0"):
            monkeypatch.setenv("KEYSTONE_SHARD_LOSS_INDEX", index)
            salvaged = fit(FaultSpec(match="parallel.shard_loss", kind="transient", calls=(4,)))
            report = last_stream_report()
            assert (report.shard_losses, report.shards) == (1, 7)
            assert float((salvaged - whole).norm() / whole.norm()) <= 1e-5


def test_two_process_rehearsal_on_the_card_with_gloo(cuda):
    """Two rehearsal processes share the card: NCCL refuses that, so they
    join a gloo group and exchange host copies of their CUDA partials."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "keystone_tpu_torch.parallel.rehearsal", "--coordinator", f"127.0.0.1:{port}",
             "--num-hosts", "2", "--host-id", str(i), "--local-shards", "4", "--device", "cuda", "--backend", "gloo"],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "REHEARSAL_OK" in out and "mode=gloo" in out, out[-2000:]
