#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``keystone_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build — compile every CUDA kernel of the slice from ``csrc/`` (nvcc,
   sm_90a) and print the build seconds and ptxas' resource report;
2. kernels — hold each kernel against its plain PyTorch version on the
   card, at the slice's shapes and at edge cases (tiles (128, 8) and
   (3, 5), a ragged N, padded slots, duplicate blocks, an unaligned
   operand), relative Frobenius error ≤ 1e-5; time the kernel, the plain
   version and one library call at the slice's shapes;
3. slice — the hashing-TF → block-sparse least-squares fit of 65,536
   documents (1,024 topics, d = 16,384, k = 20, 16×16 tiles), then 4
   prediction requests of 1,024 held-out documents, through the
   library's entry points. The kernel must launch twice in the fit; the
   same rows refit on the dense in-core path
   (``KEYSTONE_BLOCKSPARSE=off``) must give the same scores to ≤ 1e-4,
   and a small fit on the card must match the same fit on the CPU.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit
from nvidia-smi, and last ``{"ok": true, "device": {...}}``. It exits
non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Slice configuration: the block-sparse bench corpus scaled up.
TOPICS, DOCS_PER_TOPIC, VOCAB_PER_TOPIC, SEED = 1024, 64, 12, 11
NUM_FEATURES, NUM_CLASSES, BLOCK_SIZE, REG = 16384, 20, 4096, 1e-3
REQUESTS, REQUEST_DOCS = 4, 1024
KERNEL_TOL, SLICE_TOL = 1e-5, 1e-4

# NVIDIA H100 SXM data sheet peaks (dense, at 700 W): HBM3 bytes/s and
# fp32 FLOP/s outside the tensor cores (the kernel runs fp32 FFMA).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def topic_corpus(topics, docs_per_topic, seed, vocab_per_topic=VOCAB_PER_TOPIC):
    """The block-sparse bench generator (RandomState, topic-grouped
    documents of 5–14 tokens from a per-topic vocabulary), joined into
    strings; label = topic % NUM_CLASSES."""
    rng = np.random.RandomState(seed)
    docs, labels = [], []
    for topic in range(topics):
        vocab = [f"t{topic}w{j}" for j in range(vocab_per_topic)]
        for _ in range(docs_per_topic):
            length = 5 + int(rng.randint(0, 10))
            docs.append(" ".join(vocab[int(rng.randint(0, vocab_per_topic))] for _ in range(length)))
            labels.append(topic % NUM_CLASSES)
    return docs, np.asarray(labels, np.int32)


def featurizer(num_features):
    from keystone_tpu_torch.ops.nlp.text import HashingTF, LowerCase, Tokenizer, Trim

    return Trim().to_pipeline().then(LowerCase()).then(Tokenizer()).then(HashingTF(num_features))


def rel_err(got, want) -> float:
    import torch

    return float((got - want).double().norm() / want.double().norm().clamp_min(1e-30))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# -------------------------------------------------------------- phase 1


def phase_build() -> None:
    from keystone_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.build(["ell_matmul"])
    log("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds)
    print(_build.build_log("ell_matmul").strip(), flush=True)


# -------------------------------------------------------------- phase 2


def check_kernel(idx, blocks, b):
    """Kernel vs plain version on the same inputs; raises past the bound."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs

    out = bs.ell_matmul(idx, blocks, b)
    torch.cuda.synchronize()
    ref = bs.ell_matmul_reference(idx, blocks, b)
    rel = rel_err(out, ref)
    max_abs = float((out - ref).abs().max()) if out.numel() else 0.0
    shape = {"indices": list(idx.shape), "blocks": list(blocks.shape), "b": list(b.shape)}
    if not (rel <= KERNEL_TOL and torch.isfinite(out).all()):
        raise AssertionError(f"ell_matmul disagrees with its plain version: rel {rel} at {shape}")
    return rel, max_abs, shape


def edge_cases(device):
    """Tiles (128, 8) and (3, 5), ragged N, padded slots, duplicate
    blocks, an operand that is not 16-byte aligned."""
    import torch

    rng = np.random.RandomState(5)
    cases = []
    for nbr, k_slots, bm, bn, nbc, n, dup, unaligned in (
        (9, 4, 128, 8, 12, 131, False, False),
        (7, 3, 3, 5, 6, 37, True, False),
        (64, 5, 16, 16, 40, 300, True, False),
        (16, 3, 16, 16, 8, 64, False, True),
        (4, 2, 128, 128, 3, 64, True, False),
        (5, 3, 1, 1, 9, 1, False, False),
    ):
        idx = rng.randint(0, nbc, size=(nbr, k_slots)).astype(np.int32)
        if dup:
            idx[:, 1] = idx[:, 0]
        blocks = rng.randn(nbr, k_slots, bm, bn).astype(np.float32)
        idx[:, -1], blocks[:, -1] = 0, 0.0  # padded slot
        b = torch.from_numpy(rng.randn(nbc * bn, n).astype(np.float32)).to(device)
        if unaligned:
            storage = torch.zeros(b.numel() + 1, device=device)
            b = storage[1:].view(b.shape).copy_(b)
        rel, max_abs, shape = check_kernel(
            torch.from_numpy(idx).to(device), torch.from_numpy(blocks).to(device), b
        )
        cases.append({"shape": shape, "rel_err": rel, "max_abs_err": max_abs})
    return cases


def library_call(bsr_t, b):
    """One PyTorch call computing (Aᵀ)_bsr @ b: cuSPARSE's BSR product
    where PyTorch has it for fp32, else a dense fp32 matmul of Aᵀ."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs

    dp, mp = bsr_t.padded_shape
    try:
        sparse = torch.sparse_bsr_tensor(
            torch.from_numpy(bsr_t.indptr.astype(np.int64)).to(b.device),
            torch.from_numpy(bsr_t.indices.astype(np.int64)).to(b.device),
            torch.from_numpy(bsr_t.blocks).to(b.device),
            size=(dp, mp),
        )
        sparse @ b
        torch.cuda.synchronize()
        return (lambda: sparse @ b), "torch.sparse_bsr_tensor @ dense"
    except (RuntimeError, NotImplementedError) as exc:
        print(f"BSR @ dense unavailable for fp32 ({exc!s:.200}); timing a dense matmul", flush=True)
        dense_t = bs.bsr_to_dense(bsr_t, b.device)
        return (lambda: torch.matmul(dense_t, b)), "torch.matmul of dense fp32 A^T"


def phase_kernels(device):
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.nlp.text import block_sparse_features

    train, labels = topic_corpus(TOPICS, DOCS_PER_TOPIC, SEED)
    rows = featurizer(NUM_FEATURES)(train).get().collect()
    bsr = block_sparse_features(rows)
    bsr_t = bsr.transpose()
    idx, blocks = bs.ell_tensors(bsr_t, device)
    a = bs.bsr_to_dense(bsr, device)
    y = torch.full((a.shape[0], NUM_CLASSES), -1.0, device=device)
    y[torch.arange(len(labels), device=device), torch.from_numpy(labels).long().to(device)] = 1.0
    bm, bn = bsr_t.block_shape
    shapes = []
    for name, b in (("AtA", a), ("AtY", y)):
        rel, max_abs, shape = check_kernel(idx, blocks, b)
        n = b.shape[1]
        out_bytes = idx.shape[0] * bm * n * 4
        moved = idx.numel() * 4 + blocks.numel() * 4 + b.numel() * 4 + out_bytes
        flops = 2.0 * bsr_t.nnz_blocks * bm * bn * n  # stored blocks only: this run's work
        bound_ms = max(moved / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3
        kernel_ms = cuda_ms(lambda: bs.ell_matmul(idx, blocks, b), reps=5)
        plain_ms = cuda_ms(lambda: bs.ell_matmul_reference(idx, blocks, b), reps=3)
        lib_fn, lib_name = library_call(bsr_t, b)
        library_ms = cuda_ms(lib_fn, reps=3)
        lib_rel = rel_err(lib_fn(), bs.ell_matmul_reference(idx, blocks, b))
        del lib_fn
        shapes.append({
            "call": name, **shape, "rel_err": rel, "max_abs_err": max_abs,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": lib_name, "library_rel_err": lib_rel,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if moved / PEAK_BYTES_PER_S >= flops / PEAK_FP32_FLOPS else "operations",
            "bytes": moved, "useful_flops": flops,
            "padded_slot_share": 1.0 - bsr_t.nnz_blocks / idx.numel(),
        })
        log("kernel_shape", **shapes[-1])
    del a, y, idx, blocks
    torch.cuda.empty_cache()
    edges = edge_cases(device)
    log("kernel_edges", cases=edges)
    main = shapes[0]
    return {
        "name": "ell_matmul",
        "route": "cuda",
        "source": "keystone_tpu_torch/ops/cuda/csrc/ell_matmul.cu",
        "replaces": "keystone_tpu/ops/pallas/blocksparse.py:159",
        "launches": None,  # filled from the slice run
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_rel_err": max([s["rel_err"] for s in shapes] + [c["rel_err"] for c in edges]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": main["library_call"],
        "timed_shape": "AtA",
        "shapes": shapes,
    }


# -------------------------------------------------------------- phase 3


def run_slice(train, labels, test, test_labels, device, block_size=None):
    """Fit on ``train``, answer ``REQUESTS`` prediction requests over
    ``test``; returns the model, scores, predictions and timings."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.ops.util.vectors import Densify

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    feat = featurizer(NUM_FEATURES)
    rows = feat(train).get()
    y = ClassLabelIndicators(NUM_CLASSES)(ArrayDataset(labels, device=device)).get()
    t_feat = time.perf_counter()
    model = BlockLeastSquaresEstimator(
        block_size or BLOCK_SIZE, num_iter=1, reg=REG, device=device
    ).fit(rows, y)
    sync()
    t_fit = time.perf_counter()
    classify = feat.then(Densify(device=device)).then(model) >> MaxClassifier()
    size = len(test) // REQUESTS
    preds, request_s = [], []
    for r in range(REQUESTS):
        t_req = time.perf_counter()
        preds.append(classify(test[r * size : (r + 1) * size]).get().data)
        sync()
        request_s.append(time.perf_counter() - t_req)
    pred = torch.cat(preds)
    metrics = MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(pred, test_labels[: len(pred)])
    return {
        "rows": rows, "y": y, "model": model, "pred": pred,
        "featurize_s": t_feat - t0, "fit_s": t_fit - t_feat, "request_s": request_s,
        "test_error": metrics.total_error,
    }


def scores(model, test, device):
    from keystone_tpu_torch.ops.util.vectors import Densify

    return (featurizer(NUM_FEATURES).then(Densify(device=device)).then(model))(test).get().data


def fp64_reference_scores(bsr, y, test, device):
    """Test scores of the same one-epoch BCD fit run in float64 on the
    dense centered matrix — the yardstick both fp32 paths are read
    against."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.util.vectors import Densify
    from keystone_tpu_torch.parallel import linalg

    n, d = bsr.shape
    x = bs.bsr_to_dense(bsr, device)[:n, :d].double()
    yd = y[:n].double()
    mu_a, mu_b = x.mean(dim=0), yd.mean(dim=0)
    x -= mu_a
    w = linalg.block_coordinate_descent(x, yd - mu_b, REG, 1, BLOCK_SIZE)
    del x
    xt = Densify(device=device).apply_batch(featurizer(NUM_FEATURES)(test).get()).data.double()
    return ((xt - mu_a) @ w + mu_b).float()


def phase_slice(device):
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.nlp.text import block_sparse_features

    train, labels = topic_corpus(TOPICS, DOCS_PER_TOPIC, SEED)
    test, test_labels = topic_corpus(TOPICS, REQUESTS * REQUEST_DOCS // TOPICS, SEED + 1)

    torch.cuda.reset_peak_memory_stats()
    bs.ell_matmul.launches = 0
    out = run_slice(train, labels, test, test_labels, device)
    launches = bs.ell_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != 2:
        raise AssertionError(f"the fit launched the ELL kernel {launches} times, expected 2")
    pred = out["pred"]
    if tuple(pred.shape) != (len(test),) or pred.min() < 0 or pred.max() >= NUM_CLASSES:
        raise AssertionError(f"bad predictions: shape {tuple(pred.shape)}")
    bsr = block_sparse_features(out["rows"])
    s_sparse = scores(out["model"], test, device)
    if tuple(s_sparse.shape) != (len(test), NUM_CLASSES) or not torch.isfinite(s_sparse).all():
        raise AssertionError("scores are not finite or of the wrong shape")

    os.environ["KEYSTONE_BLOCKSPARSE"] = "off"
    try:
        t0 = time.perf_counter()
        dense_model = BlockLeastSquaresEstimator(BLOCK_SIZE, num_iter=1, reg=REG, device=device).fit(
            out["rows"], out["y"]
        )
        torch.cuda.synchronize()
        dense_fit_s = time.perf_counter() - t0
    finally:
        del os.environ["KEYSTONE_BLOCKSPARSE"]
    s_dense = scores(dense_model, test, device)
    dense_rel = rel_err(s_sparse, s_dense)
    del dense_model
    s_fp64 = fp64_reference_scores(bsr, out["y"].data, test, device)
    sparse_vs_fp64 = rel_err(s_sparse, s_fp64)
    dense_vs_fp64 = rel_err(s_dense, s_fp64)
    log("slice_accuracy", sparse_vs_dense_scores_rel=dense_rel,
        sparse_vs_fp64_scores_rel=sparse_vs_fp64, dense_vs_fp64_scores_rel=dense_vs_fp64)
    if bs.ell_matmul.launches != launches:
        raise AssertionError("the dense in-core fit launched the block-sparse kernel")
    if not dense_rel <= SLICE_TOL:
        raise AssertionError(f"sparse-path scores differ from the dense path by {dense_rel}")

    # Small input: the same fit on the card (kernel) and on the CPU
    # (plain version).
    small_train, small_labels = topic_corpus(32, 16, SEED)
    small_test, small_test_labels = topic_corpus(32, 4, SEED + 1)
    cpu = torch.device("cpu")
    on_card = run_slice(small_train, small_labels, small_test, small_test_labels, device, 128)
    on_cpu = run_slice(small_train, small_labels, small_test, small_test_labels, cpu, 128)
    small_rel = rel_err(on_card["model"].weights.cpu(), on_cpu["model"].weights)
    if not small_rel <= SLICE_TOL or not torch.equal(on_card["pred"].cpu(), on_cpu["pred"]):
        raise AssertionError(f"small fit on the card differs from the CPU: weights rel {small_rel}")

    result = {
        "documents": len(train), "features": NUM_FEATURES, "classes": NUM_CLASSES,
        "block_shape": list(bsr.block_shape), "density": bsr.density(),
        "stored_blocks": bsr.nnz_blocks, "blocks_skipped": bsr.blocks_skipped(),
        "featurize_s": out["featurize_s"], "fit_s": out["fit_s"],
        "request_s": out["request_s"], "request_docs": len(test) // REQUESTS,
        "test_error": out["test_error"], "peak_device_bytes": peak,
        "ell_launches_in_fit": launches,
        "dense_fit_s": dense_fit_s, "sparse_vs_dense_scores_rel": dense_rel,
        "small_card_vs_cpu_weights_rel": small_rel,
    }
    log("slice", **result)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    os.environ["KEYSTONE_BLOCKSPARSE_BLOCK"] = "16x16"
    os.environ.pop("KEYSTONE_BLOCKSPARSE_THRESHOLD", None)
    os.environ.pop("KEYSTONE_BLOCKSPARSE", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import keystone_tpu_torch.parallel.linalg  # noqa: F401  (sets fp32 matmuls)

    device = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    kernel = phase_kernels(device)
    kernel["launches"] = phase_slice(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
