"""``python -m keystone_tpu_torch fit``: one durable streamed fit, end to end.

Port of ``keystone_tpu/workflow/fitcmd.py``. The CLI face of the
durable-fit layer: build a deterministic synthetic
``featurize-chain → LinearMapEstimator`` pipeline (or the sketched
estimator with ``--solver sketch``), attach a
:class:`~keystone_tpu_torch.reliability.checkpoint.CheckpointStore`, and
fit through the planned streaming path with mid-fit cursor checkpoints
armed. The training matrix stays in host memory and streams to the
device chunk by chunk; the fit runs on ``--device`` (default the CUDA
device; ``--device cpu`` runs on the CPU).

The durability loop across PROCESSES:

1. run with ``KEYSTONE_FAULT_SPECS`` carrying a ``kill`` at
   ``streaming.chunk`` call k — a real SIGKILL mid-stream; the store
   holds the last committed cursor;
2. re-run the same command in a fresh process — the re-planned pipeline
   finds the resume entry, validates fingerprints (KV306), seeds the
   fold, and re-ingests only chunks past the cursor;
3. ``--expect-resume`` asserts step 2 actually resumed (exit 2 when it
   silently refit from scratch), and ``--out`` writes the fitted
   predictions on a fixed probe batch so a caller can check parity
   against an uninterrupted run.

``--drift-data`` perturbs the training matrix while keeping its shape —
the seeded KV306 case: same resume key, different content digest, and
under ``KEYSTONE_VERIFY=strict`` the refusal exits non-zero.

Everything is deterministic in ``--seed``; the probe batch is drawn from
its own fixed stream so every invocation scores the same rows. The
training draws are not the JAX CLI's (:func:`synthetic_problem`), so the
two CLIs fit different data for one seed. Prints
one ``FIT_STATS:`` JSON line: the JAX package's keys plus ``fit_s``,
each commit's seconds and bytes (``checkpoint_s``, ``checkpoint_bytes``)
the 12-hex digests of the store entries the run wrote or restored
(``checkpoint_digests``) and the process's kernel launches, binding calls
and peak device bytes (``device_counts``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np

from ..workflow.pipeline import BatchTransformer


class FitDemoScaler(BatchTransformer):
    """A real (content-fingerprinted) featurize-chain member: affine
    rescale. Module-level so its prefix/chain digests are process-stable
    — the property crash-resume keys on."""

    def __init__(self, scale: float = 1.0, shift: float = 0.0):
        self.scale = float(scale)
        self.shift = float(shift)

    def apply_arrays(self, x):
        return x * self.scale + self.shift


#: Row blocks of the synthetic draws: fixed, so the data does not depend
#: on the host's core count.
DRAW_BLOCKS = 16


def _normals(rng: np.random.Generator, shape) -> np.ndarray:
    """float32 standard normals of ``shape``, deterministic in ``rng``:
    each of :data:`DRAW_BLOCKS` row blocks from its own spawned generator,
    filled on a thread pool (the fill releases the interpreter lock; at
    the TIMIT-shaped size, ~6·10⁸ draws, one thread takes seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty(shape, np.float32)
    step = -(-shape[0] // DRAW_BLOCKS)
    gens = rng.spawn(DRAW_BLOCKS)

    def fill(i):
        block = out[i * step : (i + 1) * step]
        if block.size:
            gens[i].standard_normal(out=block, dtype=np.float32)

    with ThreadPoolExecutor(max_workers=min(DRAW_BLOCKS, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(DRAW_BLOCKS)))
    return out


def synthetic_problem(rows: int, dim: int, classes: int, seed: int = 0, drift_data: float = 0.0):
    """The ``fit`` CLI's float32 training matrix, targets and 64-row probe
    batch. The matrix and targets are not the JAX package's draws (its CLI
    draws one ``default_rng(seed)`` stream; these come from
    :func:`_normals`' spawned blocks); the probe batch is."""
    x_seed, w_seed, noise_seed = np.random.default_rng(seed).spawn(3)
    x = _normals(x_seed, (rows, dim))
    w = _normals(w_seed, (dim, classes))
    y = x @ w
    y += np.float32(0.01) * _normals(noise_seed, (rows, classes))
    if drift_data:
        # Same shape, same dtype, different CONTENT: the stale-resume
        # hazard KV306 exists for.
        x = x + np.float32(drift_data)
    probe = np.random.default_rng(12345).normal(size=(64, dim)).astype(np.float32)
    return x, y, probe


def fit_from_args(args) -> int:
    """Run the durable synthetic fit; see module docstring."""
    from ..data.dataset import ArrayDataset
    from ..device import resolve_device
    from ..ops.cuda import device_counts
    from ..ops.learning.linear import LinearMapEstimator
    from ..reliability import enable_checkpointing, faultinject
    from ..reliability.recovery import get_recovery_log
    from ..workflow.streaming import last_stream_report

    device = resolve_device(args.device)
    # Chunk geometry is a plan knob: pin it for every process so resume
    # cursors align.
    os.environ["KEYSTONE_STREAM_CHUNK_ROWS"] = str(args.chunk_rows)
    if args.ckpt_chunks is not None:
        os.environ["KEYSTONE_STREAM_CKPT_CHUNKS"] = str(args.ckpt_chunks)
    # Chaos crosses the process boundary through the environment.
    faultinject.install_from_env()

    x, y, probe = synthetic_problem(args.rows, args.dim, args.classes, args.seed, args.drift_data)

    enable_checkpointing(args.store_dir, device=device)
    if args.solver == "sketch":
        from ..sketch import SketchedLeastSquaresEstimator

        estimator = SketchedLeastSquaresEstimator(reg=args.reg, device=device)
    else:
        estimator = LinearMapEstimator(reg=args.reg, device=device)
    pipeline = (
        FitDemoScaler(scale=2.0, shift=0.5)
        .to_pipeline()
        .then_label_estimator(
            estimator,
            ArrayDataset(x, device="cpu"),
            ArrayDataset(y, device="cpu"),
        )
    )
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    preds = fitted.apply_batch(ArrayDataset(probe, device=device)).data.cpu().numpy()
    fit_s = time.perf_counter() - t0
    if args.out:
        np.savez(args.out, preds=preds)

    report = last_stream_report()
    ledger = get_recovery_log()
    stats: Dict[str, Any] = {
        "rows": args.rows,
        "dim": args.dim,
        "chunk_rows": args.chunk_rows,
        "device": str(device),
        "streamed": report is not None,
        "preds_norm": float(np.linalg.norm(preds)),
        "fit_s": fit_s,
    }
    if report is not None:
        stats.update(
            chunks=report.chunks,
            chunks_total=-(-args.rows // report.chunk_rows),
            shards=report.shards,
            checkpoints=report.checkpoints,
            checkpoint_s=report.checkpoint_s,
            checkpoint_bytes=report.checkpoint_bytes,
            resumed_from_chunk=report.resumed_from_chunk,
            reingested_chunks=report.reingested_chunks,
            shard_losses=report.shard_losses,
        )
    stats["ledger_kinds"] = sorted(
        {
            e.kind
            for e in ledger.events()
            if e.kind.startswith(("stream_", "shard_", "resume_", "checkpoint_"))
        }
    )
    stats["checkpoint_digests"] = sorted(
        {e.detail["digest"] for e in ledger.events() if e.kind in ("checkpoint_save", "checkpoint_hit")}
    )
    stats["device_counts"] = device_counts(device)
    print("FIT_STATS:" + json.dumps(stats), flush=True)

    if args.expect_resume and (report is None or report.resumed_from_chunk is None):
        print("fit: --expect-resume set but the fit did not resume")
        return 2
    return 0


def add_fit_arguments(parser) -> None:
    """Flags for the ``fit`` subcommand: the JAX package's, plus
    ``--device``."""
    parser.add_argument("--rows", type=int, default=1024, help="synthetic training rows")
    parser.add_argument("--dim", type=int, default=16, help="synthetic feature width")
    parser.add_argument("--classes", type=int, default=3, help="synthetic label width")
    parser.add_argument(
        "--chunk-rows", type=int, default=128,
        help="streamed chunk rows (pinned so resume cursors align across processes)",
    )
    parser.add_argument(
        "--ckpt-chunks", type=int, default=None,
        help="chunks between mid-fit checkpoint commits (default KEYSTONE_STREAM_CKPT_CHUNKS; 0 disables)",
    )
    parser.add_argument("--reg", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--store-dir", required=True,
        help="checkpoint-store directory (resume entries + fitted prefixes live here)",
    )
    parser.add_argument(
        "--out", default=None,
        help="write fitted predictions on the fixed probe batch here (.npz)",
    )
    parser.add_argument(
        "--expect-resume", action="store_true",
        help="exit 2 unless this fit resumed from a persisted cursor",
    )
    parser.add_argument(
        "--drift-data", type=float, default=0.0,
        help="perturb the training matrix by this constant (same shape, different content — the KV306 case)",
    )
    parser.add_argument(
        "--solver", choices=("gram", "sketch"), default="gram",
        help="streamed state family: 'gram' accumulates the O(d²) sufficient statistics, "
        "'sketch' the O(s·d) randomized sketch",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to fit on (default: the CUDA device; 'cpu' to run on the CPU)",
    )
