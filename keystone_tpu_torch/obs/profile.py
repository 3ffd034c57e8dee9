"""``python -m keystone_tpu_torch profile``: run a pipeline under full
instrumentation and write both export formats.

Port of ``keystone_tpu/obs/profile.py``. Drives the synthetic MNIST
random-FFT workload (featurize → block least squares) through fit, batch
apply, and a burst of online serving — the three execution modes the
system has — inside one
:class:`~keystone_tpu_torch.obs.spans.TraceSession` with the full metric
schema pre-registered and the cost observatory on, on ``--device``
(default: the card). Outputs, into ``--out-dir``:

- ``profile_trace.json`` — Chrome trace-event JSON; open in Perfetto
  (https://ui.perfetto.dev) to see pipeline → node → solver spans nested
  on their threads.
- ``profile_metrics.prom`` — Prometheus text exposition of every metric,
  executor/autocache/reliability/serving included, with the device
  memory gauges of each phase (``keystone_peak_memory_bytes``, the
  card's allocator peak).

plus a span-tree table on stdout. The flag surface imports no torch
(:func:`add_profile_arguments`); everything heavy imports inside
:func:`run_profile`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict

from . import device as _device
from . import export, metrics, names, spans

logger = logging.getLogger(__name__)


def add_profile_arguments(parser) -> None:
    """Flags for the ``profile`` subcommand (plain argparse — the CLI's
    --help path imports no torch)."""
    parser.add_argument(
        "--rows", type=int, default=512,
        help="synthetic training rows (default: 512)",
    )
    parser.add_argument(
        "--num-ffts", type=int, default=2,
        help="featurizer branches (default: 2)",
    )
    parser.add_argument(
        "--block-size", type=int, default=256,
        help="solver block size (default: 256)",
    )
    parser.add_argument(
        "--serve-requests", type=int, default=32,
        help="online requests to fire through PipelineServer (default: 32)",
    )
    parser.add_argument(
        "--out", default=None,
        help="deprecated alias of --out-dir",
    )
    parser.add_argument(
        "--out-dir", default=None, dest="out_dir",
        help="directory for profile_trace.json / profile_metrics.prom "
             "(default: current directory)",
    )
    parser.add_argument(
        "--no-autocache", action="store_true",
        help="skip the profile-driven auto-cache planner during fit",
    )
    parser.add_argument(
        "--no-serve", action="store_true",
        help="skip the serving phase",
    )
    parser.add_argument(
        "--device-annotations", action="store_true",
        help="wrap node execution in torch.profiler.record_function and "
             "an NVTX range (useful under an active profiler capture)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA device; 'cpu' to run on the CPU)",
    )


def profile_from_args(args) -> int:
    result = run_profile(
        rows=args.rows,
        num_ffts=args.num_ffts,
        block_size=args.block_size,
        serve_requests=0 if args.no_serve else args.serve_requests,
        out_dir=args.out_dir or args.out or ".",
        autocache=not args.no_autocache,
        annotations=args.device_annotations,
        device=args.device,
    )
    # Store round-trip evidence: hits prove a previous run's measurements were read back, writes
    # prove this run's were persisted.
    print("PROFILE_STORE:" + json.dumps(result["summary"].get(
        "profile_store", {"enabled": False}
    )))
    print("PROFILE_JSON:" + json.dumps(result["summary"]))
    return 0


def run_profile(
    rows: int = 512,
    num_ffts: int = 2,
    block_size: int = 256,
    serve_requests: int = 32,
    out_dir: str = ".",
    autocache: bool = True,
    annotations: bool = False,
    device: Any = None,
) -> Dict[str, Any]:
    """Fit + apply + serve the synthetic pipeline under instrumentation on
    ``device`` (default CUDA); returns ``{"summary": ..., "session":
    TraceSession, "report": str}``."""
    from ..device import resolve_device

    from ..pipelines.mnist_random_fft import (
        MnistRandomFFTConfig,
        build_pipeline,
        synthetic_mnist,
    )
    from ..workflow.executor import PipelineEnv
    from ..workflow.rules import auto_caching_optimizer
    from . import store as obs_store

    device = resolve_device(device)
    names.register_all()
    # Save the raw override (None = following the env), not the resolved
    # bool: restoring a resolved False would PIN annotations off
    # process-wide and re-introduce the stale-env bug device.py fixed.
    annotations_before = _device._annotations_enabled
    if annotations:
        _device.set_device_annotations(True)
    os.makedirs(out_dir, exist_ok=True)
    # The profile harness is an analysis run: the cost observatory rides
    # along (per-node flop/byte facts + the cost-ledger counter track in
    # the exported trace), restored to the prior override afterwards.
    # Flipped inside the try below so no exception path can leak the
    # forced-on observatory process-wide.
    from . import cost as _cost

    cost_override_before = _cost._enabled_override

    registry = metrics.get_registry()
    before = registry.snapshot()
    config = MnistRandomFFTConfig(
        num_ffts=max(1, num_ffts), block_size=max(8, block_size)
    )
    summary: Dict[str, Any] = {
        "device": str(device),
        "rows": rows,
        "num_ffts": config.num_ffts,
        "block_size": config.block_size,
    }

    # Profile-store round trip: remember this harness run's phase walls
    # per workload shape, and surface the PREVIOUS run's next to them —
    # the CLI's own run-over-run comparison.
    store = obs_store.get_store()
    store_key = f"profile:mnist_fft:ffts{config.num_ffts}"
    store_shape = obs_store.shape_class(rows, (config.block_size,))
    if store is not None:
        previous = store.lookup(store_key, store_shape)
        if previous is not None:
            summary["previous"] = previous

    env = PipelineEnv.get_or_create()
    optimizer_before = env._optimizer  # restore below: run_profile is a
    try:                               # library API, not a process owner
        _cost.set_cost_observatory(True)
        with spans.tracing_session("profile") as session:
            with spans.span("profile", rows=rows):
                if autocache:
                    env.optimizer = auto_caching_optimizer()

                with spans.span("phase:fit"), _device.stage_memory("fit", device):
                    train = synthetic_mnist(rows, seed=0, device=device)
                    t0 = time.perf_counter()
                    fitted = build_pipeline(config, train, device=device).fit()
                    _sync(device)
                    summary["fit_s"] = round(time.perf_counter() - t0, 3)

                with spans.span("phase:apply", rows=min(rows, 128)), \
                        _device.stage_memory("apply", device):
                    test = synthetic_mnist(min(rows, 128), seed=1, device=device)
                    t0 = time.perf_counter()
                    fitted(test.data).get()
                    _sync(device)
                    summary["apply_s"] = round(time.perf_counter() - t0, 3)

                if serve_requests > 0:
                    with spans.span("phase:serve", requests=serve_requests), \
                            _device.stage_memory("serve", device):
                        summary["serve"] = _serve_burst(fitted, serve_requests, device)
    finally:
        env._optimizer = optimizer_before
        _device.set_device_annotations(annotations_before)
        _cost.set_cost_observatory(cost_override_before)

    if store is not None:
        store.record(
            store_key, store_shape,
            fit_s=summary.get("fit_s"), apply_s=summary.get("apply_s"),
        )
        summary["profile_store"] = {"enabled": True, **store.stats()}
    else:
        summary["profile_store"] = {"enabled": False}

    from ..workflow.streaming import last_stream_report

    from .flight import get_flight_recorder

    recorder = get_flight_recorder()
    trace_path = export.write_chrome_trace(
        session, os.path.join(out_dir, "profile_trace.json"),
        stream_report=last_stream_report(),
        cost_ledger=_cost.get_ledger().tail(_cost.get_ledger().capacity),
        quality_ring=recorder.quality_ring() if recorder is not None else None,
    )
    prom_path = export.write_prometheus(
        os.path.join(out_dir, "profile_metrics.prom"), registry
    )
    summary["spans"] = len(session)
    summary["metrics_delta_keys"] = len(metrics.delta(registry.snapshot(), before))
    summary["trace_path"] = trace_path
    summary["prometheus_path"] = prom_path
    text = export.report(session)
    print(text)
    return {"summary": summary, "session": session, "report": text}


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _serve_burst(fitted, n_requests: int, device) -> Dict[str, Any]:
    """Fire a burst through PipelineServer so request traces and the full
    serving metric set land in the profile."""
    import numpy as np

    from ..serving import PipelineServer, ServingConfig
    from ..pipelines.mnist_random_fft import MNIST_IMAGE_SIZE

    rng = np.random.default_rng(7)
    example = np.zeros((MNIST_IMAGE_SIZE,), np.float32)
    server = PipelineServer(
        fitted,
        config=ServingConfig(
            max_batch=8, max_wait_ms=2.0, queue_depth=n_requests + 16
        ),
        device=device,
    ).start()
    try:
        server.warmup(example)
        payloads = [
            rng.standard_normal(MNIST_IMAGE_SIZE).astype(np.float32)
            for _ in range(n_requests)
        ]
        t0 = time.perf_counter()
        futures = server.submit_many(payloads)
        errors = sum(1 for f in futures if f.exception(timeout=120) is not None)
        elapsed = time.perf_counter() - t0
        stats = server.stats()
    finally:
        server.stop()
    return {
        "requests": n_requests,
        "errors": errors,
        "rps": round((n_requests - errors) / max(elapsed, 1e-9), 1),
        "p99_ms": stats.get("p99_ms"),
        "cufft_plans_since_warmup": stats.get("cufft_plans_since_warmup"),
    }
