"""Co-scheduled serving + refit on one card: the demo the CLI and
``chip_smoke.py`` drive.

Port of ``keystone_tpu/sched/demo.py``. One :class:`PipelineServer`
serves a paced, seeded request trace while a :class:`RefitDaemon` folds
labeled rows under :class:`MeshScheduler` leases, on one device:

- **serial phase**: each round serves its trace to completion, THEN runs
  a full refit round over its rows on an *unscheduled* daemon. Its final
  state is the *parity reference*.
- **co-scheduled phase**: the same traces and rows, but the refit round
  runs as an admitted lease *while* the trace is in flight.
- **seeded preemption**: in ``pressure_round`` the scheduler's
  deterministic door (:meth:`MeshScheduler.seed_pressure_after`) turns
  pressure on after admission — the fold yields at a chunk boundary with
  its durable cursor committed, the round defers, and the next round
  resumes from the cursor and publishes. Nothing is dropped, and the
  co-scheduled final state must match the serial reference to ≤1e-6.

By default the trace is served by the refit head itself, as in the JAX
package. ``serve_model`` serves another fitted pipeline instead (the
MNIST artifact on the card), with payloads of ``serve_dim`` floats,
while the daemons fold and publish the head beside it.
"""

from __future__ import annotations

import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..reliability.recovery import get_recovery_log
from .scheduler import MeshScheduler


@dataclass
class CoschedDemoConfig:
    d: int = 32
    classes: int = 4
    rounds: int = 4
    rows_per_round: int = 8192
    chunk_rows: int = 1024
    serve_requests: int = 96        # per round, per phase
    serve_rps: float = 320.0        # paced — the idle gaps ARE the point
    pressure_round: int = 2         # seeded mid-fold preemption here
    settle_round: int = 1           # steady-state assertions start after
    slo_target_ms: float = 500.0
    seed: int = 0
    reg: float = 1e-2
    store_dir: Optional[str] = None
    #: a fitted pipeline to serve instead of the head (None: the head).
    serve_model: Any = None
    #: its input width (floats per request).
    serve_dim: int = 0


def run_cosched_demo(config: CoschedDemoConfig, device: Any = None) -> Dict[str, Any]:
    """Run both phases on ``device`` (default CUDA) and return the
    evidence dict (the JAX demo's keys; ``cufft_plans_steady_state_post_settle``
    stands where it counts compiles)."""
    import torch

    from ..data.dataset import ArrayDataset
    from ..device import resolve_device
    from ..obs.quality import reset_quality_plane
    from ..ops.learning.linear import LinearMapEstimator
    from ..refit.daemon import RefitConfig, RefitDaemon
    from ..refit.publish import InProcessPublisher
    from ..refit.shadow import ShadowEvaluator
    from ..refit.tap import TrafficTap
    from ..reliability.checkpoint import CheckpointStore
    from ..serving.config import ServingConfig
    from ..serving.loadgen import run_load
    from ..serving.server import PipelineServer
    from ..workflow.streaming import ChunkStream

    cfg = config
    device = resolve_device(device)
    reset_quality_plane()
    rng = np.random.default_rng(cfg.seed)
    w_true = rng.standard_normal((cfg.d, cfg.classes)).astype(np.float32)

    def make_rows(n: int):
        x = rng.standard_normal((n, cfg.d)).astype(np.float32)
        labels = np.argmax(x @ w_true, axis=1)
        y = np.eye(cfg.classes, dtype=np.float32)[labels]
        return x, y

    def stream_over(x, y):
        return ChunkStream(
            ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"), (),
            chunk_rows=min(cfg.chunk_rows, len(x)), device=device,
        )

    # All round data up front: both phases serve and fold the SAME rows.
    x0, y0 = make_rows(cfg.rows_per_round)
    rounds_data = [make_rows(cfg.rows_per_round) for _ in range(cfg.rounds)]
    offsets = [i / cfg.serve_rps for i in range(cfg.serve_requests)]
    separate = cfg.serve_model is not None
    serve_rows = (
        rng.standard_normal((cfg.serve_requests, cfg.serve_dim)).astype(np.float32)
        if separate else None
    )

    store_root = cfg.store_dir or tempfile.mkdtemp(prefix="keystone-cosched-")

    estimator = LinearMapEstimator(reg=cfg.reg, device=device)
    v1_model = estimator.fit_stream(stream_over(x0, y0))
    v1_state = estimator.export_stream_state()

    tap = TrafficTap(capacity_rows=cfg.rows_per_round * 4, mirror_rows=512)
    server = PipelineServer(
        config=ServingConfig(max_batch=8, queue_depth=cfg.serve_requests + 64),
        name="cosched",
        # A served model of another width must not feed the head's mirror.
        tap=None if separate else tap,
        device=device,
    )
    server.registry.publish("cosched", v1_model, source="fit")
    # The serial baseline daemon publishes under its own name.
    server.registry.publish("cosched-serial", v1_model, source="fit")
    if separate:
        server.registry.publish("cosched-serve", cfg.serve_model, source="fit")
    server.start()
    example = np.zeros((cfg.d,), np.float32)
    if separate:
        server.warmup(np.zeros((cfg.serve_dim,), np.float32), models=["cosched-serve"])
    server.warmup(example, models=["cosched", "cosched-serial"])
    served_model = "cosched-serve" if separate else None

    # sustain_checks pinned (not env-read): the seeded preemption lands at
    # a deterministic chunk boundary on every machine.
    scheduler = MeshScheduler(store=None, name="cosched", sustain_checks=2, device=device)

    def make_daemon(name: str, est, daemon_tap, sched):
        return RefitDaemon(
            est,
            daemon_tap,
            InProcessPublisher(server, name=name, example=example),
            store=CheckpointStore(f"{store_root}/{name}", device=device),
            scheduler=sched,
            # Wide-open gates: this demo pins scheduling and parity, not
            # candidate quality.
            shadow=ShadowEvaluator(margin=0.5),
            config=RefitConfig(
                name=name,
                min_rows=cfg.rows_per_round // 2,
                chunk_rows=cfg.chunk_rows,
                watch_margin=0.5,
                state_decay=1.0,  # pure accumulation → exact parity
            ),
            state=v1_state,
        )

    daemon = make_daemon("cosched", estimator, tap, scheduler)
    serial_est = LinearMapEstimator(reg=cfg.reg, device=device)
    serial_tap = TrafficTap(capacity_rows=cfg.rows_per_round * 4, mirror_rows=512)
    serial_daemon = make_daemon("cosched-serial", serial_est, serial_tap, None)

    def submit(payload, deadline_s=None):
        return server.submit(payload, deadline_s=deadline_s, model=served_model)

    def serve_round(r: int) -> Dict[str, Any]:
        if separate:
            payloads = list(serve_rows)
        else:
            x, _y = rounds_data[r - 1]
            payloads = [row for row in x[: cfg.serve_requests]]
        report = run_load(
            submit,
            offsets,
            payload=lambda i: payloads[i % len(payloads)],
            deadline_s=60.0,
            settle_timeout_s=120.0,
        )
        return report.summary()

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # ------------------------------------------------------- serial phase
    serial_wall = 0.0
    dropped = 0
    serial_p99: List[float] = []
    for r in range(1, cfg.rounds + 1):
        x, y = rounds_data[r - 1]
        serial_tap.feed(x, y)
        t0 = time.perf_counter()
        load = serve_round(r)
        serial_daemon.run_once()
        sync()
        serial_wall += time.perf_counter() - t0
        dropped += int(load["dropped"])
        serial_p99.append(load["p99_ms"])
        server.restamp_compile_baseline()

    # ------------------------------------------------- co-scheduled phase
    cosched_wall = 0.0
    steady_plans = 0
    round_records: List[Dict[str, Any]] = []
    preempted_at_chunk = None
    for r in range(1, cfg.rounds + 1):
        x, y = rounds_data[r - 1]
        tap.feed(x, y)
        if r == cfg.pressure_round:
            # One idle consultation (admission), then pressure: the fold
            # preempts at the first sustained chunk boundary.
            scheduler.seed_pressure_after(1)
        box: Dict[str, Any] = {}

        def load_body() -> None:
            box["load"] = serve_round(r)

        t0 = time.perf_counter()
        load_thread = threading.Thread(target=load_body, name="cosched-load")
        load_thread.start()
        outcomes = [daemon.run_once()]
        if r == cfg.pressure_round:
            preempted_at_chunk = daemon.outcomes[-1].get("preempted_at_chunk")
            scheduler.seed_pressure_after(None)
            # Resume INSIDE the same serving window: the deferred fold
            # picks up from its durable cursor, not from row zero.
            outcomes.append(daemon.run_once())
        load_thread.join()
        sync()
        cosched_wall += time.perf_counter() - t0
        load = box["load"]
        dropped += int(load["dropped"])
        stats = server.stats()
        if r > cfg.settle_round:
            steady_plans = max(steady_plans, int(stats.get("cufft_plans_since_warmup") or 0))
        server.restamp_compile_baseline()
        round_records.append(
            {
                "round": r,
                "outcomes": outcomes,
                "p99_ms": load["p99_ms"],
                "completed": load["completed"],
                "dropped": load["dropped"],
            }
        )
    server.stop(drain=True)

    # ------------------------------------------------------------ evidence
    # Parity: the scheduled chain (with the preempt→resume round) against
    # the unscheduled serial chain on the same rows.
    live_model = daemon.estimator.finish_from_state(daemon.state)
    serial_model = serial_daemon.estimator.finish_from_state(serial_daemon.state)
    parity = float(
        (live_model.weights.double() - serial_model.weights.double()).abs().max()
    )

    sched_stats = scheduler.stats()
    outcomes_flat = [o for rec in round_records for o in rec["outcomes"]]
    p99_worst = max(rec["p99_ms"] for rec in round_records)
    ledger_kinds = sorted(
        {e.kind for e in get_recovery_log().events() if e.kind.startswith("sched_")}
    )
    ratio = cosched_wall / serial_wall if serial_wall else None
    return {
        "d": cfg.d,
        "classes": cfg.classes,
        "rounds": round_records,
        "publishes": outcomes_flat.count("published"),
        "deferred_rounds": outcomes_flat.count("deferred"),
        "dropped": int(dropped),
        "cufft_plans_steady_state_post_settle": int(steady_plans),
        "serial_wall_s": round(serial_wall, 4),
        "cosched_wall_s": round(cosched_wall, 4),
        "cosched_vs_serial_ratio": round(ratio, 4) if ratio else None,
        "cosched_faster": bool(ratio is not None and ratio < 1.0),
        "p99_ms_worst": p99_worst,
        "serial_p99_ms_worst": max(serial_p99) if serial_p99 else None,
        "slo_target_ms": cfg.slo_target_ms,
        "p99_within_slo": bool(p99_worst < cfg.slo_target_ms),
        "leases": int(sched_stats["leases"]),
        "leases_completed": int(sched_stats["outcomes"].get("completed", 0)),
        "preemptions": int(sched_stats["outcomes"].get("preempted", 0)),
        "preempted_at_chunk": preempted_at_chunk,
        "parity_max_abs_diff": parity,
        "parity_ok": bool(parity <= 1e-6),
        "idle_harvest_s": sched_stats["idle_harvest_s"],
        "ledger_kinds": ledger_kinds,
        "obs": {"schedule": scheduler.schedule()},
    }
