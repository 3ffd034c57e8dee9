"""Serving worker process: one ``PipelineServer`` behind a JSON-lines
control pipe. Port of ``keystone_tpu/serving/worker.py``.

The unit of isolation in the multi-worker runtime is the OS process: a
worker that segfaults, runs out of memory, or wedges in native code takes
down exactly one process (and its CUDA context), and the
:class:`~keystone_tpu_torch.serving.supervisor.WorkerSupervisor` that
spawned it restarts it and requeues its in-flight requests. This module
is the worker side of that contract — run as

    python -m keystone_tpu_torch.serving.worker --spec '<json>' --worker-id 0 [--device cpu]

Protocol (one JSON object per line; supervisor → worker on stdin,
worker → supervisor on stdout):

    → {"kind": "request", "id": N, "x": [...], "model": ..., "deadline_ms": ...,
       "trace": "<trace_id>:<span_id>"}
    → {"kind": "swap", "name": ..., "spec": {...}}
    → {"kind": "stats"}
    → {"kind": "shutdown"}
    ← {"kind": "ready", "worker": ..., "pid": ..., "mode": ..., "init_s": ...,
       "boot_image": ..., "ledger_kinds": [...],
       "clock": {"unix": ..., "perf": ...}}
    ← {"kind": "response", "id": N, "y": [...], "latency_ms": ...}   (or "error")
    ← {"kind": "heartbeat", "seq": K, "worker": ..., "stats": {...},
       "spans": [...], "metrics_delta": {...}, "clock": {...},
       "quality": {<model>: <sketch delta>}}
    ← {"kind": "swapped", "name": ..., "version": ..., "warmup_s": ...}
    ← {"kind": "stats", "stats": {...}}

``trace`` is the optional wire trace context stamped at ingress and
forwarded on every (re)dispatch; the worker re-parents its spans under
it so a request's trace id survives frontend → supervisor → worker.
``spans``/``metrics_delta``/
``clock`` ride heartbeats only under ``KEYSTONE_FLEET_TRACE=1``: bounded
span fragments, the metric-registry delta since the last beat, and the
clock-alignment anchor.

``deadline_ms`` is the REMAINING budget at the supervisor→worker
boundary; the worker rebuilds a :class:`~keystone_tpu_torch.reliability.
retry.Deadline` from it, so queue expiry and the retry-around-apply bound
keep working end-to-end.

Heartbeats ride a dedicated thread: they keep flowing through long
applies (a slow worker is a *straggler*, visible to the SLO controller
via the stats they carry) and stop only when the process is wedged or
dead (a *hang*, which the supervisor treats like a crash). Fault specs
arrive via ``KEYSTONE_FAULT_SPECS`` (:func:`~keystone_tpu_torch.
reliability.faultinject.install_from_env`) with two probe sites: a ``kill``/``hang``
at ``serving.worker.request`` crashes/straggles the worker mid-load, a
``corrupt``/``hang`` at ``serving.worker.heartbeat`` garbles/stops the
heartbeat channel.

The model ``spec`` names one of the registry's load doors —
``{"synthetic": {"d": ...}}``, ``{"model": path}``, or
``{"checkpoint_dir": ..., "digest": ...}`` — or ``{"stub": {...}}``, an
echo backend that imports no torch, so supervisor logic is testable
without paying a torch import and a CUDA context per worker. A server-
mode worker runs on ``--device`` (default the CUDA device; without a card
it raises and never serves on the CPU unless asked) and reports
``cufft_plans_since_warmup`` where the JAX worker reports XLA compiles,
plus its ``device_counts`` (ELL launches, binding calls, peak bytes) and
``nvcc_builds`` (kernel libraries this process compiled; 0 when they
were built before or hydrated from a boot image).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from ..envknobs import env_flag
from ..obs import fleet as _fleet
from ..obs import spans as _spans
from ..obs.flight import get_flight_recorder, install_flight_recorder
from ..obs.metrics import delta as _metrics_delta, get_registry
from ..obs.quality import get_quality_plane
from ..reliability import faultinject
from ..reliability.faultinject import probe
from ..reliability.recovery import get_recovery_log

PROBE_REQUEST = "serving.worker.request"
PROBE_HEARTBEAT = "serving.worker.heartbeat"


class _Emitter:
    """Serialized line writer (responses come from future callbacks on the
    server's worker thread while heartbeats come from the beat thread)."""

    def __init__(self, stream=None):
        self._stream = stream or sys.stdout
        self._lock = threading.Lock()

    def emit(self, obj: Dict[str, Any]) -> None:
        self.emit_raw(json.dumps(obj))

    def emit_raw(self, line: str) -> None:
        with self._lock:
            self._stream.write(line + "\n")
            self._stream.flush()


# ------------------------------------------------------------------ backends


class StubBackend:
    """Echo backend that imports no torch: ``y = 2·x`` after an optional
    fixed delay.

    Exists for supervisor/SLO unit tests — protocol handling, crash
    recovery, requeueing, and hang detection are all properties of the
    pipe layer, not of what computes ``y``. The delay knob makes the
    worker a deterministic straggler (p99 ≈ delay), which is how the SLO
    path is exercised without a backend.
    """

    mode = "stub"

    def __init__(self, spec: Dict[str, Any]):
        self.delay_s = float(spec.get("delay_ms", 0.0)) / 1e3
        self.fail_every = int(spec.get("fail_every", 0))
        self._lock = threading.Lock()
        self._latencies: list = []
        self.served = 0
        self.failures = 0
        self.version = 1  # swap acks carry the version they "warmed"

    def handle(self, msg: Dict[str, Any], emitter: _Emitter) -> None:
        t0 = time.monotonic()
        if self.delay_s:
            time.sleep(self.delay_s)
        x = msg.get("x")
        with self._lock:
            n = self.served + self.failures + 1
        if self.fail_every and n % self.fail_every == 0:
            with self._lock:
                self.failures += 1
            emitter.emit(
                {"kind": "response", "id": msg.get("id"),
                 "error": "InjectedStubFailure: fail_every"}
            )
            return
        if not isinstance(x, list) or not x:
            with self._lock:
                self.failures += 1
            emitter.emit(
                {"kind": "response", "id": msg.get("id"),
                 "error": f"ValueError: bad payload: {x!r}"}
            )
            return
        if x == ["deadline-echo"]:
            # Deadline-propagation probe: answer with the remaining
            # budget this worker actually received at its boundary.
            with self._lock:
                self.served += 1
            emitter.emit(
                {"kind": "response", "id": msg.get("id"),
                 "y": [float(msg.get("deadline_ms") or -1.0)]}
            )
            return
        latency_s = time.monotonic() - t0
        with self._lock:
            self.served += 1
            self._latencies.append(latency_s)
            if len(self._latencies) > 2048:
                del self._latencies[:1024]
        y = [2.0 * float(v) for v in x]
        # Quality plane: sketch the payload and feed the prediction
        # score (mean output — the scalar proxy both backends use) into
        # the pending heartbeat delta.
        get_quality_plane().observe_served(
            msg.get("model") or "default", x, sum(y) / len(y)
        )
        emitter.emit(
            {
                "kind": "response",
                "id": msg.get("id"),
                "y": y,
                "latency_ms": round(latency_s * 1e3, 3),
                # Echo the budget the worker SAW: supervisor tests assert
                # the remaining deadline crossed the boundary.
                "deadline_ms": msg.get("deadline_ms"),
            }
        )

    def swap(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self.version += 1
            version = self.version
        return {
            "name": msg.get("name", "default"),
            "version": version,
            "warmup_s": 0.0,
        }

    def stats(self) -> Dict[str, Any]:
        from ..obs.metrics import percentile

        with self._lock:
            window = list(self._latencies)
            out = {
                "served": self.served,
                "failures": self.failures,
                "sheds": 0,
                "timeouts": 0,
                "retries": 0,
                "batches": self.served,
                "p50_ms": round(percentile(window, 50) * 1e3, 3),
                "p99_ms": round(percentile(window, 99) * 1e3, 3),
                "cufft_plans_since_warmup": 0,
                # Publish provenance, the stub shape of the server
                # backend's registry describe() (satellite contract:
                # stats surface the active version everywhere).
                "models": {
                    "default": {
                        "current": self.version,
                        "published_at": None,
                        "last_rollback": None,
                    }
                },
            }
        return out

    def close(self) -> None:
        pass


class ServerBackend:
    """The real thing: a :class:`~keystone_tpu_torch.serving.server.
    PipelineServer` on ``--device`` over a registry built from the model
    spec, or from a boot image."""

    mode = "server"

    def __init__(self, spec: Dict[str, Any], args: argparse.Namespace):
        import numpy as np

        from ..device import resolve_device
        from ..reliability.retry import RetryPolicy
        from .config import ServingConfig
        from .registry import ModelRegistry
        from .server import PipelineServer

        self.device = resolve_device(args.device)
        self.name = args.model_name
        self.registry = ModelRegistry()
        # Boot-image door: the image's weights, kernel libraries and
        # example instead of the spec's load and a first-request warmup.
        # A KV307 refusal (stale/mismatched image) falls through to the
        # classic path — slower first request, never garbage; the
        # refusal is already in the ledger.
        self.boot_image = None
        self._example = None
        if getattr(args, "boot_image", None):
            from .bootimage import BootImageRefused, load_boot_image

            try:
                image = load_boot_image(args.boot_image, device=self.device)
                self.registry.publish(self.name, image, source=f"bootimage:{args.boot_image}")
                example = image.manifest["example"]
                self._example = np.zeros(tuple(example["shape"]), np.dtype(example["dtype"]))
                self.boot_image = "loaded"
            except BootImageRefused:
                self.boot_image = "refused"
        if self.boot_image != "loaded":
            self._example = _load_spec(self.registry, self.name, spec, self.device)
        config = ServingConfig(
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            queue_depth=args.queue_depth,
            retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.05),
        )
        self.server = PipelineServer(
            config=config, registry=self.registry, name=self.name, device=self.device
        ).start()
        self._warmed = False
        if self._example is not None:
            self.server.warmup(self._example)
            self._warmed = True

    def handle(self, msg: Dict[str, Any], emitter: _Emitter) -> None:
        import numpy as np

        from .config import ServingError

        request_id = msg.get("id")
        try:
            # Request ingress: x arrived as JSON over the control pipe,
            # host-native by construction.  # keystone: allow-sync
            payload = np.asarray(msg.get("x"), np.float32)
            if payload.ndim == 0:
                raise ValueError(f"x must be an array, got {msg.get('x')!r}")
        except (TypeError, ValueError) as exc:
            emitter.emit(
                {"kind": "response", "id": request_id,
                 "error": f"bad payload: {exc}"}
            )
            return
        if not self._warmed:
            # Artifact/checkpoint specs don't declare a request shape;
            # the first payload does, and later swaps re-warm with it.
            self._example = payload
            self.server.warmup(payload)
            self._warmed = True
        deadline_ms = msg.get("deadline_ms")
        t0 = time.monotonic()
        try:
            # `is not None`, not truthiness: the supervisor sends the
            # REMAINING budget, and 0.0 means exhausted — that request
            # must time out, not run unbounded.
            future = self.server.submit(
                payload,
                deadline_s=(
                    float(deadline_ms) / 1e3 if deadline_ms is not None else None
                ),
                model=msg.get("model") or None,
            )
        except ServingError as exc:
            emitter.emit(
                {"kind": "response", "id": request_id,
                 "error": f"{type(exc).__name__}: {exc}"}
            )
            return

        def on_done(f) -> None:
            try:
                # The server copied the batch's output to the host once
                # and sliced this row there: no device sync per row.
                # keystone: allow-sync — host row, host payload
                y = np.asarray(f.result(), np.float64).reshape(-1)
                y_list, x_list = y.tolist(), payload.reshape(-1).tolist()
                get_quality_plane().observe_served(
                    msg.get("model") or self.name,
                    x_list,
                    float(y.mean()) if y.size else None,
                )
                emitter.emit(
                    {
                        "kind": "response",
                        "id": request_id,
                        "y": y_list,
                        "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                    }
                )
            except Exception as exc:
                emitter.emit(
                    {"kind": "response", "id": request_id,
                     "error": f"{type(exc).__name__}: {exc}"}
                )

        future.add_done_callback(on_done)

    def swap(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Publish a new model version and re-warm its buckets. Publish is
        atomic (in-flight batches finish on the entry they resolved); the
        warmup that follows restamps the plan baseline, so
        ``cufft_plans_since_warmup`` reads 0 once the swap settles."""
        name = msg.get("name", self.name)
        _load_spec(self.registry, name, msg["spec"], self.device)
        t0 = time.monotonic()
        if self._example is not None:
            self.server.warmup(self._example, models=[name])
        entry = self.registry.resolve(name)
        return {
            "name": name,
            "version": entry.version,
            "warmup_s": round(time.monotonic() - t0, 3),
        }

    def stats(self) -> Dict[str, Any]:
        from ..ops.cuda import _build, device_counts

        out = self.server.stats()
        out["device_counts"] = device_counts(self.device)
        out["nvcc_builds"] = sum(1 for s in _build.build_seconds.values() if s > 0)
        return out

    def close(self) -> None:
        self.server.stop(drain=True)


def _load_spec(registry, name: str, spec: Dict[str, Any], device: Any) -> Optional[Any]:
    """Publish one model described by ``spec`` into ``registry`` on
    ``device``; returns a warmup example when the spec implies a request
    shape."""
    if "synthetic" in spec:
        import numpy as np

        from .synthetic import synthetic_fitted_pipeline

        params = dict(spec["synthetic"])
        d = int(params.get("d", 64))
        registry.publish(
            name,
            synthetic_fitted_pipeline(
                d=d, depth=int(params.get("depth", 2)), seed=int(params.get("seed", 0)),
                device=device,
            ),
            source=f"synthetic:d={d}",
        )
        return np.zeros((d,), np.float32)
    if "model" in spec:
        registry.load_fitted(name, spec["model"], device=device)
        return None
    if "checkpoint_dir" in spec:
        registry.load_checkpoint(name, spec["checkpoint_dir"], spec["digest"], device=device)
        return None
    raise ValueError(f"model spec names no load door: {sorted(spec)}")


# ----------------------------------------------------------------- main loop


def add_worker_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--spec", required=True, help="model spec (JSON object)")
    parser.add_argument("--worker-id", default="0")
    parser.add_argument("--model-name", default="default")
    parser.add_argument("--heartbeat-s", type=float, default=0.5)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--queue-depth", type=int, default=64)
    parser.add_argument(
        "--boot-image",
        default=None,
        help="boot-image directory (serving/bootimage.py): load its "
        "weights, kernel libraries and example instead of the spec's; "
        "falls back to the spec on refusal",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to serve on (default: the CUDA device; 'cpu' "
        "to serve on the CPU)",
    )


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(prog="keystone_tpu_torch.serving.worker")
    add_worker_arguments(parser)
    args = parser.parse_args(argv)
    # Always-on flight recorder: an armed fault probe (including `kill`,
    # which records its ledger event BEFORE the SIGKILL) dumps this
    # worker's post-mortem to KEYSTONE_FLIGHT_DIR on the way down.
    install_flight_recorder(f"worker{args.worker_id}")
    faultinject.install_from_env()
    # Fleet tracing: a process-lifetime span session whose spans ship to
    # the supervisor as heartbeat fragments.
    session = (
        _spans.install_session(f"worker{args.worker_id}", sync_timings=False)
        if env_flag(_fleet.FLEET_TRACE_ENV)
        else None
    )
    emitter = _Emitter()
    spec = json.loads(args.spec)
    t0 = time.monotonic()
    backend = StubBackend(spec["stub"]) if "stub" in spec else ServerBackend(spec, args)
    emitter.emit(
        {
            "kind": "ready",
            "worker": args.worker_id,
            "pid": os.getpid(),
            "mode": backend.mode,
            "boot_image": getattr(backend, "boot_image", None),
            "ledger_kinds": sorted({e.kind for e in get_recovery_log().events()}),
            # From after this module's imports to ready: the backend's
            # model load, kernel libraries and warmup.
            "init_s": round(time.monotonic() - t0, 3),
            # Clock anchor for the fleet trace's alignment handshake.
            "clock": {"unix": time.time(), "perf": time.perf_counter()},
        }
    )

    stop = threading.Event()

    #: the span-fragment cursor, shared by the beats and the exit line.
    cursor = {"spans": 0}

    def heartbeat_loop() -> None:
        seq = 0
        last_metrics: Dict[str, float] = get_registry().snapshot()
        while not stop.is_set():
            seq += 1
            payload: Dict[str, Any] = {
                "kind": "heartbeat",
                "seq": seq,
                "worker": args.worker_id,
                "pid": os.getpid(),
                "stats": backend.stats(),
            }
            if session is not None:
                # Fleet telemetry rides the beat: bounded span-fragment
                # drain, the clock anchor, and the metric-registry delta
                # since the last beat (the supervisor folds deltas
                # monotonically across incarnations).
                fragments, cursor["spans"] = _fleet.drain_fragments(
                    session, cursor["spans"]
                )
                if fragments:
                    payload["spans"] = fragments
                snapshot = get_registry().snapshot()
                moved = _metrics_delta(snapshot, last_metrics)
                last_metrics = snapshot
                if moved:
                    payload["metrics_delta"] = moved
                payload["clock"] = {
                    "unix": time.time(), "perf": time.perf_counter()
                }
            # Quality sketch deltas ride every beat (independent of the
            # fleet-trace switch): the pending per-model payload/score
            # sketches accumulated since the last beat, drained here and
            # merged fleet-wide by the supervisor. Deltas are increments,
            # so a restarted worker needs no incarnation folding.
            quality_delta = get_quality_plane().drain_delta()
            if quality_delta is not None:
                payload["quality"] = quality_delta
            recorder = get_flight_recorder()
            if recorder is not None:
                recorder.observe_metrics()  # rate-limited ring snapshot
            line = json.dumps(payload)
            injector = faultinject.current()
            if injector is not None:
                # One wrap covers the whole chaos menu at this site:
                # corrupt garbles the line, hang stalls the channel,
                # kill takes the process down between beats.
                line = injector.wrap(PROBE_HEARTBEAT, lambda: line)()
            emitter.emit_raw(line)
            stop.wait(args.heartbeat_s)

    beat = threading.Thread(
        target=heartbeat_loop, name="keystone-worker-heartbeat", daemon=True
    )
    beat.start()

    exit_code = 0
    try:
        for raw in sys.stdin:
            raw = raw.strip()
            if not raw:
                continue
            try:
                msg = json.loads(raw)
                kind = msg.get("kind")
            except (json.JSONDecodeError, AttributeError) as exc:
                emitter.emit({"kind": "error", "error": f"bad control line: {exc}"})
                continue
            if kind == "request":
                try:
                    # Re-parent under the originating trace: the wire
                    # context (supervisor dispatch hop) becomes this
                    # worker's span parent, so serve:request spans land
                    # on the ingress trace id. No-ops without a session;
                    # a malformed trace field just drops the link.
                    context = _spans.from_wire(msg.get(_spans.WIRE_FIELD))
                    with _spans.span(
                        "worker:request",
                        parent=context,
                        worker=args.worker_id,
                        request_id=msg.get("id"),
                    ):
                        probe(PROBE_REQUEST)
                        backend.handle(msg, emitter)
                except Exception as exc:
                    # Injected faults (and anything else request-scoped)
                    # answer THIS request; the loop must survive them.
                    emitter.emit(
                        {"kind": "response", "id": msg.get("id"),
                         "error": f"{type(exc).__name__}: {exc}"}
                    )
            elif kind == "swap":
                try:
                    result = backend.swap(msg)
                    emitter.emit({"kind": "swapped", **result})
                except Exception as exc:
                    emitter.emit(
                        {"kind": "swap_failed",
                         "error": f"{type(exc).__name__}: {exc}"}
                    )
            elif kind == "stats":
                emitter.emit({"kind": "stats", "stats": backend.stats()})
            elif kind == "shutdown":
                break
            else:
                emitter.emit({"kind": "error", "error": f"unknown kind {kind!r}"})
    finally:
        stop.set()
        backend.close()
        final: Dict[str, Any] = {"kind": "stats", "stats": backend.stats(), "final": True}
        if session is not None:
            # The exit line carries every fragment no beat has shipped
            # yet, so a merge after the fleet stops holds this worker's
            # whole trace however late its last beat would have come.
            beat.join(max(1.0, 4 * args.heartbeat_s))
            fragments, cursor["spans"] = _fleet.drain_fragments(
                session, cursor["spans"], limit=1 << 30
            )
            if fragments:
                final["spans"] = fragments
            final["clock"] = {"unix": time.time(), "perf": time.perf_counter()}
        emitter.emit(final)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
