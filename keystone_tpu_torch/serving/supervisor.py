"""Worker supervisor: N serving processes, crash/hang recovery, and the
no-request-ever-dropped requeue contract. Port of
``keystone_tpu/serving/supervisor.py``.

The supervisor owns N :mod:`~keystone_tpu_torch.serving.worker`
processes, watches them through heartbeats on the control pipe, and
enforces one invariant end to end — **a request accepted by ``submit``
is answered exactly once, even if the worker holding it is SIGKILLed
mid-batch** (it is requeued onto a healthy worker, or parked until a
restart, and only a deadline/shutdown can fail it).

    submit ──► admission ──► HashRing route ──► worker stdin ──► response
                  │                │                                 │
             (SLO-pinned)     dead worker?                    settle future
                              requeue in-flight ──► healthy worker / pending

Recovery behaviors, all visible in the recovery ledger and
``keystone_serving_worker_*`` metrics:

- **crash** — the process exited (or its pipe broke): ``worker_crash``
  event, in-flight requeued, restart scheduled on the
  :class:`~keystone_tpu_torch.reliability.retry.RetryPolicy` backoff schedule.
- **hang** — the process is alive but heartbeats stopped (wedged native
  code, a garbled channel): SIGKILL, then the crash path. Heartbeats
  ride their own worker thread, so a *slow* worker keeps beating — that
  is a straggler, which the SLO controller (not the supervisor) acts on.
- **restart** — a respawned worker reloads its model from the spec (or
  its boot image), re-warms every bucket, reaches ``ready``, logs
  ``worker_restart``, and takes traffic again. Chaos armed via
  ``KEYSTONE_FAULT_SPECS_WORKER_<id>`` applies to the first incarnation
  only — restarts come up clean, so injected kills terminate.

Routing is consistent-hash by model name (+ an optional client affinity
key, defaulting to the request id so single-model traffic still spreads
across the fleet): a worker leaving/rejoining moves only its share of
the keyspace, which keeps each worker's traffic stable across restarts.

Workers are started with ``subprocess.Popen`` (``python -m
keystone_tpu_torch.serving.worker``), never forked: a fork of a process
that holds a CUDA context is unusable in the child, and each worker
opens its own context on the card. This module imports no torch; the
supervisor's process holds no model.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from bisect import bisect_right
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..obs import names as _names
from ..obs import spans as _spans
from ..obs.fleet import MONOTONIC_WORKER_COUNTERS, FleetTraceCollector
from ..obs.flight import get_flight_recorder, install_flight_recorder
from ..obs.quality import QualityPlane
from ..reliability.recovery import get_recovery_log
from ..reliability.retry import Deadline, RetryPolicy
from .admission import AdmissionController
from .config import (
    RequestShed,
    RequestTimeout,
    ServerClosed,
    ServingError,
    settle_exception as _settle_exception,
    settle_result as _settle_result,
)
from .slo import SLO_RUNGS, SLOController

FAULT_SPECS_WORKER_ENV = "KEYSTONE_FAULT_SPECS_WORKER_"


class HashRing:
    """Consistent hashing over a fixed worker-id set: each id owns
    ``replicas`` points on a 128-bit ring; ``walk(key)`` yields distinct
    ids in ring order from the key's position, so the caller takes the
    first *healthy* one and a dead worker sheds only its own keyspace."""

    def __init__(self, node_ids: Sequence[str], replicas: int = 64):
        points: List[tuple] = []
        for node in node_ids:
            for i in range(replicas):
                digest = hashlib.md5(f"{node}#{i}".encode()).hexdigest()
                points.append((int(digest, 16), node))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._nodes = [p[1] for p in points]
        self._distinct = len(set(node_ids))

    def walk(self, key: str):
        start = bisect_right(
            self._hashes, int(hashlib.md5(key.encode()).hexdigest(), 16)
        )
        seen = set()
        for i in range(len(self._nodes)):
            node = self._nodes[(start + i) % len(self._nodes)]
            if node not in seen:
                seen.add(node)
                yield node
                if len(seen) == self._distinct:
                    return


@dataclass(frozen=True)
class SupervisorConfig:
    """Knobs for one :class:`WorkerSupervisor`.

    workers          — worker process count.
    heartbeat_s      — worker beat period (passed to workers).
    hang_timeout_s   — stale-heartbeat bound before a live process is
                       declared hung and SIGKILLed. The JAX package's 2 s
                       ×5: beats ride their own thread, and a worker's
                       first batch on the card (cuFFT plans, the
                       binding's first load) must not read as a hang.
    ready_timeout_s  — spawn → ready bound (interpreter, torch import,
                       CUDA context, model load and warmup: ~8 s on the
                       card, more with several workers starting at once).
    restart_policy   — backoff schedule for restarts (reliability layer).
    max_restarts     — per-worker restart budget; past it the worker is
                       failed permanently (a crash loop must not spin).
    queue_depth      — supervisor admission capacity (outstanding =
                       in-flight + parked).
    slo_target_p99_ms— enable the SLO controller at this target.
    max_batch / max_wait_ms / worker_queue_depth — forwarded to each
                       worker's ``ServingConfig``.
    boot_image       — boot-image directory forwarded to every worker
                       (``--boot-image``): spawned workers load the
                       image's weights and kernel libraries and warm from
                       its example, falling back on a KV307 refusal.
    device           — the workers' torch device (``--device``); None is
                       the CUDA device, and a worker without one raises.
    """

    workers: int = 2
    heartbeat_s: float = 0.25
    hang_timeout_s: float = 10.0
    ready_timeout_s: float = 120.0
    restart_policy: RetryPolicy = field(
        default_factory=lambda: RetryPolicy(
            max_attempts=6, base_delay_s=0.2, max_delay_s=5.0, jitter=0.1
        )
    )
    max_restarts: int = 8
    queue_depth: int = 1024
    slo_target_p99_ms: Optional[float] = None
    model_name: str = "default"
    max_batch: int = 8
    max_wait_ms: float = 2.0
    worker_queue_depth: int = 64
    monitor_interval_s: float = 0.05
    drain_timeout_s: float = 30.0
    boot_image: Optional[str] = None
    device: Optional[str] = None


@dataclass
class _Pending:
    """One accepted request, wherever it currently lives."""

    request_id: int
    payload: Any
    model: Optional[str]
    key: Optional[str]
    deadline: Optional[Deadline]
    future: Future = field(default_factory=Future)
    requeues: int = 0
    #: submit-time trace context; every (re)dispatch forwards it on the
    #: control pipe so the worker's spans re-parent under the originating
    #: trace. None when tracing is off — zero wire bytes.
    trace: Optional[_spans.TraceContext] = None


class _Worker:
    """Supervisor-side handle for one worker process (any incarnation)."""

    def __init__(self, worker_id: str):
        self.id = worker_id
        self.proc: Optional[subprocess.Popen] = None
        # new | spawning | ready | draining | dead | failed. ``draining``
        # is the scale-down limbo: out of the ring, refusing new work,
        # finishing its in-flight — then retired (removed), not restarted.
        self.state = "new"
        self.drain_started = 0.0
        self.incarnation = -1
        self.restarts = 0
        self.restart_at = 0.0
        self.restart_reason = ""
        self.spawn_at = 0.0
        self.last_beat = 0.0
        self.stats: Dict[str, Any] = {}
        #: restart-safe counter accounting: ``counter_hw`` is the
        #: high-water mark of the CURRENT incarnation's counters (from
        #: heartbeats, monotone within an incarnation); ``counter_base``
        #: holds the folded totals of every dead incarnation. Lifetime
        #: value = base + hw, monotonic across restarts — what stats()
        #: aggregates and the fleet /metrics exposition publishes.
        self.counter_base: Dict[str, float] = {}
        self.counter_hw: Dict[str, float] = {}
        self.inflight: Dict[int, _Pending] = {}
        self.write_lock = threading.Lock()
        self.control_replies: "deque[Dict[str, Any]]" = deque()
        self.stderr_tail: "deque[str]" = deque(maxlen=40)
        self.pid: Optional[int] = None
        self.reader_thread: Optional[threading.Thread] = None
        #: the current incarnation's start: its ``ready`` line's
        #: ``init_s``, ``boot_image`` and ``ledger_kinds``, and the
        #: seconds from spawn to that line.
        self.ready_info: Dict[str, Any] = {}
        #: the current incarnation's exit stats line (``final``), which
        #: carries its last span fragments, has been read.
        self.final_seen = False

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class WorkerSupervisor:
    """Spawn, watch, and restart N serving worker processes."""

    def __init__(
        self,
        spec: Dict[str, Any],
        config: Optional[SupervisorConfig] = None,
        worker_cmd: Optional[Callable[[str], List[str]]] = None,
        env: Optional[Dict[str, str]] = None,
        tap: Any = None,
    ):
        self.spec = spec
        self.config = config or SupervisorConfig()
        self._worker_cmd = worker_cmd or self._default_worker_cmd
        self._env = dict(env or {})
        #: Opt-in refit traffic tap (refit/tap.py): accepted payloads are
        #: sampled at submit — the parent process is the only place that
        #: sees every request in the multi-worker runtime. Non-blocking
        #: by the tap contract; a tap bug never fails a submit.
        self.tap = tap
        self._lock = threading.Lock()
        self._workers: Dict[str, _Worker] = {
            str(i): _Worker(str(i)) for i in range(self.config.workers)
        }
        #: Next id handed out by add_worker — ids are never recycled, so
        #: a retired worker's ledger/metrics history stays unambiguous.
        self._next_worker_id = self.config.workers
        #: Retired workers' folded lifetime counters + restart counts:
        #: scale-down removes the _Worker handle, but the fleet /metrics
        #: series and stats() aggregates must stay monotonic.
        self._retired: Dict[str, Dict[str, float]] = {}
        self._retired_restarts = 0
        self._ring = HashRing(list(self._workers))
        self._pending: "deque[_Pending]" = deque()
        self._request_ids = iter(range(1, 2**62))
        self._closed = False
        self._drained = False
        self._started = False
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.requeued = 0
        self.admission = AdmissionController(
            self.config.queue_depth,
            rungs=SLO_RUNGS,
            label="serving-supervisor",
            external=True,
        )
        self.slo: Optional[SLOController] = None
        if self.config.slo_target_p99_ms is not None:
            self.slo = SLOController(
                self.admission, self.config.slo_target_p99_ms
            )
        #: Fleet observability sink: worker span fragments + metric
        #: deltas arriving on heartbeats land here; the frontend's
        #: /metrics and the merged fleet trace read it.
        self.fleet = FleetTraceCollector()
        self._fragments_missing: List[str] = []
        #: Fleet quality view (the quality plane):
        #: worker heartbeat sketch deltas merge here; /metrics and
        #: stats() read it. Own instance, not the process
        #: singleton — a supervisor sharing a process with an in-process
        #: server must not mix fleet and local observations.
        self.quality = QualityPlane()
        # Always-on flight recorder (idempotent; a frontend sharing this
        # process may have installed one already): worker_crash ledger
        # events auto-dump the supervisor's post-mortem view.
        install_flight_recorder("supervisor")
        self._m_restarts = _names.metric(_names.SERVING_WORKER_RESTARTS)
        self._m_requeued = _names.metric(_names.SERVING_WORKER_REQUEUED)
        self._m_alive = _names.metric(_names.SERVING_WORKERS_ALIVE)
        self._m_beats = _names.metric(_names.SERVING_WORKER_HEARTBEATS)
        self._m_sheds = _names.metric(_names.SERVING_SHEDS)
        self._m_scale_events = _names.metric(_names.SERVING_SCALE_EVENTS)
        self._m_draining = _names.metric(_names.SERVING_SCALE_WORKERS_DRAINING)
        self._m_drain_seconds = _names.metric(_names.SERVING_SCALE_DRAIN_SECONDS)

    # ---------------------------------------------------------------- control
    def _default_worker_cmd(self, worker_id: str) -> List[str]:
        return [
            sys.executable, "-m", "keystone_tpu_torch.serving.worker",
            "--spec", json.dumps(self.spec),
            "--worker-id", worker_id,
            "--model-name", self.config.model_name,
            "--heartbeat-s", str(self.config.heartbeat_s),
            "--max-batch", str(self.config.max_batch),
            "--max-wait-ms", str(self.config.max_wait_ms),
            "--queue-depth", str(self.config.worker_queue_depth),
        ] + (
            ["--boot-image", self.config.boot_image]
            if self.config.boot_image
            else []
        ) + (["--device", self.config.device] if self.config.device else [])

    def start(self) -> "WorkerSupervisor":
        if self._started:
            raise RuntimeError("supervisor already started")
        self._started = True
        for worker in list(self._workers.values()):
            self._spawn(worker)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="keystone-supervisor", daemon=True
        )
        self._monitor.start()
        return self

    def __enter__(self) -> "WorkerSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def wait_ready(self, n: Optional[int] = None, timeout_s: float = None) -> int:
        """Block until ``n`` workers (default: every current non-draining,
        non-failed member) are ready; returns the ready count. Raises
        TimeoutError past ``timeout_s`` (default: the config's ready
        timeout)."""
        deadline = Deadline(
            timeout_s if timeout_s is not None else self.config.ready_timeout_s
        )
        while True:
            members = list(self._workers.values())
            # Recomputed every pass: the autoscaler changes membership
            # while callers wait.
            want = (
                sum(1 for w in members if w.state not in ("draining", "failed"))
                if n is None
                else n
            )
            ready = sum(1 for w in members if w.state == "ready")
            if ready >= want:
                return ready
            if deadline.expired():
                states = {w.id: w.state for w in members}
                tails = {
                    w.id: list(w.stderr_tail)[-3:]
                    for w in members if w.state != "ready"
                }
                raise TimeoutError(
                    f"{ready}/{want} workers ready; states={states} stderr={tails}"
                )
            time.sleep(0.02)

    def stop(self, drain: bool = True, timeout_s: Optional[float] = None) -> None:
        with self._lock:
            self._closed = True
        if drain:
            deadline = Deadline(
                timeout_s if timeout_s is not None else self.config.drain_timeout_s
            )
            while not deadline.expired():
                with self._lock:
                    outstanding = len(self._pending) + sum(
                        len(w.inflight) for w in self._workers.values()
                    )
                if outstanding == 0:
                    break
                time.sleep(0.02)
        self._stop.set()
        stopping = [w for w in self._workers.values() if w.alive]
        for worker in list(self._workers.values()):
            self._shutdown_worker(worker)
        for worker in list(self._workers.values()):
            # Join the reader so each worker's exit stats line (final
            # counters and its last span fragments) is folded in before
            # stats() snapshots or a fleet trace merges. The process has
            # exited (or been killed) by now, so the pipe ends; the hang
            # timeout bounds a reader still parsing a large last line.
            if worker.reader_thread is not None:
                worker.reader_thread.join(max(2.0, self.config.hang_timeout_s))
        self._fragments_missing = sorted(
            f"worker{w.id}" for w in stopping if not w.final_seen
        )
        if self._monitor is not None:
            self._monitor.join(5.0)
        with self._lock:
            # Past this point nothing drains the pending queue: a submit
            # that raced the close must settle, not park forever.
            self._drained = True
            leftovers = self._drain_outstanding_locked()
        for pending in leftovers:
            _settle_exception(pending.future, ServerClosed())
        self._m_alive.set(0)

    def _drain_outstanding_locked(self) -> List[_Pending]:
        out = list(self._pending)
        self._pending.clear()
        for worker in self._workers.values():
            out.extend(worker.inflight.values())
            worker.inflight.clear()
        return [p for p in out if not p.future.done()]

    def _shutdown_worker(self, worker: _Worker) -> None:
        proc = worker.proc
        if proc is None:
            return
        try:
            if proc.poll() is None and proc.stdin:
                with worker.write_lock:
                    proc.stdin.write(json.dumps({"kind": "shutdown"}) + "\n")
                    proc.stdin.flush()
                    proc.stdin.close()
        except Exception:
            pass
        try:
            proc.wait(5.0)
        except Exception:
            proc.kill()

    # ------------------------------------------------------------------ spawn
    def _spawn(self, worker: _Worker) -> None:
        worker.incarnation += 1
        worker.final_seen = False
        if worker.incarnation > 0:
            # A restart: fold the dead incarnation's counter high-water
            # marks into the base BEFORE the new process starts counting
            # from zero — aggregated counters stay monotonic across
            # incarnations (stats() and the fleet /metrics contract).
            with self._lock:
                for counter, value in worker.counter_hw.items():
                    worker.counter_base[counter] = (
                        worker.counter_base.get(counter, 0.0) + value
                    )
                worker.counter_hw = {}
                worker.stats = {}
        # A child worker inherits the WHOLE parent environment (store,
        # build-dir and tracing knobs) — a structural pass-through, not a
        # knob read, so it stays a raw access.  # keystone: allow-env
        env = dict(os.environ)
        env.update(self._env)
        chaos = env.pop(FAULT_SPECS_WORKER_ENV + worker.id, None)
        env.pop("KEYSTONE_FAULT_SPECS", None)
        if chaos and worker.incarnation == 0:
            # Process chaos arms the FIRST incarnation only: the restart
            # the chaos exists to provoke must come up clean.
            env["KEYSTONE_FAULT_SPECS"] = chaos
        worker.proc = subprocess.Popen(
            self._worker_cmd(worker.id),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            bufsize=1,
            env=env,
        )
        worker.pid = worker.proc.pid
        worker.state = "spawning"
        worker.spawn_at = time.monotonic()
        worker.last_beat = worker.spawn_at
        worker.reader_thread = threading.Thread(
            target=self._reader_loop,
            args=(worker, worker.proc, worker.incarnation),
            name=f"keystone-supervisor-read-{worker.id}",
            daemon=True,
        )
        worker.reader_thread.start()
        threading.Thread(
            target=self._stderr_loop,
            args=(worker, worker.proc),
            name=f"keystone-supervisor-err-{worker.id}",
            daemon=True,
        ).start()

    # ----------------------------------------------------------- elastic fleet
    def _rebuild_ring_locked(self) -> None:
        """Rebuild the ring over current non-draining members (caller
        holds the lock). A draining worker leaves the ring the instant
        the drain starts, so new affinity keys resolve to their NEW owner
        immediately — a key is never split across old and new owner
        mid-drain (the old owner only finishes work it already holds)."""
        members = [
            worker_id
            for worker_id, w in self._workers.items()
            if w.state != "draining"
        ]
        self._ring = HashRing(members or list(self._workers))

    def add_worker(self, reason: str = "scale_up") -> str:
        """Scale up: add one worker to the fleet and spawn it. The new
        member joins the ring immediately (routing skips it until it
        reaches ``ready``, so booting never stalls traffic). Returns the
        new worker id."""
        with self._lock:
            if self._closed:
                raise ServerClosed()
            worker_id = str(self._next_worker_id)
            self._next_worker_id += 1
            worker = _Worker(worker_id)
            self._workers[worker_id] = worker
            self._rebuild_ring_locked()
        if self._started:
            self._spawn(worker)
        get_recovery_log().record(
            "scale_up",
            f"worker:{worker_id}",
            reason=reason,
            workers=len(self._workers),
        )
        self._m_scale_events.inc(direction="up")
        recorder = get_flight_recorder()
        if recorder is not None:
            recorder.mark(
                "scale_up", worker=worker_id, workers=len(self._workers)
            )
        return worker_id

    def remove_worker(
        self, worker_id: Optional[str] = None, reason: str = "scale_down"
    ) -> Optional[str]:
        """Scale down: pick a ready worker (default: the newest), mark it
        ``draining``, and rebuild the ring without it. The monitor
        retires it once its in-flight drains (or the drain times out, or
        it dies — stranded work is requeued either way: zero dropped).
        Returns the draining worker's id, or None when no worker can be
        spared (never drains the last capable member)."""
        with self._lock:
            capable = [
                w
                for w in self._workers.values()
                if w.state in ("new", "spawning", "ready")
            ]
            if worker_id is not None:
                target = self._workers.get(worker_id)
                if target is None or target.state != "ready":
                    return None
            else:
                ready = sorted(
                    (w for w in self._workers.values() if w.state == "ready"),
                    key=lambda w: (int(w.id) if w.id.isdigit() else 0, w.id),
                )
                target = ready[-1] if ready else None
            if target is None or len(capable) <= 1:
                return None
            target.state = "draining"
            target.drain_started = time.monotonic()
            inflight = len(target.inflight)
            self._rebuild_ring_locked()
            draining = sum(
                1 for w in self._workers.values() if w.state == "draining"
            )
        get_recovery_log().record(
            "scale_down",
            f"worker:{target.id}",
            reason=reason,
            inflight=inflight,
            workers=len(self._workers),
        )
        self._m_scale_events.inc(direction="down")
        self._m_draining.set(draining)
        self._publish_alive()
        recorder = get_flight_recorder()
        if recorder is not None:
            recorder.mark("scale_down", worker=target.id, inflight=inflight)
        return target.id

    def _retire_worker(self, worker: _Worker, crashed: bool) -> None:
        """Finish a drain: stop the process (gracefully unless it already
        crashed/hung), fold its lifetime counters into the retired set,
        remove it from the fleet, and requeue anything still stranded in
        its in-flight map. The one exit path for ``draining`` workers —
        they are never restarted."""
        if crashed:
            proc = worker.proc
            if proc is not None and proc.poll() is None:
                proc.kill()
            get_recovery_log().record(
                "worker_crash",
                f"worker:{worker.id}",
                reason="crash",
                incarnation=worker.incarnation,
                exit_code=worker.proc.poll() if worker.proc else None,
                inflight=len(worker.inflight),
                pid=worker.pid,
            )
        else:
            self._shutdown_worker(worker)
        if worker.reader_thread is not None:
            # Fold the exit stats line (final counters) before retiring.
            worker.reader_thread.join(2.0)
        drain_s = (
            time.monotonic() - worker.drain_started
            if worker.drain_started
            else 0.0
        )
        with self._lock:
            stranded = [
                p for p in worker.inflight.values() if not p.future.done()
            ]
            worker.inflight.clear()
            totals = self._retired.setdefault(worker.id, {})
            for counter in MONOTONIC_WORKER_COUNTERS:
                value = worker.counter_base.get(
                    counter, 0.0
                ) + worker.counter_hw.get(counter, 0.0)
                if value:
                    totals[counter] = totals.get(counter, 0.0) + value
            self._retired_restarts += worker.restarts
            self._workers.pop(worker.id, None)
            self._rebuild_ring_locked()
            draining = sum(
                1 for w in self._workers.values() if w.state == "draining"
            )
        for pending in stranded:
            pending.requeues += 1
            with self._lock:
                self.requeued += 1
            self._m_requeued.inc()
            self._route_or_park(pending, exclude=worker.id)
        get_recovery_log().record(
            "worker_retired",
            f"worker:{worker.id}",
            crashed=crashed,
            drain_s=round(drain_s, 3),
            requeued=len(stranded),
            workers=len(self._workers),
        )
        self._m_drain_seconds.observe(drain_s)
        self._m_draining.set(draining)
        self._publish_alive()
        recorder = get_flight_recorder()
        if recorder is not None:
            recorder.mark(
                "worker_retired", worker=worker.id, crashed=crashed
            )

    # ----------------------------------------------------------------- reader
    def _reader_loop(
        self, worker: _Worker, proc: subprocess.Popen, incarnation: int
    ) -> None:
        for raw in proc.stdout:
            raw = raw.strip()
            if not raw:
                continue
            try:
                msg = json.loads(raw)
                kind = msg.get("kind")
            except (json.JSONDecodeError, AttributeError):
                # A corrupt line is NOT a heartbeat: last_beat stays
                # stale, so a fully-garbled channel trips hang detection.
                self._m_beats.inc(status="bad")
                continue
            if kind == "heartbeat":
                worker.last_beat = time.monotonic()
                worker.stats = msg.get("stats", {})
                self._update_counter_hw(worker, incarnation, worker.stats)
                self._ingest_fleet_telemetry(worker, msg, len(raw))
                self._m_beats.inc(status="ok")
            elif kind == "response":
                self._on_response(worker, msg)
            elif kind == "ready":
                self._on_ready(worker, msg)
            elif kind in ("swapped", "swap_failed", "stats"):
                with self._lock:
                    worker.control_replies.append(msg)
                if kind == "stats" and isinstance(msg.get("stats"), dict):
                    worker.stats = msg["stats"]
                    self._update_counter_hw(worker, incarnation, worker.stats)
                if kind == "stats" and msg.get("final"):
                    # The exit line ships the fragments no heartbeat
                    # carried; only then is this worker's trace whole.
                    self._ingest_fleet_telemetry(worker, msg, len(raw))
                    if worker.incarnation == incarnation:
                        worker.final_seen = True
        # EOF: the process is exiting; the monitor loop owns the verdict.

    def _stderr_loop(self, worker: _Worker, proc: subprocess.Popen) -> None:
        for raw in proc.stderr:
            worker.stderr_tail.append(raw.rstrip())

    def _update_counter_hw(
        self, worker: _Worker, incarnation: int, stats: Any
    ) -> None:
        """Raise the current incarnation's counter high-water marks from a
        heartbeat/stats payload. The incarnation guard is checked INSIDE
        the lock: ``_spawn`` bumps ``worker.incarnation`` before folding
        hw into base under the same lock, so a buffered line from a dead
        incarnation's pipe either lands before the fold (and is folded —
        it is legitimate old-incarnation data) or is rejected here; it
        can never re-pollute the marks after the fold."""
        if not isinstance(stats, dict):
            return
        with self._lock:
            if worker.incarnation != incarnation:
                return
            for counter in MONOTONIC_WORKER_COUNTERS:
                value = stats.get(counter)
                if isinstance(value, (int, float)):
                    worker.counter_hw[counter] = max(
                        worker.counter_hw.get(counter, 0.0), float(value)
                    )

    def _ingest_fleet_telemetry(
        self, worker: _Worker, msg: Dict[str, Any], raw_bytes: int
    ) -> None:
        """Heartbeat-borne fleet telemetry: span fragments, the clock anchor, and the metric-registry delta. All
        optional — a worker not running fleet tracing ships none.
        ``raw_bytes`` is the heartbeat line's length — the wire cost the
        trace-bytes counter reports, without re-serializing fragments on
        this (response-settling) reader thread."""
        role = f"worker{worker.id}"
        pid = msg.get("pid") or worker.pid or 0
        fragments = msg.get("spans")
        if isinstance(fragments, list) and fragments:
            self.fleet.add_fragments(role, pid, fragments, raw_bytes=raw_bytes)
        clock = msg.get("clock")
        if isinstance(clock, dict):
            self.fleet.observe_clock(role, pid, clock)
        delta = msg.get("metrics_delta")
        if isinstance(delta, dict) and delta:
            self.fleet.observe_metrics(worker.id, worker.incarnation, delta)
        quality = msg.get("quality")
        if isinstance(quality, dict) and quality:
            # Sketch deltas are increments (drained-and-reset each beat),
            # so fleet merge needs no incarnation folding.
            try:
                self.quality.merge_delta(quality, role=role)
            except Exception:
                pass  # a malformed delta must not take down the reader

    def _on_ready(self, worker: _Worker, msg: Optional[Dict[str, Any]] = None) -> None:
        worker.last_beat = time.monotonic()
        if msg is not None and isinstance(msg.get("clock"), dict):
            # The ready handshake carries the worker's clock anchor —
            # the alignment datum the merged fleet trace records.
            self.fleet.observe_clock(
                f"worker{worker.id}", msg.get("pid") or worker.pid or 0,
                msg["clock"],
            )
        first = worker.incarnation == 0
        if msg is not None:
            worker.ready_info = {
                "init_s": msg.get("init_s"),
                "spawn_to_ready_s": round(worker.last_beat - worker.spawn_at, 3),
                "boot_image": msg.get("boot_image"),
                "ledger_kinds": msg.get("ledger_kinds"),
            }
        with self._lock:
            if worker.state != "spawning":
                # A buffered ready line can race _declare_dead (e.g. the
                # worker beat ready_timeout_s by microseconds): it must
                # not resurrect a worker already declared dead — that
                # would double-count the crash on the next monitor tick
                # and dispatch parked work at a dead pipe.
                return
            worker.state = "ready"
        if not first:
            get_recovery_log().record(
                "worker_restart",
                f"worker:{worker.id}",
                incarnation=worker.incarnation,
                reason=worker.restart_reason,
                pid=worker.pid,
            )
            self._m_restarts.inc(reason=worker.restart_reason or "crash")
        self._drain_pending()
        self._publish_alive()

    def _on_response(self, worker: _Worker, msg: Dict[str, Any]) -> None:
        with self._lock:
            pending = worker.inflight.pop(msg.get("id"), None)
        if pending is None:
            return  # duplicate after a requeue, or response raced shutdown
        if "error" in msg:
            _settle_exception(pending.future, ServingError(msg["error"]))
        else:
            _settle_result(pending.future, msg.get("y"))

    # ---------------------------------------------------------------- monitor
    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            # Snapshot: scale events mutate membership mid-iteration.
            for worker in list(self._workers.values()):
                if worker.state in ("spawning", "ready"):
                    if not worker.alive:
                        self._declare_dead(worker, "crash")
                    elif (
                        worker.state == "ready"
                        and now - worker.last_beat > self.config.hang_timeout_s
                    ):
                        self._declare_dead(worker, "hang")
                    elif (
                        worker.state == "spawning"
                        and now - worker.spawn_at > self.config.ready_timeout_s
                    ):
                        self._declare_dead(worker, "hang")
                elif worker.state == "draining":
                    # A draining worker only finishes what it holds. Dead
                    # or hung mid-drain: retire as a crash (stranded work
                    # requeued — still zero dropped). Otherwise retire
                    # gracefully once the in-flight empties or the drain
                    # budget expires.
                    if not worker.alive:
                        self._retire_worker(worker, crashed=True)
                    elif now - worker.last_beat > self.config.hang_timeout_s:
                        self._retire_worker(worker, crashed=True)
                    elif (
                        not worker.inflight
                        or now - worker.drain_started
                        > self.config.drain_timeout_s
                    ):
                        self._retire_worker(worker, crashed=False)
                elif worker.state == "dead" and now >= worker.restart_at:
                    self._spawn(worker)
            self._expire_pending()
            self._drain_pending()
            if self.slo is not None:
                snapshots = {
                    w.id: w.stats
                    for w in list(self._workers.values())
                    if w.state == "ready" and w.stats
                }
                if snapshots:
                    self.slo.observe(snapshots)
            self._stop.wait(self.config.monitor_interval_s)

    def _declare_dead(self, worker: _Worker, reason: str) -> None:
        if self._stop.is_set():
            # Shutdown kills workers on purpose; that is not a crash.
            worker.state = "dead"
            return
        proc = worker.proc
        if proc is not None and proc.poll() is None:
            proc.kill()  # a hung process must actually die before respawn
        exit_code = proc.poll() if proc is not None else None
        with self._lock:
            worker.state = "dead"
            stranded = list(worker.inflight.values())
            worker.inflight.clear()
        get_recovery_log().record(
            "worker_crash",
            f"worker:{worker.id}",
            reason=reason,
            incarnation=worker.incarnation,
            exit_code=exit_code,
            inflight=len(stranded),
            pid=worker.pid,
        )
        worker.restart_reason = reason
        schedule = self.config.restart_policy.backoff_schedule()
        delay = (
            schedule[min(worker.restarts, len(schedule) - 1)] if schedule else 0.0
        )
        worker.restarts += 1
        if worker.restarts > self.config.max_restarts:
            worker.state = "failed"
            get_recovery_log().record(
                "worker_failed", f"worker:{worker.id}", restarts=worker.restarts
            )
        else:
            worker.restart_at = time.monotonic() + delay
        self._publish_alive()
        # Requeue the stranded in-flight work: healthy worker if one is
        # ready, else the pending queue until a restart lands. Never
        # dropped — that is THE supervisor invariant.
        for pending in stranded:
            if pending.future.done():
                continue
            pending.requeues += 1
            with self._lock:  # += is read-modify-write; stats() reads it
                self.requeued += 1
            self._m_requeued.inc()
            self._route_or_park(pending, exclude=worker.id)
        if all(w.state == "failed" for w in list(self._workers.values())):
            with self._lock:
                orphans = self._drain_outstanding_locked()
            for pending in orphans:
                _settle_exception(
                    pending.future,
                    ServingError(
                        "UNAVAILABLE: every worker exhausted its restart budget"
                    ),
                )

    def _publish_alive(self) -> None:
        self._m_alive.set(
            sum(1 for w in list(self._workers.values()) if w.state == "ready")
        )

    # ----------------------------------------------------------------- submit
    def submit(
        self,
        payload: Any,
        deadline_s: Optional[float] = None,
        model: Optional[str] = None,
        key: Optional[str] = None,
    ) -> Future:
        """Accept one request; returns its Future. Sheds synchronously
        (RequestShed) at the SLO-pinned admission bound, refuses after
        stop(). ``key`` opts into affinity routing (same key → same
        healthy worker); without it requests spread over the ring."""
        with self._lock:
            if self._closed:
                raise ServerClosed()
            outstanding = len(self._pending) + sum(
                len(w.inflight) for w in self._workers.values()
            )
        try:
            self.admission.admit(outstanding)
        except RequestShed:
            self._m_sheds.inc(model=model or "default")
            raise
        if hasattr(payload, "tolist"):
            payload = payload.tolist()
        if self.tap is not None:
            try:
                self.tap.observe(payload)
            except Exception:
                pass  # the tap is advisory; submit never fails on it
        pending = _Pending(
            request_id=next(self._request_ids),
            payload=payload,
            model=model,
            key=key,
            deadline=Deadline(deadline_s) if deadline_s is not None else None,
            # Submit-time trace capture (None with tracing off — a single
            # global read): the HTTP ingress span, or whatever span the
            # submitting thread holds, becomes the request's wire parent.
            trace=_spans.current_context(),
        )
        self._route_or_park(pending)
        return pending.future

    def submit_many(
        self,
        payloads: Sequence[Any],
        deadline_s: Optional[float] = None,
        model: Optional[str] = None,
    ) -> List[Future]:
        futures: List[Future] = []
        for payload in payloads:
            try:
                futures.append(
                    self.submit(payload, deadline_s=deadline_s, model=model)
                )
            except (RequestShed, ServerClosed) as exc:
                f: Future = Future()
                _settle_exception(f, exc)
                futures.append(f)
        return futures

    def _route_or_park(self, pending: _Pending, exclude: Optional[str] = None) -> bool:
        """Dispatch ``pending`` to a healthy worker, or park it on the
        pending queue. Returns True when the request left the queue
        (dispatched or settled), False when it was (re)parked — the
        drain loop stops on False, else a fleet of broken pipes would
        spin it forever."""
        if pending.deadline is not None and pending.deadline.expired():
            # A requeue can outlive the request's budget: fail it as the
            # deadline expiry it is, never dispatch with a zero budget.
            _settle_exception(
                pending.future,
                RequestTimeout(
                    f"expired before dispatch (request {pending.request_id}, "
                    f"requeues {pending.requeues})"
                ),
            )
            return True
        route_key = (
            f"{pending.model or self.config.model_name}:"
            f"{pending.key if pending.key is not None else pending.request_id}"
        )
        # Iterative, with a GROWING exclusion set: every worker whose pipe
        # breaks mid-write joins `excluded`, so a fleet dying all at once
        # walks each worker once and parks — it must never ping-pong
        # between two broken pipes (that recursion would blow the stack
        # inside the monitor thread and drop the request).
        excluded = {exclude} if exclude is not None else set()
        while True:
            with self._lock:
                target = None
                for worker_id in self._ring.walk(route_key):
                    worker = self._workers[worker_id]
                    if worker_id not in excluded and worker.state == "ready":
                        target = worker
                        break
                if target is None:
                    fleet_failed = all(
                        w.state == "failed" for w in self._workers.values()
                    )
                    if not self._drained and not fleet_failed:
                        self._pending.append(pending)
                        return False
                    # Parking would strand this future forever: past
                    # stop()'s final drain nothing drains the queue again,
                    # and a fleet whose every worker exhausted its restart
                    # budget never produces a ready worker.
                    terminal = (
                        ServingError(
                            "UNAVAILABLE: every worker exhausted its "
                            "restart budget"
                        )
                        if fleet_failed
                        else ServerClosed()
                    )
                    break
                target.inflight[pending.request_id] = pending
            if self._write_request(target, pending):
                return True
            # Broken pipe: the monitor will declare the crash; this
            # request must not wait for it.
            excluded.add(target.id)
            pending.requeues += 1
            with self._lock:
                self.requeued += 1
            self._m_requeued.inc()
        _settle_exception(pending.future, terminal)
        return True

    def _write_request(self, worker: _Worker, pending: _Pending) -> bool:
        """Write one request line to ``worker``; True when the caller is
        done with this request (written, settled concurrently, or handed
        off), False when the pipe is broken and the caller should try
        another worker. Ownership rule: on a failed write the caller may
        requeue ONLY if the inflight entry was still ours to pop —
        _declare_dead can strand-and-requeue it first (the worker died
        between the insert and the write), and two owners would dispatch
        one request twice."""
        msg: Dict[str, Any] = {
            "kind": "request",
            "id": pending.request_id,
            "x": pending.payload,
        }
        if pending.model is not None:
            msg["model"] = pending.model
        if pending.deadline is not None:
            # Remaining-at-boundary, recomputed on every (re)dispatch so a
            # requeued request carries only what is left of its budget.
            msg["deadline_ms"] = max(pending.deadline.remaining(), 0.0) * 1e3
        # Per-dispatch span, parented under the submit-time context (a
        # requeue shows up as a SECOND dispatch span on the same trace);
        # the worker re-parents its spans under THIS hop via the wire
        # field. The explicit parent covers the monitor/drain threads,
        # whose span stacks are empty; on the submitting thread the open
        # ingress span (== pending.trace) parents directly.
        with _spans.span(
            "supervisor:dispatch",
            parent=pending.trace,
            worker=worker.id,
            request_id=pending.request_id,
            requeues=pending.requeues,
        ) as dispatch:
            wire = _spans.to_wire(dispatch.context() or pending.trace)
            if wire is not None:
                msg[_spans.WIRE_FIELD] = wire
            try:
                with worker.write_lock:
                    worker.proc.stdin.write(json.dumps(msg) + "\n")
                    worker.proc.stdin.flush()
                return True
            except Exception:
                dispatch.set_attribute("broken_pipe", True)
                with self._lock:
                    owned = (
                        worker.inflight.pop(pending.request_id, None) is not None
                    )
                return not owned or pending.future.done()

    def _expire_pending(self) -> None:
        with self._lock:
            kept: "deque[_Pending]" = deque()
            expired: List[_Pending] = []
            while self._pending:
                pending = self._pending.popleft()
                if pending.deadline is not None and pending.deadline.expired():
                    expired.append(pending)
                else:
                    kept.append(pending)
            self._pending = kept
        for pending in expired:
            _settle_exception(
                pending.future,
                RequestTimeout(
                    f"expired awaiting a worker (request {pending.request_id})"
                ),
            )

    def _drain_pending(self) -> None:
        while True:
            with self._lock:
                if not self._pending or not any(
                    w.state == "ready" for w in self._workers.values()
                ):
                    return
                pending = self._pending.popleft()
            if not self._route_or_park(pending):
                # Re-parked: every "ready" worker refused the write.
                # Yield to the monitor so it can poll/recycle them —
                # looping here would spin this request forever and
                # starve crash detection itself.
                return

    # ------------------------------------------------------------------- swap
    def swap(
        self,
        spec: Dict[str, Any],
        name: Optional[str] = None,
        timeout_s: float = 120.0,
    ) -> Dict[str, Dict[str, Any]]:
        """Hot-swap: broadcast a new model spec to every ready worker and
        wait for each ack. In-flight requests finish on the version they
        resolved (registry contract); each worker re-warms before the ack,
        so post-settle steady state does zero compiles."""
        msg = {"kind": "swap", "name": name or self.config.model_name, "spec": spec}
        targets = [w for w in list(self._workers.values()) if w.state == "ready"]
        acks: Dict[str, Dict[str, Any]] = {}
        for worker in targets:
            with self._lock:
                worker.control_replies.clear()
            try:
                with worker.write_lock:
                    worker.proc.stdin.write(json.dumps(msg) + "\n")
                    worker.proc.stdin.flush()
            except Exception as exc:
                # A worker dying mid-broadcast (broken/closed pipe) fails
                # ITS ack — the monitor owns the crash verdict, and the
                # remaining workers must still receive the swap.
                acks[worker.id] = {
                    "kind": "swap_failed",
                    "error": f"{type(exc).__name__}: {exc}",
                }
        deadline = Deadline(timeout_s)
        for worker in targets:
            while worker.id not in acks:
                with self._lock:
                    while worker.control_replies:
                        reply = worker.control_replies.popleft()
                        if reply.get("kind") in ("swapped", "swap_failed"):
                            acks[worker.id] = reply
                if worker.id in acks:
                    break
                if deadline.expired() or worker.state != "ready":
                    acks[worker.id] = {"kind": "swap_failed", "error": "no ack"}
                    break
                time.sleep(0.02)
        return acks

    def fragments_missing(self) -> List[str]:
        """Workers alive when :meth:`stop` began whose exit stats line,
        and with it their last span fragments, never arrived: a merged
        fleet trace names them instead of silently lacking them."""
        return list(self._fragments_missing)

    def fleet_counter_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-worker LIFETIME counter totals (dead-incarnation base +
        current high-water): monotonic across restarts by construction —
        the series the fleet /metrics exposition publishes."""
        with self._lock:
            totals = {
                w.id: {
                    counter: w.counter_base.get(counter, 0.0)
                    + w.counter_hw.get(counter, 0.0)
                    for counter in MONOTONIC_WORKER_COUNTERS
                }
                for w in self._workers.values()
            }
            # Retired (scaled-down) workers keep their series: a counter
            # that vanished mid-scrape would read as a reset.
            for worker_id, folded in self._retired.items():
                row = totals.setdefault(
                    worker_id,
                    {c: 0.0 for c in MONOTONIC_WORKER_COUNTERS},
                )
                for counter, value in folded.items():
                    row[counter] = row.get(counter, 0.0) + value
            return totals

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        """Aggregate across workers (counters summed, p99 worst-case) plus
        the per-worker breakdown and the supervisor's own accounting.
        Counter aggregates are LIFETIME values (monotonic through worker
        restarts — a restarted worker's in-process counters restart from
        zero, the fleet's never do); each worker row carries the raw
        current-incarnation ``stats`` plus the ``lifetime`` view."""
        with self._lock:
            workers = {
                w.id: {
                    "state": w.state,
                    "pid": w.pid,
                    "incarnation": w.incarnation,
                    "restarts": w.restarts,
                    "inflight": len(w.inflight),
                    "ready": dict(w.ready_info),
                    "stats": dict(w.stats),
                    "lifetime": {
                        counter: w.counter_base.get(counter, 0.0)
                        + w.counter_hw.get(counter, 0.0)
                        for counter in MONOTONIC_WORKER_COUNTERS
                        if counter in w.counter_base or counter in w.counter_hw
                    },
                }
                for w in self._workers.values()
            }
            pending = len(self._pending)
            retired = {
                worker_id: dict(folded)
                for worker_id, folded in self._retired.items()
            }
            retired_restarts = self._retired_restarts
        aggregate: Dict[str, Any] = {}
        for counter in MONOTONIC_WORKER_COUNTERS:
            values = [
                w["lifetime"].get(counter) for w in workers.values()
                if isinstance(w["lifetime"].get(counter), (int, float))
            ] + [
                folded[counter]
                for folded in retired.values()
                if counter in folded
            ]
            if values:
                aggregate[counter] = int(sum(values))
        # Since-warmup plan counts are per-incarnation gauges, not
        # lifetime counters: a restarted worker legitimately re-zeroes
        # (the steady-state invariant reads the CURRENT fleet). A worker
        # on the card reports the growth of cuFFT's plan cache where the
        # JAX worker reports XLA compiles.
        plan_values = [
            w["stats"].get("cufft_plans_since_warmup") for w in workers.values()
            if isinstance(
                w["stats"].get("cufft_plans_since_warmup"), (int, float)
            )
        ]
        if plan_values:
            aggregate["cufft_plans_since_warmup"] = int(sum(plan_values))
        for worst in ("p50_ms", "p95_ms", "p99_ms"):
            values = [
                w["stats"].get(worst) for w in workers.values()
                if isinstance(w["stats"].get(worst), (int, float))
            ]
            if values:
                aggregate[worst] = max(values)
        # Publish provenance (satellite contract): the active model
        # versions the fleet is serving, from the first ready worker that
        # reports them — after a settled swap every worker agrees, and a
        # mid-swap snapshot showing the old version is honest.
        models = next(
            (
                w["stats"]["models"]
                for w in workers.values()
                if w["state"] == "ready"
                and isinstance(w["stats"].get("models"), dict)
            ),
            None,
        )
        out = {
            **aggregate,
            **({"models": models} if models is not None else {}),
            "workers": workers,
            "supervisor": {
                "alive": sum(1 for w in workers.values() if w["state"] == "ready"),
                "configured": self.config.workers,
                "workers": len(workers),
                "booting": sum(
                    1 for w in workers.values()
                    if w["state"] in ("new", "spawning")
                ),
                "draining": sum(
                    1 for w in workers.values() if w["state"] == "draining"
                ),
                "retired": len(retired),
                "restarts": retired_restarts
                + sum(w["restarts"] for w in workers.values()),
                "requeued": self.requeued,
                "pending": pending,
                "admission": self.admission.stats(),
            },
        }
        if self.slo is not None:
            out["supervisor"]["slo"] = self.slo.stats()
        quality = self.quality.report()
        if quality["models"]:
            out["quality"] = quality
        return out
