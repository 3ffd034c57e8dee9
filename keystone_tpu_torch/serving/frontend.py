"""Network front-end for the multi-worker serving runtime. Port of
``keystone_tpu/serving/frontend.py``.

Stdlib-only (``http.server`` on a thread pool): the serving tier's front
door must come up — and its ``--help`` must print — without paying a
torch import. One process runs

    front-end (this module) ──► WorkerSupervisor ──► N worker processes

and every client is *just a client*: the HTTP API below, the
``python -m keystone_tpu_torch serve`` stdin/JSON CLI (which feeds the same supervisor
when ``--workers > 1``), and tests all route through
``WorkerSupervisor.submit`` — consistent-hash placement, SLO-driven
admission, and crash recovery apply identically no matter which door a
request came through.

HTTP API (JSON in, JSON out):

    POST /v1/apply   {"x": [...], "model"?: ..., "deadline_ms"?: ...,
                      "key"?: ...}
                     → 200 {"y": [...], "latency_ms": ...}
                     → 429 shed (admission), 503 closed/unavailable,
                       504 deadline expired, 400 malformed
    GET  /healthz    → 200 while ≥1 worker is ready, else 503; body
                       carries per-worker states
    GET  /stats      → the supervisor's aggregated stats snapshot
    GET  /metrics    → Prometheus text exposition aggregated across the
                       fleet (restart-safe: counters stay monotonic
                       through worker incarnations)

Tracing: each ``POST /v1/apply`` opens an ``http:apply`` ingress span
when a trace session is active; the supervisor forwards its context on
the control pipe so worker spans re-parent under it.

``deadline_ms`` enters here and is *remaining budget* from this moment:
the front-end stamps a Deadline, the supervisor forwards what is left at
dispatch (and re-forwards what is left on a requeue), and the worker's
retry loop never runs past it.
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..obs import spans as _spans
from .config import (
    RequestShed,
    RequestTimeout,
    ServerClosed,
    ServingError,
    parse_stdin_request,
)
from .supervisor import WorkerSupervisor


def parse_listen(value: str) -> Tuple[str, int]:
    """``HOST:PORT`` (or bare ``:PORT`` / ``PORT``) → (host, port)."""
    host, _, port = value.rpartition(":")
    if not port.isdigit():
        raise ValueError(f"--listen wants HOST:PORT, got {value!r}")
    return host or "127.0.0.1", int(port)


class ServingFrontend:
    """HTTP front door over a :class:`WorkerSupervisor` (or anything with
    its ``submit``/``stats`` shape)."""

    def __init__(
        self,
        supervisor: WorkerSupervisor,
        host: str = "127.0.0.1",
        port: int = 0,
        default_deadline_s: Optional[float] = None,
    ):
        self.supervisor = supervisor
        self.default_deadline_s = default_deadline_s
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # One slow client must not serialize the fleet.
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet: telemetry, not stderr
                pass

            def _reply(self, code: int, obj: Dict[str, Any]) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_text(self, code: int, text: str) -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path == "/metrics":
                    code, text = frontend._metrics()
                    self._reply_text(code, text)
                    return
                if self.path == "/healthz":
                    code, obj = frontend._health()
                elif self.path == "/stats":
                    code, obj = 200, frontend.supervisor.stats()
                else:
                    code, obj = 404, {"error": f"no route {self.path}"}
                self._reply(code, obj)

            def do_POST(self) -> None:
                if self.path != "/v1/apply":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    obj = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as exc:
                    self._reply(400, {"error": f"bad request body: {exc}"})
                    return
                code, out = frontend._apply(obj)
                self._reply(code, out)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- routes
    def _health(self) -> Tuple[int, Dict[str, Any]]:
        """Fleet health with scale events represented DISTINCTLY from
        failures: a worker that is ``booting`` (new/spawning) or
        ``draining`` (retiring gracefully, off the ring) is normal
        elastic-fleet motion — ``status: "scaling"``, still 200 — while a
        dead/failed worker degrades the fleet. Only zero ready workers
        answers 503."""
        stats = self.supervisor.stats()
        workers = {
            wid: w["state"] for wid, w in stats.get("workers", {}).items()
        }
        alive = stats["supervisor"]["alive"]
        booting = sum(1 for s in workers.values() if s in ("new", "spawning"))
        draining = sum(1 for s in workers.values() if s == "draining")
        unhealthy = len(workers) - alive - booting - draining
        if not alive:
            status = "down"
        elif unhealthy:
            status = "degraded"
        elif booting or draining:
            status = "scaling"
        else:
            status = "ok"
        return (200 if alive else 503), {
            "status": status,
            "alive": alive,
            "booting": booting,
            "draining": draining,
            "workers": workers,
        }

    def _metrics(self) -> Tuple[int, str]:
        """Fleet-aggregated Prometheus exposition (obs/fleet.py): the
        local registry — the supervisor's own serving/SLO series live in
        this process — plus restart-safe ``keystone_fleet_*`` counters
        from the supervisor's per-worker high-water totals."""
        from ..obs.fleet import fleet_prometheus_text

        try:
            return 200, fleet_prometheus_text(self.supervisor)
        except Exception as exc:
            return 500, f"# metrics export failed: {type(exc).__name__}: {exc}\n"

    def _apply(self, obj: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """HTTP ingress: the ``http:apply`` span opened here is the trace
        root the whole cross-process request tree hangs under."""
        with _spans.span("http:apply") as ingress:
            code, out = self._apply_inner(obj)
            ingress.set_attribute("http_status", code)
            return code, out

    def _apply_inner(self, obj: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        x = obj.get("x")
        if not isinstance(x, list) or not x:
            return 400, {"error": f"x must be a non-empty array, got {x!r}"}
        try:
            # Shared door contract (parse_stdin_request): deadline_ms=0 is
            # an exhausted budget that answers 504, never the default.
            _, _, deadline_s, key, model = parse_stdin_request(
                obj, default_deadline_s=self.default_deadline_s
            )
        except ValueError as exc:
            return 400, {"error": str(exc)}
        t0 = time.monotonic()
        try:
            future = self.supervisor.submit(
                x,
                deadline_s=deadline_s,
                model=model,
                key=key,
            )
            # The HTTP thread IS the request's wait budget; without a
            # deadline, bound by the supervisor's drain ceiling so a
            # wedged fleet answers 503 instead of holding sockets forever.
            y = future.result(
                timeout=deadline_s
                if deadline_s is not None
                else self.supervisor.config.drain_timeout_s
            )
            return 200, {
                "y": y,
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            }
        except RequestShed as exc:
            return 429, {"error": str(exc)}
        except RequestTimeout as exc:
            return 504, {"error": str(exc)}
        # concurrent.futures.TimeoutError is NOT the builtin TimeoutError
        # until py3.11 — catch both spellings. A request that carried NO
        # deadline and hit the drain-ceiling wait bound above was failed
        # by a wedged fleet, not by its own budget: that is 503, not 504.
        except (TimeoutError, concurrent.futures.TimeoutError) as exc:
            if deadline_s is None:
                return 503, {
                    "error": "UNAVAILABLE: no worker answered within the "
                             "drain bound"
                }
            return 504, {"error": str(exc) or "deadline expired"}
        except ServerClosed as exc:
            return 503, {"error": str(exc)}
        except ServingError as exc:
            # UNAVAILABLE (e.g. every worker exhausted its restart
            # budget) is retryable-against-another-replica: 503, not a
            # server bug. Other serving failures are genuine 500s.
            return (503 if "UNAVAILABLE" in str(exc) else 500), {
                "error": str(exc)
            }
        except Exception as exc:
            return 500, {"error": f"{type(exc).__name__}: {exc}"}

    # ---------------------------------------------------------------- control
    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="keystone-serving-frontend",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------------------- CLI plumbing


def build_spec_from_args(args) -> Dict[str, Any]:
    """The model spec the ``serve`` CLI flags describe — shared by the
    in-process path (via the registry doors) and the worker processes."""
    if getattr(args, "synthetic", None) is not None:
        return {"synthetic": {"d": int(args.synthetic)}}
    if getattr(args, "model", None):
        return {"model": args.model}
    if getattr(args, "checkpoint_dir", None) and getattr(args, "digest", None):
        return {"checkpoint_dir": args.checkpoint_dir, "digest": args.digest}
    raise ValueError("need --model, --checkpoint-dir + --digest, or --synthetic D")


def serve_multiworker_from_args(args) -> int:
    """The ``serve --workers N`` path: stdin/JSON requests
    fan out across N worker processes (plus an optional HTTP listener),
    and the final ``SERVE_STATS:`` line aggregates across workers with
    the per-worker breakdown under ``workers``."""
    import sys

    from ..envknobs import env_flag, env_raw
    from ..obs.fleet import FLEET_TRACE_ENV
    from ..obs.flight import install_flight_recorder
    from .supervisor import SupervisorConfig

    try:
        spec = build_spec_from_args(args)
    except ValueError as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 2
    install_flight_recorder("frontend")
    # KEYSTONE_FLEET_TRACE=1: trace this front-end/supervisor process
    # too (workers read the same flag from their inherited environment);
    # KEYSTONE_FLEET_TRACE_OUT names a merged-trace artifact written at
    # shutdown.
    trace_session = (
        _spans.install_session("serve-frontend", sync_timings=False)
        if env_flag(FLEET_TRACE_ENV)
        else None
    )
    trace_out = env_raw("KEYSTONE_FLEET_TRACE_OUT")
    config = SupervisorConfig(
        workers=args.workers,
        model_name=args.model_name,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        worker_queue_depth=args.queue_depth,
        slo_target_p99_ms=args.slo_p99_ms,
        boot_image=getattr(args, "boot_image", None),
        device=getattr(args, "device", None),
    )
    # --deadline-ms means the same thing it means in-process: the default
    # per-request budget for requests that don't carry their own.
    default_deadline_s = (
        args.deadline_ms / 1e3 if getattr(args, "deadline_ms", None) else None
    )
    supervisor = WorkerSupervisor(spec, config).start()
    # --autoscale closes the loop between SLO pressure and fleet size:
    # the supervisor starts at
    # --workers and the autoscaler moves it within [--min-workers,
    # --max-workers].
    autoscaler = None
    if getattr(args, "autoscale", False):
        from .autoscaler import Autoscaler, AutoscalerConfig

        autoscaler = Autoscaler(
            supervisor,
            AutoscalerConfig(
                target_p99_ms=args.slo_p99_ms
                if args.slo_p99_ms is not None
                else AutoscalerConfig.target_p99_ms,
                min_workers=getattr(args, "min_workers", None) or 1,
                max_workers=getattr(args, "max_workers", None)
                or max(4, args.workers),
            ),
        ).start()
    frontend = None
    out_lock = threading.Lock()

    def emit(obj: Dict[str, Any]) -> None:
        with out_lock:
            print(json.dumps(obj), flush=True)

    try:
        supervisor.wait_ready(n=1)
        if args.listen:
            host, port = parse_listen(args.listen)
            frontend = ServingFrontend(
                supervisor, host, port, default_deadline_s=default_deadline_s
            ).start()
            print(
                f"SERVE_LISTEN:{frontend.host}:{frontend.port}",
                file=sys.stderr, flush=True,
            )

        def on_done(request_id, t0):
            def callback(future) -> None:
                try:
                    y = future.result()
                    emit({
                        "id": request_id,
                        "y": y,
                        "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                    })
                except Exception as exc:
                    emit({"id": request_id,
                          "error": f"{type(exc).__name__}: {exc}"})

            return callback

        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as exc:
                emit({"error": f"bad request line: {exc}"})
                continue
            try:
                request_id, x, deadline_s, key, model = parse_stdin_request(
                    obj, default_deadline_s=default_deadline_s
                )
            except ValueError as exc:
                emit({"id": obj.get("id") if isinstance(obj, dict) else None,
                      "error": str(exc)})
                continue
            t0 = time.monotonic()
            try:
                future = supervisor.submit(
                    x, deadline_s=deadline_s, key=key, model=model
                )
            except (RequestShed, ServerClosed) as exc:
                emit({"id": request_id, "error": f"{type(exc).__name__}: {exc}"})
                continue
            future.add_done_callback(on_done(request_id, t0))
    finally:
        if frontend is not None:
            frontend.stop()
        if autoscaler is not None:
            autoscaler.stop()
        # Drain settles every outstanding future; each worker's exit
        # stats line lands through the reader before its pipe closes, so
        # the aggregate below carries final counters, and the merged
        # trace below each worker's last span fragments.
        supervisor.stop(drain=True)
        if trace_out:
            # Merge AFTER stop: a worker ships the fragments no beat has
            # carried on its exit line, so the merge waits on no beat.
            # A worker whose exit line never came is named in the
            # trace's ``fragments_missing``.
            from ..obs.fleet import write_fleet_trace

            try:
                write_fleet_trace(
                    supervisor.fleet, trace_out,
                    local_session=trace_session, local_role="frontend",
                    fragments_missing=supervisor.fragments_missing(),
                )
            except OSError:
                pass  # an artifact write failure must not fail the serve run
            else:
                print(f"FLEET_TRACE:{trace_out}", file=sys.stderr, flush=True)
        from ..reliability.recovery import get_recovery_log

        payload = supervisor.stats()
        # How the run survived: worker_crash/worker_restart/slo events
        # ride the stats line so smoke scripts can assert recovery
        # happened without scraping logs.
        payload["recovery"] = get_recovery_log().summary()
        if autoscaler is not None:
            payload["autoscaler"] = autoscaler.stats()
        with out_lock:
            print("SERVE_STATS:" + json.dumps(payload), flush=True)
    return 0
