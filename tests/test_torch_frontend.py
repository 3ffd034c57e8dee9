"""The port's HTTP front-end and the ``serve`` fleet CLI on the CPU.

The HTTP layer's contract (JSON in and out, a status code per failure
class, health states, the Prometheus scrape, the ingress span) runs
against a fake dispatcher, as ``tests/serving/test_frontend.py`` does;
the whole stack runs as ``python -m keystone_tpu_torch serve --workers 2
--listen 127.0.0.1:0 --device cpu`` with worker 0 SIGKILLed mid-load,
and must drop nothing (``tests/test_torch_package.py`` holds ``serve
--help`` to importing no torch). Every subprocess and HTTP wait carries
its own timeout.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

from keystone_tpu_torch.obs.flight import reset_flight_recorder
from keystone_tpu_torch.serving.config import RequestShed, ServerClosed, ServingError
from keystone_tpu_torch.serving.frontend import ServingFrontend, parse_listen
from torch_lock_witness import _port_lock_witness  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_flight_recorder()
    yield
    reset_flight_recorder()


class FakeSupervisor:
    """The submit/stats/config shape the frontend consumes."""

    class config:
        drain_timeout_s = 5.0

    def __init__(self):
        self.lock = threading.Lock()
        self.submissions = []
        self.mode = "ok"
        self.worker_states = {"0": "ready", "1": "ready"}

    def submit(self, payload, deadline_s=None, model=None, key=None):
        with self.lock:
            self.submissions.append({"x": payload, "deadline_s": deadline_s, "model": model, "key": key})
        future = Future()
        if self.mode == "shed":
            raise RequestShed("queue full (test)")
        if self.mode == "closed":
            raise ServerClosed()
        if self.mode == "hang":
            return future
        if self.mode == "error":
            future.set_exception(RuntimeError("apply exploded"))
        elif self.mode == "unavailable":
            future.set_exception(ServingError("UNAVAILABLE: every worker exhausted its restart budget"))
        else:
            future.set_result([2.0 * v for v in payload])
        return future

    def stats(self):
        alive = sum(1 for s in self.worker_states.values() if s == "ready")
        return {
            "served": len(self.submissions),
            "workers": {k: {"state": v} for k, v in self.worker_states.items()},
            "supervisor": {"alive": alive},
        }


@pytest.fixture()
def frontend():
    supervisor = FakeSupervisor()
    front = ServingFrontend(supervisor, "127.0.0.1", 0).start()
    yield front, supervisor
    front.stop()


def _request(front, path, obj=None, timeout=10):
    url = f"http://{front.host}:{front.port}{path}"
    request = urllib.request.Request(
        url, data=json.dumps(obj).encode() if obj is not None else None,
        headers={"Content-Type": "application/json"}, method="POST" if obj is not None else "GET",
    )
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.status, response.headers.get("Content-Type", ""), response.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type", ""), exc.read().decode()


def _post(front, path, obj):
    code, _, body = _request(front, path, obj)
    return code, json.loads(body)


def _get(front, path):
    code, _, body = _request(front, path)
    return code, json.loads(body)


def test_apply_round_trip_forwards_everything(frontend):
    front, supervisor = frontend
    code, out = _post(front, "/v1/apply", {"x": [1.0, 2.0], "model": "m2", "deadline_ms": 1500, "key": "tenant"})
    assert code == 200 and out["y"] == [2.0, 4.0] and out["latency_ms"] >= 0
    assert supervisor.submissions[0] == {"x": [1.0, 2.0], "deadline_s": 1.5, "model": "m2", "key": "tenant"}


@pytest.mark.parametrize(
    "mode,body,code",
    [
        ("ok", {"x": "nope"}, 400),
        ("ok", {}, 400),
        ("ok", {"x": [1.0], "deadline_ms": "abc"}, 400),
        ("shed", {"x": [1.0]}, 429),
        ("closed", {"x": [1.0]}, 503),
        ("unavailable", {"x": [1.0]}, 503),
        ("error", {"x": [1.0]}, 500),
        ("hang", {"x": [1.0], "deadline_ms": 100}, 504),
        ("hang", {"x": [1.0], "deadline_ms": 0}, 504),
    ],
)
def test_status_codes_per_failure_class(frontend, mode, body, code):
    front, supervisor = frontend
    supervisor.mode = mode
    got, out = _post(front, "/v1/apply", body)
    assert got == code and "error" in out


def test_wedged_fleet_without_deadline_is_503_and_unknown_routes_404():
    supervisor = FakeSupervisor()
    supervisor.mode = "hang"
    supervisor.config = type("C", (), {"drain_timeout_s": 0.2})
    front = ServingFrontend(supervisor, "127.0.0.1", 0).start()
    try:
        code, out = _post(front, "/v1/apply", {"x": [1.0]})
        assert code == 503 and "UNAVAILABLE" in out["error"]
        assert _get(front, "/nowhere")[0] == 404
        assert _post(front, "/v2/apply", {"x": [1.0]})[0] == 404
    finally:
        front.stop()


def test_default_deadline_applies_when_request_carries_none():
    supervisor = FakeSupervisor()
    front = ServingFrontend(supervisor, "127.0.0.1", 0, default_deadline_s=0.25).start()
    try:
        assert _post(front, "/v1/apply", {"x": [1.0]})[0] == 200
        assert _post(front, "/v1/apply", {"x": [1.0], "deadline_ms": 1500})[0] == 200
    finally:
        front.stop()
    assert [s["deadline_s"] for s in supervisor.submissions] == [0.25, 1.5]


@pytest.mark.parametrize(
    "states,code,status,counts",
    [
        ({"0": "ready", "1": "ready"}, 200, "ok", (2, 0, 0)),
        ({"0": "ready", "1": "dead"}, 200, "degraded", (1, 0, 0)),
        ({"0": "ready", "1": "spawning"}, 200, "scaling", (1, 1, 0)),
        ({"0": "ready", "1": "draining"}, 200, "scaling", (1, 0, 1)),
        ({"0": "ready", "1": "spawning", "2": "dead"}, 200, "degraded", (1, 1, 0)),
        ({"0": "new", "1": "spawning"}, 503, "down", (0, 2, 0)),
        ({"0": "dead", "1": "failed"}, 503, "down", (0, 0, 0)),
    ],
)
def test_healthz_tracks_worker_states(frontend, states, code, status, counts):
    front, supervisor = frontend
    supervisor.worker_states = states
    got, out = _get(front, "/healthz")
    assert (got, out["status"]) == (code, status)
    assert (out["alive"], out["booting"], out["draining"]) == counts
    assert out["workers"] == states


def test_stats_route_and_ingress_span(frontend):
    from keystone_tpu_torch.obs import spans

    front, _ = frontend
    with spans.tracing_session("http", sync_timings=False) as session:
        assert _post(front, "/v1/apply", {"x": [1.0]})[0] == 200
    code, out = _get(front, "/stats")
    assert code == 200 and out["served"] == 1 and "workers" in out
    ingress = [s for s in session.spans() if s.name == "http:apply"]
    assert len(ingress) == 1 and ingress[0].trace_id == session.trace_id
    assert ingress[0].attributes.get("http_status") == 200


def test_metrics_route_is_the_fleet_exposition(frontend):
    front, supervisor = frontend
    supervisor.fleet_counter_totals = lambda: {"0": {"served": 1e9, "failures": 3.0}}
    code, content_type, text = _request(front, "/metrics")
    assert code == 200 and content_type.startswith("text/plain")
    for family in ("keystone_serving_workers_alive", "keystone_fleet_requests_total", "keystone_flight_dumps_total"):
        assert f"# TYPE {family}" in text, family
    line = next(l for l in text.splitlines() if l.startswith('keystone_fleet_requests_total{worker="0"}'))
    assert float(line.rsplit(" ", 1)[1]) >= 1e9


def test_worker_zero_remaining_deadline_is_forwarded_not_unbounded():
    from keystone_tpu_torch.serving import worker as worker_mod

    forwarded = []

    class FakeServer:
        def submit(self, payload, deadline_s=None, model=None):
            forwarded.append(deadline_s)
            future = Future()
            future.set_result(np.zeros(1))
            return future

    backend = worker_mod.ServerBackend.__new__(worker_mod.ServerBackend)
    backend.server = FakeServer()
    backend.name = "default"
    backend._warmed = True
    emitted = []

    class Emitter:
        emit = staticmethod(emitted.append)

    backend.handle({"id": 1, "x": [1.0], "deadline_ms": 0.0}, Emitter)
    backend.handle({"id": 2, "x": [1.0]}, Emitter)
    assert forwarded == [0.0, None] and [e["y"] for e in emitted] == [[0.0], [0.0]]


def test_parse_listen():
    assert parse_listen("0.0.0.0:8080") == ("0.0.0.0", 8080)
    assert parse_listen(":9000") == ("127.0.0.1", 9000)
    assert parse_listen("9000") == ("127.0.0.1", 9000)
    with pytest.raises(ValueError):
        parse_listen("localhost")


# --------------------------------------------------------- the fleet CLI


def test_serve_cli_fleet_survives_a_kill_with_nothing_dropped(tmp_path):
    """``serve --synthetic 8 --workers 2 --listen 127.0.0.1:0 --device
    cpu``: whichever worker takes traffic first is SIGKILLed at its 3rd
    request; every request line is answered with the synthetic
    pipeline's own rows (≤ 1e-6), the crash and the restart are in the
    ledger, nothing is dropped, and with fleet tracing on the merged trace
    holds the front-end's and the workers' spans."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.serving.synthetic import synthetic_fitted_pipeline

    kill = json.dumps([{"match": "serving.worker.request", "kind": "kill", "calls": [3]}])
    trace_out = str(tmp_path / "fleet_trace.json")
    env = {**os.environ, "KEYSTONE_FAULT_SPECS_WORKER_0": kill, "KEYSTONE_FAULT_SPECS_WORKER_1": kill,
           "KEYSTONE_FLEET_TRACE": "1", "KEYSTONE_FLEET_TRACE_OUT": trace_out}
    rows = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    lines = "".join(json.dumps({"id": i, "x": row.tolist()}) + "\n" for i, row in enumerate(rows))
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "serve", "--synthetic", "8", "--workers", "2",
         "--listen", "127.0.0.1:0", "--device", "cpu", "--max-batch", "8"],
        cwd=ROOT, input=lines, capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVE_LISTEN:127.0.0.1:" in proc.stderr
    out = proc.stdout.strip().splitlines()
    stats = json.loads(out[-1][len("SERVE_STATS:"):])
    answers = {r["id"]: r for r in map(json.loads, out[:-1])}
    assert sorted(answers) == list(range(len(rows)))
    assert all("error" not in r for r in answers.values())
    want = synthetic_fitted_pipeline(d=8, device="cpu").apply_batch(ArrayDataset(rows, device="cpu")).data.numpy()
    got = np.asarray([answers[i]["y"] for i in range(len(rows))])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    kinds = {e["kind"] for e in stats["recovery"]["events"]}
    assert {"worker_crash", "worker_restart"} <= kinds
    assert stats["supervisor"]["requeued"] >= 1 and stats["supervisor"]["restarts"] >= 1
    for row in stats["workers"].values():
        assert row["stats"]["device_counts"]["ell_launches"] == 0
    # Fleet tracing: the merged trace holds the front-end's and the
    # workers' processes.
    assert f"FLEET_TRACE:{trace_out}" in proc.stderr
    with open(trace_out) as f:
        processes = json.load(f)["otherData"]["processes"]
    assert "frontend" in processes.values() and any(r.startswith("worker") for r in processes.values())
