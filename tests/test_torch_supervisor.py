"""The port's WorkerSupervisor on stub workers: crash and hang recovery,
requeue, routing, deadlines, admission, restart-monotonic counters and
trace context over the pipe.

Mirrors ``tests/serving/test_supervisor.py`` against
``keystone_tpu_torch.serving``. The workers run the ``{"stub": ...}``
spec, the echo backend that imports no torch: these contracts belong to
the control pipe, not to what computes ``y`` (card workers are driven by
``chip_smoke.py``'s fleet phases, CPU server workers by
``tests/test_torch_frontend.py`` and ``tests/test_torch_fleet.py``).
Every wait carries its own timeout; the stub answers are exact
(``y = 2·x``).
"""

import json
import sys
import time

import pytest

from keystone_tpu_torch.obs.flight import reset_flight_recorder
from keystone_tpu_torch.reliability.recovery import get_recovery_log, reset_recovery_log
from keystone_tpu_torch.reliability.retry import RetryPolicy
from keystone_tpu_torch.serving.config import RequestShed, RequestTimeout, ServerClosed, ServingError
from keystone_tpu_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor
from torch_lock_witness import _port_lock_witness  # noqa: F401 (autouse fixture)


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    # Workers inherit the environment: their flight dumps land here too.
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_recovery_log()
    reset_flight_recorder()
    yield
    reset_flight_recorder()
    reset_recovery_log()


def make_supervisor(workers=2, delay_ms=0, chaos=None, **cfg):
    """Stub-worker supervisor tuned for test speed (fast beats, tight
    hang detection, sub-second backoff)."""
    defaults = dict(
        workers=workers,
        heartbeat_s=0.05,
        hang_timeout_s=0.8,
        ready_timeout_s=15.0,
        monitor_interval_s=0.02,
    )
    defaults.update(cfg)
    env = {f"KEYSTONE_FAULT_SPECS_WORKER_{w}": json.dumps(s) for w, s in (chaos or {}).items()}
    return WorkerSupervisor({"stub": {"delay_ms": delay_ms}}, SupervisorConfig(**defaults), env=env)


def settle(futures, timeout=30):
    return [f.result(timeout=timeout) for f in futures]


def wait_for(predicate, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"{what} never happened"
        time.sleep(0.05)


def test_round_trip_and_aggregated_stats():
    sup = make_supervisor(workers=2).start()
    try:
        sup.wait_ready()
        results = settle([sup.submit([float(i)]) for i in range(30)])
        assert [r[0] for r in results] == [2.0 * i for i in range(30)]
        wait_for(lambda: sup.stats().get("served") == 30, 10, "beats carrying served=30")
        stats = sup.stats()
        assert set(stats["workers"]) == {"0", "1"}
        assert stats["supervisor"]["alive"] == 2 and stats["supervisor"]["requeued"] == 0
        assert stats["cufft_plans_since_warmup"] == 0
        per_worker = [w["stats"].get("served", 0) for w in stats["workers"].values()]
        assert all(v > 0 for v in per_worker), per_worker
    finally:
        sup.stop()


def test_affinity_key_pins_one_worker_and_submit_after_stop_refuses():
    sup = make_supervisor(workers=2).start()
    try:
        sup.wait_ready()
        settle([sup.submit([1.0], key="tenant-A") for _ in range(12)])
        wait_for(lambda: sup.stats().get("served") == 12, 10, "beats carrying served=12")
        served = [w["stats"].get("served", 0) for w in sup.stats()["workers"].values()]
        assert sorted(served) == [0, 12], served
    finally:
        sup.stop()
    with pytest.raises(ServerClosed):
        sup.submit([1.0])


# ------------------------------------------------------------ chaos: crash


def test_sigkill_mid_load_drops_nothing_and_restarts():
    """THE supervisor invariant: a worker SIGKILLed mid-load loses zero
    requests — its in-flight work is requeued onto the healthy worker —
    and it is restarted on the backoff schedule, landing worker_crash +
    worker_restart in the recovery ledger."""
    sup = make_supervisor(
        workers=2, delay_ms=2,
        chaos={"0": [{"match": "serving.worker.request", "kind": "kill", "calls": [4]}]},
    ).start()
    try:
        sup.wait_ready()
        results = settle([sup.submit([float(i)], deadline_s=30) for i in range(50)])
        assert [r[0] for r in results] == [2.0 * i for i in range(50)]
        assert sup.requeued > 0
        sup.wait_ready(timeout_s=20)
        crash = get_recovery_log().events("worker_crash")
        assert crash and crash[0].detail["reason"] == "crash"
        assert get_recovery_log().events("worker_restart")
        assert settle([sup.submit([3.0])])[0] == [6.0]
    finally:
        sup.stop()


def test_single_worker_kill_parks_requests_until_restart():
    sup = make_supervisor(
        workers=1, delay_ms=2,
        chaos={"0": [{"match": "serving.worker.request", "kind": "kill", "calls": [3]}]},
    ).start()
    try:
        sup.wait_ready()
        results = settle([sup.submit([float(i)], deadline_s=30) for i in range(10)])
        assert [r[0] for r in results] == [2.0 * i for i in range(10)]
        assert sup.stats()["supervisor"]["restarts"] == 1
    finally:
        sup.stop()


def test_restart_budget_exhaustion_fails_outstanding_loudly():
    sup = WorkerSupervisor(
        {"stub": {}},
        SupervisorConfig(
            workers=1, max_restarts=2, monitor_interval_s=0.02,
            restart_policy=RetryPolicy(max_attempts=3, base_delay_s=0.02, max_delay_s=0.05),
        ),
        worker_cmd=lambda wid: [sys.executable, "-c", "import sys; sys.exit(3)"],
    ).start()
    try:
        future = sup.submit([1.0])
        with pytest.raises(ServingError, match="restart budget"):
            future.result(timeout=20)
        assert sup.stats()["workers"]["0"]["state"] == "failed"
        assert get_recovery_log().events("worker_failed")
        late = sup.submit([2.0])
        with pytest.raises(ServingError, match="restart budget"):
            late.result(timeout=5)
    finally:
        sup.stop(drain=False)


# ------------------------------------------------------------- chaos: hang


@pytest.mark.parametrize(
    "spec",
    [
        {"match": "serving.worker.heartbeat", "kind": "hang", "calls": [2], "hang_s": 60.0},
        {"match": "serving.worker.heartbeat", "kind": "corrupt", "first_n": 10000},
    ],
    ids=["stopped_heartbeats", "corrupt_heartbeats"],
)
def test_dead_heartbeat_channel_is_a_hang_and_restarts(spec):
    """Stopped beats, and garbled beats (which are not beats), both read
    as a hang: the worker is SIGKILLed and a clean incarnation serves."""
    sup = make_supervisor(workers=1, chaos={"0": [spec]}).start()
    try:
        wait_for(lambda: get_recovery_log().events("worker_crash"), 20, "hang detection")
        assert get_recovery_log().events("worker_crash")[0].detail["reason"] == "hang"
        sup.wait_ready(timeout_s=20)
        assert settle([sup.submit([2.0])])[0] == [4.0]
    finally:
        sup.stop()


# ------------------------------------------------- deadlines and admission


def test_deadline_budget_crosses_the_boundary():
    sup = make_supervisor(workers=1).start()
    try:
        sup.wait_ready()
        echoed = sup.submit(["deadline-echo"], deadline_s=5.0).result(timeout=10)
        assert 0.0 < echoed[0] <= 5000.0, echoed
        assert sup.submit(["deadline-echo"]).result(timeout=10)[0] == -1.0
    finally:
        sup.stop()


def test_expired_requeue_fails_as_timeout_not_zombie():
    sup = WorkerSupervisor(
        {"stub": {}},
        SupervisorConfig(workers=1, monitor_interval_s=0.02, ready_timeout_s=15),
        # Never ready; exits when the supervisor closes its stdin at stop().
        worker_cmd=lambda wid: [sys.executable, "-c", "import sys; sys.stdin.read()"],
    ).start()
    try:
        future = sup.submit([1.0], deadline_s=0.2)  # parked: the worker never gets ready
        with pytest.raises(RequestTimeout):
            future.result(timeout=10)
    finally:
        sup.stop(drain=False)


def test_swap_survives_a_dead_worker_mid_broadcast():
    sup = make_supervisor(workers=2).start()
    try:
        sup.wait_ready()
        sup._workers["0"].proc.stdin.close()
        acks = sup.swap({"stub": {}})
        assert set(acks) == {"0", "1"}
        assert acks["0"]["kind"] == "swap_failed" and acks["1"]["kind"] == "swapped"
    finally:
        sup.stop(drain=False)


def test_every_pipe_broken_parks_and_a_drained_fleet_settles_closed():
    sup = make_supervisor(workers=2).start()
    try:
        sup.wait_ready()
        for worker in sup._workers.values():
            worker.proc.stdin.close()
        future = sup.submit([5.0], deadline_s=30)
        assert sup.requeued >= 2
        assert future.result(timeout=20) == [10.0]
    finally:
        sup.stop()
    idle = make_supervisor(workers=1)  # never started: no ready worker
    idle._drained = True  # the state stop() leaves behind
    with pytest.raises(ServerClosed):
        idle.submit([1.0]).result(timeout=5)


def test_admission_sheds_at_capacity():
    sup = make_supervisor(workers=1, delay_ms=200, queue_depth=4).start()
    try:
        sup.wait_ready()
        futures, sheds = [], 0
        for i in range(16):
            try:
                futures.append(sup.submit([float(i)]))
            except RequestShed:
                sheds += 1
        assert sheds > 0
        settle(futures)
    finally:
        sup.stop()


def test_restart_keeps_aggregated_counters_monotonic():
    sup = make_supervisor(
        workers=1,
        chaos={"0": [{"match": "serving.worker.request", "kind": "kill", "calls": [6]}]},
    ).start()
    try:
        sup.wait_ready()
        settle([sup.submit([float(i)], deadline_s=30) for i in range(5)])
        wait_for(lambda: sup.stats().get("served") == 5, 10, "beats carrying served=5")
        settle([sup.submit([float(i)], deadline_s=30) for i in range(5, 10)])
        wait_for(lambda: sup.stats().get("served") == 10, 10, "lifetime served=10")
        after = sup.stats()
        assert after["workers"]["0"]["incarnation"] >= 1
        assert after["workers"]["0"]["stats"]["served"] < 10
        assert sup.fleet_counter_totals()["0"]["served"] == 10.0
    finally:
        sup.stop()


# --------------------------------------------------- cross-process tracing


def test_trace_context_crosses_the_pipe_and_fragments_return(tmp_path):
    from keystone_tpu_torch.obs import fleet as tfleet
    from keystone_tpu_torch.obs import spans

    with spans.tracing_session("sup-trace", sync_timings=False) as session:
        sup = WorkerSupervisor(
            {"stub": {}},
            SupervisorConfig(workers=2, heartbeat_s=0.05, hang_timeout_s=5.0,
                             ready_timeout_s=15.0, monitor_interval_s=0.02),
            env={"KEYSTONE_FLEET_TRACE": "1"},
        ).start()
        try:
            sup.wait_ready()
            with spans.span("ingress"):
                settle([sup.submit([1.0, float(i)]) for i in range(12)])

            def shipped():
                fragments = sup.fleet.fragments()
                requests = [f for frags in fragments.values() for f in frags if f["n"] == "worker:request"]
                return len(requests) >= 12 and len(fragments) >= 2

            wait_for(shipped, 10, "fragments from both workers")
            fragments = sup.fleet.fragments()
            worker_requests = [f for frags in fragments.values() for f in frags if f["n"] == "worker:request"]
            merged = sup.fleet.merge(local_session=session)
            written = tfleet.write_fleet_trace(sup.fleet, str(tmp_path / "fleet_trace.json"), local_session=session)
        finally:
            sup.stop()
    with open(written) as f:
        assert json.load(f)["otherData"]["trace_ids"] == merged["otherData"]["trace_ids"]

    dispatches = [s for s in session.spans() if s.name == "supervisor:dispatch"]
    ingress = next(s for s in session.spans() if s.name == "ingress")
    assert len(dispatches) == 12
    assert all(s.trace_id == session.trace_id and s.parent_id == ingress.span_id for s in dispatches)
    dispatch_ids = {s.span_id for s in dispatches}
    assert all(f["t"] == session.trace_id and f.get("p") in dispatch_ids for f in worker_requests)
    pids = {
        e["pid"] for e in merged["traceEvents"]
        if e.get("ph") == "X" and e["args"].get("trace_id") == session.trace_id
    }
    assert len(pids) >= 3
    assert session.trace_id in merged["otherData"]["trace_ids"]
    assert merged["otherData"]["clock_skew_s"]


def test_tracing_off_adds_no_wire_field():
    captured = []
    sup = make_supervisor(workers=1).start()
    try:
        sup.wait_ready()
        worker = sup._workers["0"]
        real_stdin = worker.proc.stdin

        class _Spy:
            def write(self, line):
                captured.append(line)
                return real_stdin.write(line)

            def flush(self):
                return real_stdin.flush()

        worker.proc.stdin = _Spy()
        settle([sup.submit([1.0])])
        worker.proc.stdin = real_stdin
        requests = [json.loads(line) for line in captured if line.strip()]
        assert requests and all("trace" not in r for r in requests)
    finally:
        sup.stop()
