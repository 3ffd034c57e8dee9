"""The port's fleet control plane against the JAX package's on the same
inputs, and the fleet end to end on CPU workers.

Exact, because both sides are deterministic host code: ``HashRing``
placements and failover orders; ``loadgen`` arrival offsets for the same
seeds; ``SLOController`` and ``Autoscaler`` decisions on one injected
clock and p99 trace; the wire trace context both ways; ``prometheus_text``
and ``fleet_prometheus_text`` on the same registry contents.

End to end: a JAX-fitted MNIST random-FFT pipeline, carried into the port
by ``convert.mnist_pipeline_from_numpy``'s parts (the scores, before the
argmax), is stored in a ``CheckpointStore`` and served by a 2-worker port
fleet on the CPU; the answers lie within ``SERVE_TOL`` = 1e-5 (relative
Frobenius; measured 3.3e-7–3.4e-7) of the JAX package's ``apply_batch`` in
process on the same rows, and their argmax equals the JAX labels.
``SupervisorPublisher`` then publishes a candidate (the same pipeline
fitted at another λ) and rolls it back: every worker acks each swap with
its ``warmup_s``, and the answers follow the version served, to the same
bound. Every wait carries its own timeout.
"""

import json
import time

import numpy as np
import pytest

import keystone_tpu.obs.fleet as jfleet
import keystone_tpu.obs.metrics as jmetrics
import keystone_tpu.obs.spans as jspans
import keystone_tpu.serving.admission as jadmission
import keystone_tpu.serving.autoscaler as jautoscaler
import keystone_tpu.serving.loadgen as jloadgen
import keystone_tpu.serving.slo as jslo
import keystone_tpu.serving.supervisor as jsupervisor
import keystone_tpu_torch.obs.fleet as tfleet
import keystone_tpu_torch.obs.metrics as tmetrics
import keystone_tpu_torch.obs.spans as tspans
import keystone_tpu_torch.serving.admission as tadmission
import keystone_tpu_torch.serving.autoscaler as tautoscaler
import keystone_tpu_torch.serving.loadgen as tloadgen
import keystone_tpu_torch.serving.slo as tslo
import keystone_tpu_torch.serving.supervisor as tsupervisor
from keystone_tpu.obs.export import prometheus_text as j_prometheus_text
from keystone_tpu_torch.obs.export import prometheus_text as t_prometheus_text
from keystone_tpu_torch.obs.flight import reset_flight_recorder
from keystone_tpu_torch.reliability.recovery import get_recovery_log, reset_recovery_log
from keystone_tpu_torch.workflow.executor import PipelineEnv
from torch_lock_witness import _port_lock_witness  # noqa: F401 (autouse fixture)

SERVE_TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_recovery_log()
    reset_flight_recorder()
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()
    reset_flight_recorder()
    reset_recovery_log()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("nodes", [["0", "1"], ["0", "1", "2", "3"], ["2", "5", "7"]])
def test_hash_ring_placements_and_failover_equal_the_jax_packages(nodes):
    t_ring, j_ring = tsupervisor.HashRing(nodes), jsupervisor.HashRing(nodes)
    keys = [f"default:{i}" for i in range(400)] + [f"m2:tenant-{i}" for i in range(50)]
    assert [list(t_ring.walk(k)) for k in keys] == [list(j_ring.walk(k)) for k in keys]
    assert sorted(t_ring.walk("anything")) == sorted(nodes)


# ------------------------------------------------------------------ loadgen


@pytest.mark.parametrize("seed", [0, 7])
def test_loadgen_offsets_equal_the_jax_packages(seed):
    for name, kwargs in (
        ("diurnal_offsets", dict(duration_s=20.0, base_rps=5.0, peak_rps=60.0, seed=seed)),
        ("bursty_offsets", dict(duration_s=20.0, base_rps=4.0, burst_rps=80.0, seed=seed)),
        ("heavy_tail_offsets", dict(duration_s=20.0, rps=30.0, alpha=1.5, seed=seed)),
    ):
        got, want = getattr(tloadgen, name)(**kwargs), getattr(jloadgen, name)(**kwargs)
        assert got == want and len(got) > 10, name


def test_run_load_accounts_for_every_request():
    from concurrent.futures import Future

    def submit(payload, deadline_s=None):
        future = Future()
        if payload % 5 == 4:
            future.set_exception(RuntimeError("refused"))
        else:
            future.set_result(payload)
        return future

    report = tloadgen.run_load(submit, [0.0] * 20, payload=lambda i: i, settle_timeout_s=5.0)
    assert (report.offered, report.completed, report.dropped) == (20, 16, 4)
    assert report.errors == {"RuntimeError": 4}


# ----------------------------------------------------------- SLO controller


def _p99_trace():
    """(t, per-worker stats) sweeps: over target, a stale window, under
    the recovery line, then over again."""
    sweeps, served = [], {"0": 0, "1": 0}
    for t, p99s in [(0.0, (80, 20)), (0.5, (90, 20)), (1.2, (95, 30)), (1.4, (95, 30)), (2.5, (120, 40)),
                    (3.0, (10, 10)), (4.0, (10, 12)), (6.5, (9, 9)), (7.0, (8, 8)), (9.8, (7, 7)),
                    (10.5, (60, 10)), (12.0, (70, 10))]:
        stale = t == 1.4
        if not stale:
            served = {w: n + 32 for w, n in served.items()}
        sweeps.append((t, {w: {"p99_ms": p, "served": served[w]} for w, p in zip(("0", "1"), p99s)}))
    return sweeps


def test_slo_controller_decisions_equal_the_jax_packages():
    records = {}
    for pkg, (admission, slo) in {"port": (tadmission, tslo), "jax": (jadmission, jslo)}.items():
        clock = {"t": 0.0}
        controller = slo.SLOController(
            admission.AdmissionController(100, rungs=slo.SLO_RUNGS, external=True),
            target_p99_ms=50.0, cooldown_s=1.0, settle_s=3.0, clock=lambda: clock["t"],
        )
        out = []
        for t, sweep in _p99_trace():
            clock["t"] = t
            out.append((controller.observe(sweep), controller.admission.rung_index, controller.headroom()))
        records[pkg] = (out, controller.stats())
    assert records["port"] == records["jax"]
    assert [r for r, _, _ in records["port"][0] if r is not None]  # the ladder moved


# --------------------------------------------------------------- autoscaler


class FakeFleet:
    """The stats/add_worker/remove_worker surface the autoscaler drives,
    with hand-cranked traffic (tests/serving/test_autoscaler.py's)."""

    def __init__(self, workers=1):
        self.rows, self._next, self.pending = {}, 0, 0
        for _ in range(workers):
            self._add("ready")

    def _add(self, state):
        worker_id = str(self._next)
        self._next += 1
        self.rows[worker_id] = {"state": state, "inflight": 0, "stats": {"served": 0, "p99_ms": 1.0}}
        return worker_id

    def tick(self, p99_ms, served_inc=32, inflight=0):
        for row in self.rows.values():
            if row["state"] == "ready":
                row["stats"]["served"] += served_inc
                row["stats"]["p99_ms"] = p99_ms
                row["inflight"] = inflight

    def stats(self):
        states = [r["state"] for r in self.rows.values()]
        return {
            "workers": {w: {"state": r["state"], "inflight": r["inflight"], "stats": dict(r["stats"])}
                        for w, r in self.rows.items()},
            "supervisor": {"alive": states.count("ready"),
                           "booting": sum(1 for s in states if s in ("new", "spawning")),
                           "draining": states.count("draining"), "pending": self.pending},
        }

    def add_worker(self, reason="scale_up"):
        return self._add("spawning")

    def remove_worker(self, worker_id=None, reason="scale_down"):
        ready = [w for w, r in self.rows.items() if r["state"] == "ready"]
        if len(ready) <= 1:
            return None
        self.rows[ready[-1]]["state"] = "draining"
        return ready[-1]


def _drive_autoscaler(pkg):
    fleet = FakeFleet(workers=1)
    scaler = pkg.Autoscaler(fleet, pkg.AutoscalerConfig(
        target_p99_ms=50.0, min_workers=1, max_workers=3, pressure_s=1.0, idle_s=2.0, cooldown_s=5.0,
    ))
    decisions = []
    t = 0.0
    for step in range(80):
        t = round(t + 0.25, 2)
        if step in (8, 32):  # added workers finish booting
            for row in fleet.rows.values():
                row["state"] = "ready" if row["state"] == "spawning" else row["state"]
        if step == 50:  # the drained worker retires
            fleet.rows = {w: r for w, r in fleet.rows.items() if r["state"] != "draining"}
        fleet.pending = 3 if 10 <= step < 14 else 0
        if step < 30:
            fleet.tick(p99_ms=120.0, inflight=20)
        elif step < 60:
            fleet.tick(p99_ms=2.0)
        else:
            fleet.tick(p99_ms=80.0, served_inc=0)  # stale windows: no p99 signal
        decisions.append((t, scaler.step(now=t)))
    return decisions, scaler.stats()


def test_autoscaler_decisions_equal_the_jax_packages():
    port, jax_side = _drive_autoscaler(tautoscaler), _drive_autoscaler(jautoscaler)
    assert port == jax_side
    fired = [d for _, d in port[0] if d is not None]
    assert any(d.startswith("up:") for d in fired) and any(d.startswith("down:") for d in fired)
    assert port[1]["scale_ups"] >= 1 and port[1]["scale_downs"] >= 1


# -------------------------------------------------------------- wire + export


def test_wire_context_round_trips_between_the_packages():
    for ctx in [("0123456789abcdef", "fedcba9876543210"), ("t", ""), None]:
        assert tspans.to_wire(ctx) == jspans.to_wire(ctx)
        wire = jspans.to_wire(ctx)
        assert tspans.from_wire(wire) == jspans.from_wire(wire)
        assert jspans.from_wire(tspans.to_wire(ctx)) == tspans.from_wire(tspans.to_wire(ctx))
    for garbage in ["", ":x", "nocolon", 7, None, ["a", "b"]]:
        assert tspans.from_wire(garbage) == jspans.from_wire(garbage)
    assert tspans.WIRE_FIELD == jspans.WIRE_FIELD


def _fill(metrics_mod):
    registry = metrics_mod.MetricsRegistry()
    c = registry.counter("keystone_serving_requests_total", "Requests served", ("model",))
    c.inc(3, model="a")
    c.inc(1.5, model='q"uote\\d')
    registry.gauge("keystone_serving_workers_alive", "Workers").set(2)
    registry.counter("keystone_fleet_trace_bytes_total", "Bytes")
    h = registry.histogram("keystone_serving_latency_seconds", "Latency", ("model",))
    for v in (0.0004, 0.003, 0.02, 0.2, 7.0):
        h.observe(v, model="a")
    return registry


def test_prometheus_text_equals_the_jax_packages():
    text = t_prometheus_text(_fill(tmetrics))
    assert text == j_prometheus_text(_fill(jmetrics))
    assert "# TYPE keystone_serving_latency_seconds histogram" in text


def _fleet_text(fleet_mod):
    collector = fleet_mod.FleetTraceCollector()
    collector.observe_metrics("fleet-parity-0", 0, {"fleet_parity_series_total": 3.0})
    collector.observe_metrics("fleet-parity-0", 1, {"fleet_parity_series_total": 2.0})  # a restart folds
    collector.observe_metrics("fleet-parity-1", 0, {"fleet_parity_series_total": 0.5})

    class Supervisor:
        fleet = collector
        quality = None

        @staticmethod
        def fleet_counter_totals():
            return {"fleet-parity-0": {"served": 41.0, "failures": 2.0}, "fleet-parity-1": {"served": 7.0}}

    text = fleet_mod.fleet_prometheus_text(Supervisor())
    return sorted(line for line in text.splitlines() if "fleet-parity" in line or "fleet_parity" in line)


def test_fleet_prometheus_text_equals_the_jax_packages():
    lines = _fleet_text(tfleet)
    assert lines == _fleet_text(jfleet) and len(lines) == 4
    assert 'keystone_fleet_worker_series{series="fleet_parity_series_total"} 5.5' in lines


# -------------------------------------------------- end to end on CPU workers


@pytest.fixture(scope="module")
def carried_mnist():
    """Two JAX-fitted MNIST random-FFT models (λ = 10 and 1), their JAX
    scores and labels on 48 held-out rows, and the port's score
    pipelines holding their parameters."""
    from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JEstimator
    from keystone_tpu.ops.stats import core as jcore
    from keystone_tpu.ops.util.labels import ClassLabelIndicators as JIndicators
    from keystone_tpu.ops.util.labels import MaxClassifier as JMax
    from keystone_tpu.pipelines import mnist_random_fft as jm
    from keystone_tpu_torch.convert import mapper_from_numpy
    from keystone_tpu_torch.ops.stats.core import LinearRectifier, PaddedFFT, RandomSignNode
    from keystone_tpu_torch.ops.util.vectors import VectorCombiner
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    cfg = jm.MnistRandomFFTConfig(num_ffts=2, block_size=512)
    train, test = jm.synthetic_mnist(1024, seed=0), jm.synthetic_mnist(64, seed=1)
    featurizer = jm.build_featurizer(cfg)
    features, indicators = featurizer(train.data).get(), JIndicators(10)(train.labels).get()
    signs = [np.asarray(jcore.RandomSignNode.create(784, seed=cfg.seed + i).signs) for i in range(cfg.num_ffts)]
    x = np.asarray(test.data.data)[:48]
    out = {"x": x}
    for tag, reg in (("incumbent", 10.0), ("candidate", 1.0)):
        model = JEstimator(cfg.block_size, num_iter=1, reg=reg).fit(features, indicators)
        scores = np.asarray((featurizer >> model)(JArrayDataset(x)).get().data)[: len(x)]
        labels = np.asarray((featurizer >> model >> JMax())(JArrayDataset(x)).get().data)[: len(x)]
        branches = [RandomSignNode(s, device="cpu") >> PaddedFFT() >> LinearRectifier(0.0) for s in signs]
        mapper = mapper_from_numpy(
            np.asarray(model.weights), model.block_size, np.asarray(model.intercept),
            np.asarray(model.feature_mean), device="cpu",
        )
        out[tag] = ((Pipeline.gather(branches) >> VectorCombiner() >> mapper).fit(), scores, labels)
    return out


def test_jax_fitted_mnist_served_by_a_port_fleet_and_published_across_it(carried_mnist, tmp_path):
    from keystone_tpu_torch.refit.publish import SupervisorPublisher
    from keystone_tpu_torch.reliability.checkpoint import CheckpointStore

    x = carried_mnist["x"]
    incumbent, inc_scores, inc_labels = carried_mnist["incumbent"]
    candidate, cand_scores, cand_labels = carried_mnist["candidate"]
    store = str(tmp_path / "store")
    digest = "incumbent" + "0" * 31
    assert CheckpointStore(store, device="cpu").save(None, incumbent, digest=digest)
    sup = tsupervisor.WorkerSupervisor(
        {"checkpoint_dir": store, "digest": digest},
        tsupervisor.SupervisorConfig(workers=2, heartbeat_s=0.1, ready_timeout_s=90, device="cpu", max_batch=8),
    ).start()

    def served():
        futures = sup.submit_many([row.tolist() for row in x], deadline_s=60)
        return np.asarray([f.result(timeout=60) for f in futures])

    try:
        sup.wait_ready(timeout_s=90)
        first = served()
        publisher = SupervisorPublisher(sup, store, incumbent=incumbent, incumbent_digest=digest, device="cpu")
        ticket = publisher.publish(candidate, round_index=1)
        published = served()
        publisher.rollback(ticket, reason="test")
        rolled_back = served()
        deadline = time.monotonic() + 10
        while True:  # heartbeats carry each worker's registry versions
            stats = sup.stats()
            versions = {w["stats"]["models"]["default"]["current"] for w in stats["workers"].values()}
            if versions == {3} or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        sup.stop()
    assert _rel(first, inc_scores) <= SERVE_TOL and np.array_equal(first.argmax(1), inc_labels)
    assert _rel(published, cand_scores) <= SERVE_TOL and np.array_equal(published.argmax(1), cand_labels)
    assert _rel(rolled_back, inc_scores) <= SERVE_TOL
    assert set(ticket.acks) == {"0", "1"}
    assert all(a["kind"] == "swapped" and a["warmup_s"] >= 0 for a in ticket.acks.values())
    assert versions == {3}  # the spec's load, the publish, the rollback
    kinds = [e.kind for e in get_recovery_log().events()]
    assert kinds.count("refit_publish") == 1 and kinds.count("refit_rollback") == 1
    assert sup.spec == {"checkpoint_dir": store, "digest": digest}  # restarts serve the rollback
    assert json.dumps(stats)  # the stats line the CLI prints stays serializable
