"""The port's lock witness (``keystone_tpu_torch/lint/lockwitness.py``):
wrapper mechanics, the model-vs-runtime cross-check over the port's
threaded components (batcher, prefetch queue, registry hot swap,
admission and telemetry, a CPU ``PipelineServer`` with a hot swap, a
stub-worker supervisor), and the committed baseline's subset invariant:
``lint/lockorder_baseline.json`` ⊆ the port's static lock graph.

The root ``tests/conftest.py`` witness fixture is the JAX package's; the
port's threaded test files arm the port's witness with their own
``_port_lock_witness`` fixture (``tests/torch_lock_witness.py``) when
``KEYSTONE_LOCK_WITNESS`` is set.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import keystone_tpu_torch
from keystone_tpu_torch.lint.lockmodel import CALLBACK, build_model
from keystone_tpu_torch.lint.lockwitness import LockWitness, armed_for_test, lock_witness
from keystone_tpu_torch.workflow.executor import PipelineEnv

PACKAGE = os.path.dirname(os.path.abspath(keystone_tpu_torch.__file__))
BASELINE = os.path.join(PACKAGE, "lint", "lockorder_baseline.json")

_model_cache = {}


def model():
    if "m" not in _model_cache:
        _model_cache["m"] = build_model([PACKAGE])
    return _model_cache["m"]


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


# ----------------------------------------------------------------- wrapper


def test_nested_acquisition_records_one_edge():
    with lock_witness(site_names={}) as w:
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(2):  # repeat: same edge, higher count
            with a:
                with b:
                    pass
    ((_edge, count),) = w.observed_edges().items()
    assert count == 2


def test_reentrant_rlock_records_no_self_edge():
    with lock_witness(site_names={}) as w:
        r = threading.RLock()
        with r:
            with r:
                pass
    assert w.observed_edges() == {}


def test_release_unwinds_held_stack():
    with lock_witness(site_names={}) as w:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            pass
        with b:
            pass
    assert w.observed_edges() == {}


def test_condition_over_witnessed_lock_works():
    with lock_witness(site_names={}):
        lk = threading.Lock()
        cond = threading.Condition(lk)
        hits = []

        def waiter():
            with cond:
                cond.wait(1.0)
                hits.append(1)

        t = threading.Thread(target=waiter)
        t.start()
        for _ in range(50):
            if lk.locked():
                break
            time.sleep(0.01)
        with cond:
            cond.notify_all()
        t.join(2.0)
        assert hits == [1]


def test_uninstall_restores_factories():
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    with lock_witness(site_names={}):
        assert threading.Lock is not orig_lock
    assert threading.Lock is orig_lock and threading.RLock is orig_rlock


def test_site_naming_against_the_ports_table():
    w = LockWitness(site_names={(os.path.join("serving", "batcher.py"), 46): "X"})
    assert w._name_for("/somewhere/keystone_tpu_torch/serving/batcher.py", 46) == ("X", True)
    # The JAX package's file at the same relative path is not the port's.
    name, known = w._name_for("/somewhere/keystone_tpu/serving/batcher.py", 46)
    assert known is False and name.endswith("batcher.py:46")


def test_unknown_edges_respects_open_world_holders():
    w = LockWitness(site_names={("a.py", 1): "A", ("a.py", 2): "B", ("a.py", 3): "C"})
    w._edges[("A", "B")] = 1  # anticipated via A -> <callback>
    w._edges[("B", "C")] = 1  # genuine drift
    w._edges[("B", "zz.py:9")] = 1  # foreign endpoint: recorded, not drift
    assert w.unknown_edges({("A", CALLBACK)}) == [("B", "C")]


def test_armed_for_test_is_a_no_op_unless_asked(monkeypatch):
    monkeypatch.delenv("KEYSTONE_LOCK_WITNESS", raising=False)
    orig = threading.Lock
    with armed_for_test("t") as w:
        assert w is None and threading.Lock is orig


def test_armed_for_test_records_and_writes_edges(monkeypatch, tmp_path):
    out = tmp_path / "edges.jsonl"
    monkeypatch.setenv("KEYSTONE_LOCK_WITNESS", "record")
    monkeypatch.setenv("KEYSTONE_LOCK_WITNESS_OUT", str(out))
    with armed_for_test("t::one") as w:
        a, b = threading.Lock(), threading.Lock()
        with a, b:
            pass
    assert w is not None and w.created >= 2
    line = json.loads(out.read_text().splitlines()[0])
    assert line["test"] == "t::one" and len(line["edges"]) == 1


# --------------------------------------------- runtime vs static cross-check


def _drive_components():
    from keystone_tpu_torch.data.ingest import PrefetchQueue
    from keystone_tpu_torch.serving.admission import AdmissionController
    from keystone_tpu_torch.serving.batcher import MicroBatcher
    from keystone_tpu_torch.serving.config import Request, ServingConfig
    from keystone_tpu_torch.serving.registry import ModelRegistry
    from keystone_tpu_torch.serving.server import PipelineServer
    from keystone_tpu_torch.serving.synthetic import synthetic_fitted_pipeline, synthetic_requests
    from keystone_tpu_torch.serving.telemetry import ServingTelemetry

    mb = MicroBatcher(64)
    stop = threading.Event()

    def producer():
        for i in range(100):
            mb.offer(Request(payload=[float(i)], model="m"))

    def consumer():
        while not stop.is_set() or mb.depth():
            mb.next_batch(8, 0.001, stop=stop)

    cons = threading.Thread(target=consumer)
    cons.start()
    producers = [threading.Thread(target=producer) for _ in range(2)]
    for t in producers:
        t.start()
    for t in producers:
        t.join()
    stop.set()
    cons.join(5.0)

    with PrefetchQueue(range(40), prepare=lambda x: x * 2, depth=2, workers=2) as pq:
        assert len(list(pq)) == 40

    registry = ModelRegistry()

    class M:
        def apply_batch(self, ds):
            return ds

    registry.publish("m", M())

    def swapper():
        for _ in range(50):
            registry.publish("m", M())

    def resolver():
        for _ in range(50):
            registry.resolve("m")
            registry.describe()

    ts = [threading.Thread(target=f) for f in (swapper, resolver)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()

    telemetry = ServingTelemetry()
    admission = AdmissionController(16)

    def hammer():
        for i in range(100):
            telemetry.record_request(0.001, 0.0005)
            telemetry.record_batch(4, 4, 8)
            try:
                admission.admit(i % 20)
            except Exception:
                pass
        telemetry.snapshot()
        admission.stats()

    ts = [threading.Thread(target=hammer) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()

    model_v1 = synthetic_fitted_pipeline(d=8, depth=1, device="cpu")
    with PipelineServer(model_v1, config=ServingConfig(max_batch=8, max_wait_ms=1.0), device="cpu") as server:
        payloads = synthetic_requests(24, d=8)
        server.warmup(payloads[0])
        futures = server.submit_many(payloads[:12])
        server.registry.publish(server.default_model, synthetic_fitted_pipeline(d=8, depth=1, seed=3, device="cpu"))
        futures += server.submit_many(payloads[12:])
        assert all(np.asarray(f.result(timeout=30)).shape == (8,) for f in futures)
        server.stats()


def _drive_stub_fleet():
    from keystone_tpu_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor

    sup = WorkerSupervisor(
        {"stub": {"delay_ms": 1}}, SupervisorConfig(workers=2, heartbeat_s=0.05, hang_timeout_s=5.0)
    ).start()
    try:
        sup.wait_ready()
        results = [f.result(timeout=30) for f in [sup.submit([float(i)]) for i in range(20)]]
        assert [r[0] for r in results] == [2.0 * i for i in range(20)]
        sup.stats()
    finally:
        sup.stop(drain=True)


def test_threaded_components_take_no_edge_missing_from_model():
    """The acceptance invariant, in-process: drive the port's threaded
    serving, ingest and fleet components under the witness; every
    acquisition edge between model-known locks must be in the static
    graph (or covered by an open-world holder)."""
    m = model()
    with lock_witness(site_names=m.alloc_sites()) as w:
        _drive_components()
        _drive_stub_fleet()
    assert w.observed_edges(), "witness saw no edges — instrumentation broken"
    assert w.unknown_edges(m.edge_pairs()) == []


# ------------------------------------------------------------------ baseline


def _baseline():
    with open(BASELINE) as fh:
        return json.load(fh)


def test_baseline_observed_edges_subset_of_static_graph():
    """The committed baseline (edges the port's threaded tests actually
    took) must stay inside the CURRENT static graph: a model change that
    loses an edge the runtime takes fails here, not silently."""
    baseline = _baseline()
    static = model().edge_pairs()
    open_world = {a for (a, b) in static if b == CALLBACK}
    assert baseline["observed_edges"], "an empty baseline proves nothing"
    missing = [
        (a, b)
        for a, b in (tuple(e) for e in baseline["observed_edges"])
        if (a, b) not in static and a not in open_world
    ]
    assert missing == [], (
        f"baseline edges no longer in the static lock-order graph: {missing} "
        "— regenerate lint/lockorder_baseline.json or fix the model"
    )


def test_baseline_locks_still_exist():
    names = set(model().locks) | {CALLBACK}
    for a, b in _baseline()["static_edges"]:
        assert a in names, f"baseline references unknown lock {a!r}"
        assert b in names, f"baseline references unknown lock {b!r}"

