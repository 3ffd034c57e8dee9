"""The port's in-process serving layer on the CPU (``device="cpu"``):
mirrors of ``tests/serving/`` (batcher, admission, telemetry, registry,
server), ``CompiledApply`` and ``warm_buckets``, the ``serve`` CLI, and
parity with the JAX package's server on the same requests.

Bounds: the synthetic pipeline's served rows ≤ 1e-5 relative to the JAX
server's (a tanh MLP in float32 on both sides; measured 1.2e-7); the
MNIST pipeline carried across from a JAX fit serves equal labels.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
from keystone_tpu_torch.reliability.faultinject import FaultSpec, injected
from keystone_tpu_torch.reliability.recovery import get_recovery_log
from keystone_tpu_torch.reliability.retry import Deadline, RetryPolicy
from keystone_tpu_torch.serving import (
    AdmissionController,
    AdmissionRung,
    ModelRegistry,
    PipelineServer,
    RequestShed,
    RequestTimeout,
    ServerClosed,
    ServingConfig,
    ServingTelemetry,
    UnknownModel,
    percentile,
    synthetic_fitted_pipeline,
    synthetic_requests,
)
from keystone_tpu_torch.serving.batcher import MicroBatcher
from keystone_tpu_torch.serving.config import Request
from keystone_tpu_torch.utils.aot import warm_buckets
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Transformer

pytestmark = pytest.mark.serving

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
D = 8
SERVE_TOL = 1e-5
WAIT_S = 30


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# --------------------------------------------------------------------- batcher


def req(payload=0, deadline_s=None):
    return Request(
        payload=payload,
        model="m",
        deadline=Deadline(deadline_s) if deadline_s is not None else None,
    )


def test_offer_is_bounded():
    b = MicroBatcher(capacity=2)
    assert b.offer(req()) and b.offer(req())
    assert not b.offer(req())
    assert b.refused == 1 and b.depth() == 2


def test_full_batch_dispatches_before_max_wait():
    b = MicroBatcher(capacity=8)
    for i in range(4):
        b.offer(req(i))
    t0 = time.monotonic()
    batch = b.next_batch(max_batch=4, max_wait_s=5.0)
    assert [r.payload for r in batch] == [0, 1, 2, 3]
    assert time.monotonic() - t0 < 1.0  # did NOT hold the full 5 s max-wait


def test_partial_batch_respects_max_wait():
    b = MicroBatcher(capacity=8)
    b.offer(req("solo"))
    t0 = time.monotonic()
    batch = b.next_batch(max_batch=4, max_wait_s=0.08)
    elapsed = time.monotonic() - t0
    assert [r.payload for r in batch] == ["solo"]
    assert 0.06 <= elapsed < 2.0


def test_expired_request_fails_at_assembly_not_on_device():
    expired_seen = []
    b = MicroBatcher(capacity=8, on_expired=expired_seen.append)
    dead = req("dead", deadline_s=0.0)
    live = req("live")
    time.sleep(0.01)  # the 0-second deadline is now past
    b.offer(dead)
    b.offer(live)
    batch = b.next_batch(max_batch=2, max_wait_s=0.01)
    assert [r.payload for r in batch] == ["live"]
    assert b.expired == 1 and expired_seen == [dead]
    with pytest.raises(RequestTimeout):
        dead.future.result(timeout=0)


def test_batch_closes_early_for_member_deadline():
    b = MicroBatcher(capacity=8)
    b.offer(req("urgent", deadline_s=0.08))
    t0 = time.monotonic()
    batch = b.next_batch(max_batch=4, max_wait_s=10.0)
    assert [r.payload for r in batch] == ["urgent"]
    assert not batch[0].future.done()  # dispatched, not expired
    assert time.monotonic() - t0 < 5.0  # nowhere near the 10 s max-wait


def test_fail_all_drains_queue():
    b = MicroBatcher(capacity=4)
    requests = [req(i) for i in range(3)]
    for r in requests:
        b.offer(r)
    assert b.fail_all(RuntimeError("shutdown")) == 3
    assert b.depth() == 0
    for r in requests:
        with pytest.raises(RuntimeError):
            r.future.result(timeout=0)


# ------------------------------------------------------------------- admission

# The JAX package's SLO controller rungs (serving/slo.py), which drive
# the external mode there: the normal rung admits to the full bound,
# degraded rungs to shrinking fractions.
SLO_RUNGS = (
    AdmissionRung(queue_frac=1.0, wait_scale=1.0, name="normal"),
    AdmissionRung(queue_frac=0.6, wait_scale=0.5, name="pressure"),
    AdmissionRung(queue_frac=0.3, wait_scale=0.25, name="overload"),
)


def test_normal_admission_at_low_depth():
    a = AdmissionController(capacity=10)
    rung = a.admit(depth=0)
    assert rung.name == "normal" and rung.wait_scale == 1.0
    assert a.stats()["rung"] == "normal"


def test_degrades_under_pressure_and_records_once():
    a = AdmissionController(capacity=10)
    assert a.admit(depth=6).name == "pressure"  # past 0.5x10, under 0.75x10
    assert a.wait_scale() == 0.5
    events = get_recovery_log().events("degrade")
    assert len(events) == 1 and events[0].label == "serving-admission"
    for _ in range(50):
        a.admit(depth=6)
    assert len(get_recovery_log().events("degrade")) == 1


def test_overload_rung_then_shed_at_capacity():
    a = AdmissionController(capacity=10)
    assert a.admit(depth=9).name == "overload"
    with pytest.raises(RequestShed):
        a.admit(depth=10)
    assert a.stats()["sheds"] == 1 and a.stats()["consecutive_sheds"] == 1
    a.admit(depth=1)  # success resets the consecutive counter
    assert a.stats()["consecutive_sheds"] == 0


def test_recovers_to_normal_when_queue_drains():
    a = AdmissionController(capacity=10)
    a.admit(depth=9)
    assert a.rung_index == 2
    assert a.admit(depth=0).name == "normal"
    assert a.wait_scale() == 1.0


def test_rung_fracs_must_be_monotone():
    with pytest.raises(ValueError):
        AdmissionController(
            capacity=4, rungs=[AdmissionRung(0.9, 1.0), AdmissionRung(0.5, 0.5)]
        )


def test_external_mode_never_walks_on_depth():
    controller = AdmissionController(100, rungs=SLO_RUNGS, external=True)
    assert controller.admit(99).name == "normal"
    assert controller.rung_index == 0  # depth moved nothing
    with pytest.raises(RequestShed):
        controller.admit(100)


def test_force_rung_pins_and_reports_previous():
    controller = AdmissionController(100, rungs=SLO_RUNGS, external=True)
    assert controller.force_rung(2) == 0
    assert controller.force_rung(2) is None  # already there
    assert controller.rungs[controller.rung_index].name == "overload"
    with pytest.raises(RequestShed):
        controller.admit(40)  # 0.3 * 100 bound now
    assert controller.force_rung(0) == 2
    with pytest.raises(ValueError):
        controller.force_rung(7)


def test_external_mode_allows_non_monotonic_rungs():
    shrinking = (
        AdmissionRung(queue_frac=1.0, wait_scale=1.0, name="a"),
        AdmissionRung(queue_frac=0.5, wait_scale=0.5, name="b"),
    )
    with pytest.raises(ValueError):
        AdmissionController(10, rungs=shrinking)  # depth mode refuses
    assert AdmissionController(10, rungs=shrinking, external=True)


# ------------------------------------------------------------------- telemetry


def test_percentile_interpolation():
    data = [1.0, 2.0, 3.0, 4.0]
    assert percentile(data, 0) == 1.0
    assert percentile(data, 100) == 4.0
    assert percentile(data, 50) == 2.5
    assert percentile([], 50) == 0.0
    assert percentile([7.0], 99) == 7.0


def test_snapshot_fields_and_percentiles():
    t = ServingTelemetry(window=16)
    for ms in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        t.record_request(latency_s=ms / 1e3, queue_wait_s=ms / 2e3)
    t.record_batch(size=5, bucket=8, max_batch=10)
    t.record_shed()
    t.record_timeout()
    snap = t.snapshot(queue_depth=3)
    assert snap["served"] == 10 and snap["batches"] == 1
    assert snap["sheds"] == 1 and snap["timeouts"] == 1
    assert snap["queue_depth"] == 3
    assert snap["p50_ms"] == pytest.approx(5.5, abs=0.01)
    assert snap["p50_ms"] <= snap["p99_ms"] <= 10.0
    assert snap["batch_occupancy"] == 0.5


def test_bucket_warmth_hit_rate():
    t = ServingTelemetry()
    t.mark_bucket_warm(4)
    t.record_batch(3, bucket=4, max_batch=8)   # warm → hit
    t.record_batch(7, bucket=8, max_batch=8)   # cold → first batch at a bucket
    t.record_batch(8, bucket=8, max_batch=8)   # now warm → hit
    assert t.bucket_hits == 2 and t.bucket_compiles == 1
    assert t.snapshot()["bucket_hit_rate"] == pytest.approx(2 / 3, abs=1e-4)


def test_maybe_log_rate_limited():
    clock = {"t": 0.0}
    t = ServingTelemetry(clock=lambda: clock["t"])
    assert not t.maybe_log(interval_s=30.0)
    clock["t"] = 31.0
    assert t.maybe_log(interval_s=30.0)
    assert not t.maybe_log(interval_s=30.0)


# -------------------------------------------------------------------- registry


def test_publish_versions_and_rollback():
    r = ModelRegistry()
    v1 = r.publish("m", "model-one")
    v2 = r.publish("m", "model-two")
    assert (v1.version, v2.version) == (1, 2)
    assert r.resolve("m").model == "model-two"
    assert r.resolve("m", version=1).model == "model-one"
    assert r.versions("m") == [1, 2]
    r.rollback("m", 1)
    assert r.resolve("m").model == "model-one"
    assert r.swaps == 2  # publish-over + rollback
    assert r.describe()["m"]["last_rollback"]["to_version"] == 1


def test_bounded_history_keeps_current_and_rolls_back_to_previous():
    r = ModelRegistry(history_limit=2)
    for i in range(6):
        r.publish("m", f"model-{i}")
    assert r.versions("m") == [4, 5, 6] and r.evicted == 3
    assert r.rollback("m").version == 5


def test_unknown_model_raises():
    r = ModelRegistry()
    with pytest.raises(UnknownModel):
        r.resolve("missing")
    r.publish("m", object())
    with pytest.raises(UnknownModel):
        r.resolve("m", version=99)


def test_load_fitted_artifact(tmp_path):
    path = str(tmp_path / "model.pt")
    synthetic_fitted_pipeline(d=4, seed=3, device=CPU).save(path)
    entry = ModelRegistry().load_fitted("m", path, device=CPU)
    assert entry.source == f"fitted:{path}"
    out = entry.batch_apply(ArrayDataset(np.ones((2, 4), np.float32), device=CPU))
    assert tuple(out.data.shape) == (2, 4) and out.data.device.type == "cpu"


def test_entry_without_apply_path_raises():
    entry = ModelRegistry().publish("m", object())
    with pytest.raises(TypeError):
        entry.batch_apply(ArrayDataset(np.ones((1, 2), np.float32), device=CPU))


# ----------------------------------------------------- CompiledApply, warmup


def test_compiled_apply_binds_once_and_matches_apply_batch(tmp_path):
    fp = synthetic_fitted_pipeline(d=D, seed=4, device=CPU)
    handle = fp.compiled_apply()
    assert fp.compiled_apply() is handle and fp.fused() is fp
    for n in (3, 5):
        x = np.stack(synthetic_requests(n, d=D, seed=n))
        want = fp.apply_batch(ArrayDataset(x, device=CPU)).data
        assert torch.equal(handle(ArrayDataset(x, device=CPU)).data, want)
    assert handle.calls == 2
    path = str(tmp_path / "fp.pt")
    fp.save(path)  # the bound graph and its last payload are not saved
    loaded = FittedPipeline.load(path, device=CPU)
    assert loaded._compiled is None


def test_warm_buckets_warms_the_pad_row_path():
    seen = []

    def batch_apply(dataset):
        seen.append((dataset.physical_rows, dataset.num_examples, dataset.device.type))
        return dataset

    out = warm_buckets(batch_apply, np.zeros((3,), np.float32), (4, 1, 2, 4), device=CPU)
    assert sorted(out) == ["bucket_1_s", "bucket_2_s", "bucket_4_s"]
    assert seen == [(1, 1, "cpu"), (2, 1, "cpu"), (4, 1, "cpu")]
    with pytest.raises(ValueError):
        warm_buckets(batch_apply, np.zeros((3,), np.float32), (0,), device=CPU)


# ---------------------------------------------------------------------- server


class ScaleModel(Transformer):
    """k·x with an optional pre-apply sleep (makes queue buildup and
    in-flight batches controllable in tests)."""

    def __init__(self, k, delay_s=0.0):
        self.k = k
        self.delay_s = delay_s

    def apply(self, x):
        return torch.as_tensor(x) * self.k

    def apply_batch(self, dataset):
        if self.delay_s:
            time.sleep(self.delay_s)
        return ArrayDataset(dataset.data * self.k, dataset.num_examples)


def serve(model, **kw):
    defaults = dict(max_batch=8, max_wait_ms=10.0, queue_depth=64)
    defaults.update(kw)
    return PipelineServer(model, config=ServingConfig(**defaults), device=CPU)


def test_results_match_direct_apply():
    fp = synthetic_fitted_pipeline(d=D, seed=2, device=CPU)
    payloads = synthetic_requests(13, d=D)
    expected = fp.apply_batch(ArrayDataset(np.stack(payloads), device=CPU)).data.numpy()
    with serve(fp) as server:
        results = np.stack([f.result(timeout=WAIT_S) for f in server.submit_many(payloads)])
    np.testing.assert_allclose(results, expected, rtol=1e-5, atol=1e-6)


def test_bucket_padding_never_recompiles_after_warmup():
    """After bucket warmup no request size meets a new batch shape:
    ``SyntheticDense`` logs the first application at each input shape."""
    shapes = []
    fp = synthetic_fitted_pipeline(d=D, trace_log=shapes, device=CPU)
    with serve(fp) as server:
        server.warmup(np.zeros((D,), np.float32))
        buckets = server.config.buckets()
        assert shapes == [(b, D) for b in buckets]  # one new shape per bucket
        for n in (3, 5, 2, 7, 1, 8):  # sizes that all pad to some bucket
            for f in server.submit_many(synthetic_requests(n, d=D, seed=n)):
                f.result(timeout=WAIT_S)
        stats = server.stats()
    assert shapes == [(b, D) for b in buckets], f"new shapes after warmup: {shapes}"
    assert "cufft_plans_since_warmup" not in stats  # the CPU has no cuFFT plan cache
    assert stats["bucket_compiles"] == 0  # every batch hit a warm bucket
    assert stats["bucket_hit_rate"] == 1.0
    assert stats["served"] == 26 and stats["failures"] == 0


def test_overload_sheds_instead_of_queueing_unboundedly():
    with serve(ScaleModel(2, delay_s=0.05), queue_depth=8, max_wait_ms=1.0) as server:
        futures = server.submit_many(synthetic_requests(80, d=D))
        assert server.batcher.depth() <= 8  # the queue never grew past capacity
        outcomes = []
        for f in futures:
            try:
                f.result(timeout=WAIT_S)
                outcomes.append("ok")
            except RequestShed:
                outcomes.append("shed")
        stats = server.stats()
    assert "shed" in outcomes and "ok" in outcomes  # degraded, not dead
    assert stats["sheds"] == outcomes.count("shed") > 0
    assert stats["admission"]["sheds"] > 0
    assert stats["failures"] == 0  # sheds are refusals, not apply failures


def test_hot_swap_serves_new_version_with_zero_dropped_requests():
    with serve(ScaleModel(1), max_wait_ms=2.0) as server:
        payloads = synthetic_requests(60, d=D)
        first = server.submit_many(payloads[:30])
        server.registry.publish("default", ScaleModel(3))  # hot-swap mid-stream
        second = server.submit_many(payloads[30:])
        results = [f.result(timeout=WAIT_S) for f in first + second]  # zero drops
    for x, y in zip(payloads, results):
        ratio = np.asarray(y) / x
        # Every request was served by exactly one version, never a mix.
        assert np.allclose(ratio, 1.0) or np.allclose(ratio, 3.0)
    for x, y in zip(payloads[30:], results[30:]):
        np.testing.assert_allclose(np.asarray(y), x * 3, rtol=1e-6)
    assert server.registry.swaps == 1


def test_deadline_expires_in_queue_while_worker_busy():
    with serve(ScaleModel(2, delay_s=0.3), max_wait_ms=1.0) as server:
        blocker = server.submit(synthetic_requests(1, d=D)[0])
        time.sleep(0.05)  # the blocker's batch is now on the worker
        doomed = server.submit(synthetic_requests(1, d=D, seed=9)[0], deadline_s=0.05)
        with pytest.raises(RequestTimeout):
            doomed.result(timeout=WAIT_S)
        blocker.result(timeout=WAIT_S)  # the in-flight batch still completes
        assert server.stats()["timeouts"] == 1


def test_transient_fault_in_apply_is_retried_per_policy():
    fp = synthetic_fitted_pipeline(d=D, device=CPU)
    policy = RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.02)
    with injected(FaultSpec(match="serving.apply", kind="transient", calls=(1,))) as injector:
        with serve(fp, retry_policy=policy) as server:
            results = [f.result(timeout=WAIT_S) for f in server.submit_many(synthetic_requests(3, d=D))]
            stats = server.stats()
    assert len(results) == 3 and all(np.asarray(r).shape == (D,) for r in results)
    # One probe call per batch plus exactly one retried attempt.
    assert injector.calls("serving.apply") == stats["batches"] + 1
    assert stats["retries"] == 1 and stats["failures"] == 0
    assert len(get_recovery_log().events("retry")) == 1


def test_exhausted_retries_fail_the_batch_loudly():
    fp = synthetic_fitted_pipeline(d=D, device=CPU)
    policy = RetryPolicy(max_attempts=2, base_delay_s=0.01, max_delay_s=0.02)
    with injected(FaultSpec(match="serving.apply", kind="transient", first_n=5)):
        with serve(fp, retry_policy=policy) as server:
            future = server.submit(synthetic_requests(1, d=D)[0])
            with pytest.raises(ConnectionError):
                future.result(timeout=WAIT_S)
            assert server.stats()["failures"] == 1


def test_model_returning_short_rows_fails_tail_instead_of_hanging():
    class FirstRowOnly(Transformer):
        def apply(self, x):
            return np.asarray(x)

        def apply_batch(self, dataset):
            return ObjectDataset(dataset.collect()[:1])

    with serve(FirstRowOnly(), max_wait_ms=30.0) as server:
        futures = server.submit_many(synthetic_requests(3, d=D))
        outcomes = []
        for f in futures:
            try:
                f.result(timeout=10)
                outcomes.append("ok")
            except Exception as exc:
                assert "returned 1 rows for a batch of" in str(exc)
                outcomes.append("short")
        stats = server.stats()
    assert outcomes.count("short") >= 1
    assert outcomes.count("ok") + outcomes.count("short") == 3
    assert stats["failures"] == outcomes.count("short")


def test_submit_after_stop_raises():
    server = serve(ScaleModel(1)).start()
    server.stop()
    with pytest.raises(ServerClosed):
        server.submit(np.zeros((D,), np.float32))


def test_restart_after_stop_serves_again():
    server = serve(ScaleModel(2))
    server.start()
    assert server.submit(np.ones((D,), np.float32)).result(timeout=WAIT_S) is not None
    server.stop()
    server.start()  # must clear the stop signal: a restarted worker serves
    np.testing.assert_allclose(np.asarray(server.submit(np.ones((D,), np.float32)).result(timeout=WAIT_S)), 2.0)
    server.stop()
    assert server._thread is None


def test_wrong_shaped_request_fails_alone_not_its_batchmates():
    with serve(synthetic_fitted_pipeline(d=D, device=CPU), max_wait_ms=30.0) as server:
        good = server.submit_many(synthetic_requests(3, d=D))
        bad = server.submit(np.zeros((D + 1,), np.float32))
        for f in good:
            assert np.asarray(f.result(timeout=WAIT_S)).shape == (D,)
        with pytest.raises(Exception):
            bad.result(timeout=WAIT_S)
        assert server.stats()["failures"] == 1


def test_stop_without_drain_fails_queued_requests():
    server = serve(ScaleModel(1, delay_s=0.2), max_wait_ms=1.0).start()
    futures = server.submit_many(synthetic_requests(12, d=D))
    server.stop(drain=False)
    settled = 0
    for f in futures:
        try:
            f.result(timeout=5)
            settled += 1
        except (ServerClosed, RequestShed):
            settled += 1
    assert settled == 12  # every future resolves one way or the other


def test_two_model_registry_keeps_metric_series_distinct():
    from keystone_tpu_torch.obs import metrics, names

    requests_metric = metrics.get_registry().counter(names.SERVING_REQUESTS, labels=("model",))
    alpha0 = requests_metric.value(model="alpha")
    beta0 = requests_metric.value(model="beta")
    registry = ModelRegistry()
    registry.publish("alpha", ScaleModel(2))
    registry.publish("beta", ScaleModel(5))
    with PipelineServer(
        config=ServingConfig(max_batch=8, max_wait_ms=2.0), registry=registry,
        name="alpha", device=CPU,
    ) as server:
        payloads = synthetic_requests(9, d=D)
        futures = [server.submit(p, model="alpha") for p in payloads[:5]]
        futures += [server.submit(p, model="beta") for p in payloads[5:]]
        results = [f.result(timeout=WAIT_S) for f in futures]
        stats = server.stats()
    for x, y in zip(payloads[:5], results[:5]):
        np.testing.assert_allclose(np.asarray(y), x * 2, rtol=1e-6)
    for x, y in zip(payloads[5:], results[5:]):
        np.testing.assert_allclose(np.asarray(y), x * 5, rtol=1e-6)
    assert requests_metric.value(model="alpha") == alpha0 + 5
    assert requests_metric.value(model="beta") == beta0 + 4
    latency = metrics.get_registry().get(names.SERVING_LATENCY_SECONDS)
    assert latency.count(model="alpha") >= 5 and latency.count(model="beta") >= 4
    assert stats["served"] == 9
    assert stats["per_model"]["alpha"]["served"] == 5
    assert stats["per_model"]["beta"]["served"] == 4


def test_request_spans_reparent_under_the_submitters_trace():
    from keystone_tpu_torch.obs import spans

    with spans.tracing_session("serve-test") as session:
        with serve(synthetic_fitted_pipeline(d=D, device=CPU)) as server:
            with spans.span("client") as client:
                futures = server.submit_many(synthetic_requests(3, d=D))
            for f in futures:
                f.result(timeout=WAIT_S)
    requests = session.find("serve:request")
    assert len(requests) == 3
    assert {s.parent_id for s in requests} == {client.span_id}
    assert session.find("serve:batch")


def test_server_and_warmup_without_a_device_raise_when_no_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "fp.pt")
    synthetic_fitted_pipeline(d=D, device=CPU).save(path)
    for entry_point in (
        lambda: PipelineServer(ScaleModel(1)),
        lambda: synthetic_fitted_pipeline(d=D),
        lambda: ModelRegistry().load_fitted("m", path),
        lambda: warm_buckets(lambda ds: ds, np.zeros(D, np.float32), (1,)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry_point()


# ------------------------------------------------------- parity with the JAX server


def _serve_both(j_model, t_model, payloads, max_batch=8):
    from keystone_tpu.serving import PipelineServer as JServer
    from keystone_tpu.serving import ServingConfig as JConfig

    with JServer(j_model, config=JConfig(max_batch=max_batch, max_wait_ms=5.0)) as server:
        want = [np.asarray(f.result(timeout=WAIT_S)) for f in server.submit_many(payloads)]
    config = ServingConfig(max_batch=max_batch, max_wait_ms=5.0)
    with PipelineServer(t_model, config=config, device=CPU) as server:
        got = [np.asarray(f.result(timeout=WAIT_S)) for f in server.submit_many(payloads)]
    return np.stack(got), np.stack(want)


def test_synthetic_pipeline_served_rows_match_jax_server():
    from keystone_tpu.serving.synthetic import synthetic_fitted_pipeline as j_synthetic

    payloads = synthetic_requests(64, d=64)
    got, want = _serve_both(
        j_synthetic(d=64, depth=2, seed=0),
        synthetic_fitted_pipeline(d=64, depth=2, seed=0, device=CPU),
        payloads,
    )
    assert got.shape == want.shape == (64, 64)
    assert _rel(got, want) <= SERVE_TOL


def test_jax_fitted_mnist_pipeline_serves_equal_labels():
    from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JEstimator
    from keystone_tpu.ops.stats import core as jcore
    from keystone_tpu.ops.util.labels import ClassLabelIndicators as JIndicators
    from keystone_tpu.ops.util.labels import MaxClassifier as JMax
    from keystone_tpu.pipelines import mnist_random_fft as jm
    from keystone_tpu.workflow.pipeline import FittedPipeline as JFitted
    from keystone_tpu_torch.convert import mnist_pipeline_from_numpy

    cfg = jm.MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=10.0)
    train, test = jm.synthetic_mnist(1024, seed=0), jm.synthetic_mnist(256, seed=1)
    featurizer = jm.build_featurizer(cfg)
    model = JEstimator(cfg.block_size, num_iter=1, reg=cfg.reg).fit(
        featurizer(train.data).get(), JIndicators(10)(train.labels).get()
    )
    j_pipe = featurizer >> model >> JMax()
    j_fitted = JFitted(j_pipe.graph, j_pipe.source, j_pipe.sink)
    signs = [np.asarray(jcore.RandomSignNode.create(784, seed=cfg.seed + i).signs)
             for i in range(cfg.num_ffts)]
    carried = mnist_pipeline_from_numpy(
        signs, np.asarray(model.weights), model.block_size,
        intercept=np.asarray(model.intercept), feature_mean=np.asarray(model.feature_mean),
        device=CPU,
    )
    x = np.asarray(test.data.data)[:64]
    got, want = _serve_both(j_fitted, carried, list(x), max_batch=16)
    direct = np.asarray(j_pipe(JArrayDataset(x)).get().data)[:64]
    np.testing.assert_array_equal(want, direct)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------------- CLI


def _serve_cli(args, stdin="", env_extra=None):
    return subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "serve", *args],
        input=stdin, capture_output=True, text=True, timeout=60, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})},
    )


def test_serve_cli_synthetic_roundtrip():
    lines = [json.dumps({"id": i, "x": [float(i)] * 16}) for i in range(20)]
    # Malformed payloads answer with an error line, not kill the stream.
    lines += [json.dumps({"id": 98, "x": "abc"}), json.dumps({"id": 97, "x": None})]
    proc = _serve_cli(["--synthetic", "16", "--device", "cpu", "--max-batch", "4",
                       "--max-wait-ms", "5"], "\n".join(lines))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = [l for l in proc.stdout.splitlines() if l.strip()]
    assert out[-1].startswith("SERVE_STATS:")
    stats = json.loads(out[-1][len("SERVE_STATS:"):])
    by_id = {r["id"]: r for r in map(json.loads, out[:-1])}
    assert set(by_id) == set(range(20)) | {97, 98}
    want = synthetic_fitted_pipeline(d=16, device=CPU).apply_batch(
        ArrayDataset(np.array([[float(i)] * 16 for i in range(20)], np.float32), device=CPU)
    ).data.numpy()
    for i in range(20):
        assert "error" not in by_id[i] and by_id[i]["latency_ms"] >= 0
        np.testing.assert_allclose(by_id[i]["y"], want[i], rtol=1e-5, atol=1e-6)
    assert "bad payload" in by_id[98]["error"] and "bad payload" in by_id[97]["error"]
    assert stats["served"] == 20 and stats["sheds"] == 0 and stats["failures"] == 0
    assert stats["models"]["default"]["source"] == "synthetic:d=16"
    assert "cufft_plans_since_warmup" not in stats


@pytest.mark.parametrize(
    "args,status,message",
    [
        (["--synthetic", "4", "--device", "cpu", "--workers", "2"], 2, "item 13"),
        (["--synthetic", "4", "--device", "cpu", "--listen", "localhost:0"], 2, "item 13"),
        (["--checkpoint-dir", "x", "--digest", "y", "--device", "cpu"], 2, "item 12"),
        (["--synthetic", "4"], 1, "device='cpu'"),
    ],
)
def test_serve_cli_refuses_what_is_not_ported(args, status, message):
    proc = _serve_cli(args)
    assert proc.returncode == status and message in proc.stderr, proc.stderr[-2000:]
    assert "SERVE_STATS" not in proc.stdout
