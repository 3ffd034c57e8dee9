"""Continuous refit in the port (``keystone_tpu_torch/refit/``, the
server's tap hook, state persistence, the ``refit`` CLI) on the CPU —
mirrors of the one-device cases of ``tests/refit/test_{state,tap,publish,
journal,daemon}.py``, plus parity with the JAX package.

Bounds:

- ``run_refit_demo`` at the CLI's defaults: the same outcome sequence,
  publish/rollback/skip counts, state rows and ledger kinds as the JAX
  package's; every accuracy within 2 rows' worth (2 / evaluated rows) of
  the JAX run's, since one row's argmax may flip at fp32;
- a JAX-captured state carried through ``convert.stream_state_from_numpy``
  and finished in the port (and after one port round of the daemon)
  against the JAX package's finish of the same statistics: ≤ 1e-5
  relative.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinear
from keystone_tpu.refit.state import stream_state_key as j_stream_state_key
from keystone_tpu.workflow.streaming import ChunkStream as JChunkStream
from keystone_tpu_torch.convert import stream_state_from_numpy
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs.flight import reset_flight_recorder
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator, LinearMapper
from keystone_tpu_torch.refit.daemon import RefitConfig, RefitDaemon, RefitDemoConfig, run_refit_demo
from keystone_tpu_torch.refit.publish import InProcessPublisher
from keystone_tpu_torch.refit.shadow import ShadowEvaluator
from keystone_tpu_torch.refit.state import (
    FORMAT_VERSION,
    StreamState,
    load_stream_state,
    save_stream_state,
    stream_state_key,
)
from keystone_tpu_torch.refit.tap import TrafficTap
from keystone_tpu_torch.reliability import faultinject
from keystone_tpu_torch.reliability.checkpoint import CheckpointStore
from keystone_tpu_torch.reliability.faultinject import FaultSpec
from keystone_tpu_torch.reliability.recovery import get_recovery_log
from keystone_tpu_torch.serving.config import ServingConfig
from keystone_tpu_torch.serving.server import PipelineServer
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.streaming import ChunkStream
from keystone_tpu_torch.workflow.verify import (
    UNKNOWN,
    VerificationError,
    _apply_out_spec,
    verify_refit_publish,
)
from torch_lock_witness import _port_lock_witness  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
D, K = 8, 3
W_TRUE = np.random.default_rng(3).standard_normal((D, K)).astype(np.float32)


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_flight_recorder()
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()
    reset_flight_recorder()


def make_rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[np.argmax(x @ W_TRUE, axis=1)]
    return x, y


def stream(x, y, chunk_rows=128):
    return ChunkStream(ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"), (),
                       chunk_rows=chunk_rows, device=CPU)


def rel_err(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


# ------------------------------------------------------------------ state


@pytest.mark.parametrize("name", ["refit-state", "demo", "", "ünïcode/with spaces", "x" * 200])
def test_stream_state_key_is_byte_equal_to_the_jax_packages(name):
    assert stream_state_key(name) == j_stream_state_key(name)


def test_state_save_load_roundtrip_and_misses(tmp_path):
    store = CheckpointStore(str(tmp_path), device="cpu")
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    est.fit_stream(stream(*make_rows(512, 0)))
    state = est.export_stream_state()
    assert save_stream_state(store, "s", state)
    back = load_stream_state(store, "s")
    assert back.kind == "gram" and back.num_examples == 512
    for a, b in zip(back.carry, state.carry):
        np.testing.assert_array_equal(a, b)
    assert load_stream_state(store, "other") is None
    future = StreamState("gram", "x", 1, (np.zeros(1),), format_version=FORMAT_VERSION + 1)
    save_stream_state(store, "future", future)
    assert load_stream_state(store, "future") is None  # unknown layout: a miss


def test_jax_captured_state_seeds_the_daemon_and_finishes_to_the_jax_weights(tmp_path):
    x0, y0 = make_rows(512, 0)
    jest = JLinear(reg=1e-2)
    jest.fit_stream(JChunkStream(JArrayDataset(x0), JArrayDataset(y0), (), chunk_rows=128))
    jstate = jest.export_stream_state()
    state = stream_state_from_numpy(
        jstate.kind, [np.asarray(a) for a in jstate.carry], jstate.num_examples, jstate.meta,
        estimator=jstate.estimator,
    )
    assert state.estimator == jstate.estimator
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    model = est.finish_from_state(state)
    jmodel = jest.finish_from_state(jstate)
    assert rel_err(model.weights.numpy(), np.asarray(jmodel.weights)) <= 1e-5
    # One daemon round extends it exactly as the JAX package's fold does.
    server = PipelineServer(model=model, config=ServingConfig(max_batch=4, queue_depth=64),
                            name="m", device="cpu").start()
    try:
        tap = TrafficTap(capacity_rows=4096)
        daemon = RefitDaemon(est, tap, InProcessPublisher(server, name="m"), state=state,
                             shadow=ShadowEvaluator(margin=1.0),
                             config=RefitConfig(name="m", min_rows=64, chunk_rows=128, state_decay=1.0))
        x1, y1 = make_rows(512, 1)
        tap.feed(x1, y1)
        assert daemon.run_once() == "published"
    finally:
        server.stop()
    jextended = jest.fit_stream(
        JChunkStream(JArrayDataset(x1[:384]), JArrayDataset(y1[:384]), (), chunk_rows=128), state=jstate
    )
    assert daemon.state_rows() == 512 + 384
    assert rel_err(daemon.last_candidate.weights.numpy(), np.asarray(jextended.weights)) <= 1e-5


# -------------------------------------------------------------------- tap


def test_feed_drain_roundtrip_oldest_first():
    tap = TrafficTap(capacity_rows=100)
    for i in range(5):
        tap.feed(np.full((2, 3), i, np.float32), np.full((2, 1), i, np.float32))
    x, y = tap.drain(4)
    assert x[:, 0].tolist() == [0, 0, 1, 1] and tap.depth() == 6


def test_bound_drops_oldest_and_counts():
    tap = TrafficTap(capacity_rows=4)
    assert tap.feed(np.arange(6, dtype=np.float32)[:, None], np.zeros(6, np.float32)) == 4
    x, _ = tap.drain()
    assert x[:, 0].tolist() == [2, 3, 4, 5]
    assert tap.stats()["dropped"] == 2


def test_drain_drops_minority_shapes_instead_of_requeueing():
    tap = TrafficTap()
    tap.feed(np.zeros((3, 4), np.float32), np.zeros((3, 1), np.float32))
    tap.feed(np.zeros((1, 5), np.float32), np.zeros((1, 1), np.float32))
    x, _ = tap.drain()
    assert x.shape == (3, 4) and tap.depth() == 0 and tap.stats()["dropped"] == 1


def test_tensor_payloads_are_kept_as_host_arrays_and_sampled():
    tap = TrafficTap(mirror_rows=4, sample_every=2)
    kept = [tap.observe(torch.full((3,), float(i))) for i in range(8)]
    assert kept == [False, True] * 4
    mirror = tap.mirror()
    assert isinstance(mirror, np.ndarray) and mirror[:, 0].tolist() == [1, 3, 5, 7]
    tap.feed(torch.ones(2, 3), torch.zeros(2, 1))
    assert isinstance(tap.drain()[0], np.ndarray)


def test_server_offers_settled_payloads_and_a_failing_tap_fails_nothing():
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    model = est.fit_stream(stream(*make_rows(256, 0)))

    class BrokenTap:
        def observe_batch(self, payloads):
            raise RuntimeError("tap bug")

    for tap in (TrafficTap(), BrokenTap()):
        server = PipelineServer(model=model, config=ServingConfig(max_batch=4, queue_depth=64),
                                name="m", device="cpu", tap=tap).start()
        try:
            futures = server.submit_many([np.ones(D, np.float32) * i for i in range(10)])
            assert all(f.exception(timeout=30) is None for f in futures)
        finally:
            server.stop()
        if isinstance(tap, TrafficTap):
            assert tap.stats()["mirrored"] == 10


# ---------------------------------------------------------------- publish


def _served(model, name="m"):
    server = PipelineServer(model=model, config=ServingConfig(max_batch=4, queue_depth=64),
                            name=name, device="cpu").start()
    server.warmup(np.zeros((D,), np.float32))
    return server


def test_publish_then_rollback_is_o1_and_ledgered():
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    v1 = est.fit_stream(stream(*make_rows(256, 0)))
    v2 = est.fit_stream(stream(*make_rows(256, 1)))
    server = _served(v1)
    try:
        pub = InProcessPublisher(server, name="m", example=np.zeros((D,), np.float32))
        ticket = pub.publish(v2, round_index=1)
        assert pub.current_model() is v2 and ticket.prev_version == 1 and ticket.version == 2
        pub.rollback(ticket, reason="test")
        assert pub.current_model() is v1
        kinds = [e.kind for e in get_recovery_log().events()]
        assert kinds.count("refit_publish") == 1 and kinds.count("refit_rollback") == 1
    finally:
        server.stop()


def test_kv305_flags_a_width_drifted_candidate_and_is_not_unknown():
    w = torch.randn(D, K)
    incumbent = LinearMapper(w)
    drifted = LinearMapper(torch.randn(D, K + 1))
    example = np.zeros((D,), np.float32)
    assert _apply_out_spec(incumbent, example) == ("arrays", repr(((K,), "torch.float32")))
    assert _apply_out_spec(drifted, example) is not UNKNOWN
    report = verify_refit_publish(drifted, incumbent, example=example)
    (diag,) = report.errors()
    assert diag.code == "KV305" and "candidate_spec" in diag.details
    assert verify_refit_publish(LinearMapper(w * 2), incumbent, example=example).ok


def test_kv305_flags_unwarmed_buckets():
    report = verify_refit_publish(None, None, buckets=[1, 2, 4, 8], warmed_buckets=[1, 2])
    (diag,) = report.errors()
    assert diag.code == "KV305" and diag.details["missing"] == [4, 8]


def test_kv305_strict_mode_refuses_publish(monkeypatch):
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    v1 = est.fit_stream(stream(*make_rows(256, 0)))
    server = _served(v1)
    try:
        pub = InProcessPublisher(server, name="m", example=np.zeros((D,), np.float32))
        monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
        with pytest.raises(VerificationError, match="KV305"):
            pub.publish(LinearMapper(torch.randn(D, K + 1)))
        assert pub.current_model() is v1
        monkeypatch.setenv("KEYSTONE_VERIFY", "warn")
        pub.publish(LinearMapper(torch.randn(D, K + 1)))  # warn: logged, published
    finally:
        server.stop()


# ------------------------------------------------------------- the daemon


def _loop(tmp_path, **config):
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    model = est.fit_stream(stream(*make_rows(512, 0)))
    server = _served(model)
    tap = TrafficTap(capacity_rows=4096)
    store = CheckpointStore(str(tmp_path / "store"), device="cpu")
    if load_stream_state(store, "refit-state") is None:
        save_stream_state(store, "refit-state", est.export_stream_state())
    daemon = RefitDaemon(
        est, tap, InProcessPublisher(server, name="m", example=np.zeros((D,), np.float32)),
        store=store, shadow=ShadowEvaluator(margin=0.5),
        config=RefitConfig(name="m", min_rows=64, chunk_rows=128, **config),
    )
    return server, tap, daemon


def test_run_once_outcomes(tmp_path):
    server, tap, daemon = _loop(tmp_path)
    try:
        assert daemon.run_once() == "skipped_nodata"
        tap.feed(*make_rows(512, 1))
        assert daemon.run_once() == "published"
        assert daemon.state_rows() == 512 + 384
        last = daemon.outcomes[-1]
        assert last["fold_s"] > 0 and last["state_bytes"] > 0 and last["state_save_s"] >= 0
    finally:
        server.stop()


def test_watch_window_rolls_back_corrupted_candidate(tmp_path):
    from keystone_tpu_torch.refit.daemon import _corrupt_mapper

    server, tap, daemon = _loop(tmp_path, watch_margin=0.05)
    try:
        tap.feed(*make_rows(512, 1))
        with faultinject.injected(FaultSpec(match="refit.candidate", kind="corrupt", calls=(1,),
                                            corrupt=_corrupt_mapper)):
            assert daemon.run_once() == "rolled_back"
        assert "refit_rollback" in {e.kind for e in get_recovery_log().events()}
        assert list((tmp_path / "flight").glob("flightrec-refit-*.json"))  # post-mortem dumped
    finally:
        server.stop()


def test_kill_mid_fold_resumes_from_journal_not_the_tap(tmp_path):
    server, tap, daemon = _loop(tmp_path)
    try:
        base = daemon.state_rows()
        tap.feed(*make_rows(512, 1))
        with pytest.raises(ConnectionError):
            with faultinject.injected(FaultSpec(match="refit.fold", kind="transient", calls=(1,))):
                daemon.run_once()
        assert tap.depth() == 0 and daemon._load_journal() is not None
        daemon2 = RefitDaemon(daemon.estimator, tap, daemon.publisher, store=daemon.store,
                              shadow=ShadowEvaluator(margin=0.5),
                              config=RefitConfig(name="m", min_rows=64, chunk_rows=128))
        assert daemon2.run_once() == "published"
        assert daemon2._load_journal() is None
        assert daemon2.state_rows() == base + 384  # exactly once
        assert "refit_journal_resume" in {e.kind for e in get_recovery_log().events()}
    finally:
        server.stop()


def test_poisoned_journal_discarded_after_replay_budget(tmp_path):
    server, tap, daemon = _loop(tmp_path, max_journal_replays=2)
    try:
        tap.feed(*make_rows(512, 1))
        with faultinject.injected(FaultSpec(match="refit.fold", kind="transient", first_n=3)):
            for _ in range(3):
                with pytest.raises(ConnectionError):
                    daemon.run_once()
        assert daemon.run_once() == "skipped_nodata"  # budget spent: discarded
        assert "refit_journal_discard" in {e.kind for e in get_recovery_log().events()}
    finally:
        server.stop()


def test_supervised_loop_runs_rounds_and_stops(tmp_path):
    server, tap, daemon = _loop(tmp_path, interval_s=0.01)
    try:
        tap.feed(*make_rows(512, 1))
        daemon.start()
        for _ in range(500):
            if daemon.outcomes:
                break
            import time

            time.sleep(0.01)
        daemon.stop()
        assert daemon.outcomes and daemon.outcomes[0]["outcome"] == "published"
    finally:
        server.stop()


@pytest.mark.parametrize("shards", [8])
def test_daemon_folds_under_a_partition_as_the_jax_package_does(shards):
    """``RefitDaemon(partition=)`` hands the decision to its round's fold:
    the round runs the sharded chunk plan (8 CPU shards, seeded by a
    JAX-captured state) and extends the weights as the JAX package's
    fold on its 8 virtual devices does."""
    from keystone_tpu_torch.parallel.mesh import make_mesh
    from keystone_tpu_torch.parallel.partitioner import Partitioner
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    x0, y0 = make_rows(512, 0)
    jest = JLinear(reg=1e-2)
    jest.fit_stream(JChunkStream(JArrayDataset(x0), JArrayDataset(y0), (), chunk_rows=128))
    jstate = jest.export_stream_state()
    state = stream_state_from_numpy(
        jstate.kind, [np.asarray(a) for a in jstate.carry], jstate.num_examples, jstate.meta,
        estimator=jstate.estimator,
    )
    decision = Partitioner(mesh=make_mesh(devices=["cpu"] * shards)).decide_stream(
        "refit", 128, rows=384, record=False
    )
    assert decision.eligible and decision.shards == shards
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    server = PipelineServer(model=est.finish_from_state(state), config=ServingConfig(max_batch=4, queue_depth=64),
                            name="m", device="cpu").start()
    try:
        tap = TrafficTap(capacity_rows=4096)
        daemon = RefitDaemon(est, tap, InProcessPublisher(server, name="m"), state=state,
                             shadow=ShadowEvaluator(margin=1.0), partition=decision,
                             config=RefitConfig(name="m", min_rows=64, chunk_rows=128, state_decay=1.0))
        x1, y1 = make_rows(512, 1)
        tap.feed(x1, y1)
        assert daemon.run_once() == "published"
        assert last_stream_report().shards == shards
    finally:
        server.stop()
    from keystone_tpu.parallel.partitioner import Partitioner as JPartitioner
    from keystone_tpu.workflow.streaming import last_stream_report as j_last_stream_report

    jdecision = JPartitioner().decide_stream("refit", 128, rows=384, record=False)
    jextended = jest.fit_stream(
        JChunkStream(JArrayDataset(x1[:384]), JArrayDataset(y1[:384]), (), chunk_rows=128, partition=jdecision),
        state=jstate,
    )
    assert j_last_stream_report().shards == shards
    assert daemon.state_rows() == 512 + 384
    assert rel_err(daemon.last_candidate.weights.numpy(), np.asarray(jextended.weights)) <= 1e-5


def test_daemon_takes_a_scheduler():
    from keystone_tpu_torch.sched import MeshScheduler

    scheduler = MeshScheduler(device="cpu")
    daemon = RefitDaemon(LinearMapEstimator(device="cpu"), TrafficTap(), object(), scheduler=scheduler)
    assert daemon.scheduler is scheduler
    # An empty tap skips before asking for a lease.
    assert daemon.run_once() == "skipped_nodata" and scheduler.stats()["leases"] == 0


# ---------------------------------------------------------------- the demo


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    from keystone_tpu.refit.daemon import RefitDemoConfig as JRefitDemoConfig
    from keystone_tpu.refit.daemon import run_refit_demo as j_run_refit_demo
    from keystone_tpu.reliability.recovery import reset_recovery_log as j_reset

    flight = tmp_path_factory.mktemp("flight")
    os.environ["KEYSTONE_FLIGHT_DIR"] = str(flight)
    # The JAX demo's server warmup would otherwise turn on JAX's persistent
    # compilation cache for the rest of the process, and with it off go
    # buffer donation on the CPU for later tests in the same worker.
    saved_cache = os.environ.get("KEYSTONE_COMPILATION_CACHE")
    os.environ["KEYSTONE_COMPILATION_CACHE"] = "off"
    try:
        j_reset()
        jax_out = j_run_refit_demo(JRefitDemoConfig(store_dir=str(tmp_path_factory.mktemp("j"))))
        PipelineEnv.reset()
        port_out = run_refit_demo(RefitDemoConfig(store_dir=str(tmp_path_factory.mktemp("t"))), device="cpu")
    finally:
        os.environ.pop("KEYSTONE_FLIGHT_DIR", None)
        if saved_cache is None:
            os.environ.pop("KEYSTONE_COMPILATION_CACHE", None)
        else:
            os.environ["KEYSTONE_COMPILATION_CACHE"] = saved_cache
        reset_flight_recorder()
    return jax_out, port_out


@pytest.mark.parametrize(
    "key", ["publishes", "rollbacks", "skips", "dropped", "state_rows", "ledger_kinds", "speedup_ok"]
)
def test_demo_counts_equal_the_jax_packages(demos, key):
    jax_out, port_out = demos
    assert port_out[key] == jax_out[key]


def test_demo_outcomes_and_accuracies_match_the_jax_package(demos):
    jax_out, port_out = demos
    assert [r["outcome"] for r in port_out["rounds"]] == [r["outcome"] for r in jax_out["rounds"]]
    for mine, theirs in zip(port_out["rounds"], jax_out["rounds"]):
        assert abs(mine["live_accuracy"] - theirs["live_accuracy"]) <= 2 / mine["rows"] + 1e-4
    for key in ("live_accuracy_final", "stale_v1_accuracy_final"):
        assert abs(port_out[key] - jax_out[key]) <= 2 / 2048 + 1e-4
    assert port_out["cufft_plans_since_warmup_post_settle"] == jax_out["compiles_steady_state_post_settle"] == 0


def test_demo_meets_the_smoke_invariants(demos):
    _, out = demos
    outcomes = [r["outcome"] for r in out["rounds"]]
    assert out["publishes"] >= 2 and out["rollbacks"] == 1 and out["skips"] >= 1 and out["dropped"] == 0
    assert outcomes[3] == "rolled_back"  # the bad round
    assert {"refit_publish", "refit_rollback", "refit_skip"} <= set(out["ledger_kinds"])
    assert out["live_accuracy_final"] > out["stale_v1_accuracy_final"] + 0.15
    assert all(r["state_bytes"] for r in out["rounds"] if r["fold_s"] is not None)


def test_refit_cli_runs_on_the_cpu_and_raises_without_a_card(tmp_path):
    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch", "refit", *args], cwd=REPO, capture_output=True,
            text=True, timeout=240, env={**os.environ, "KEYSTONE_FLIGHT_DIR": str(tmp_path)},
        )

    proc = cli("--device", "cpu", "--rounds", "3", "--store-dir", str(tmp_path / "s"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    stats = json.loads(proc.stdout.split("REFIT_STATS:", 1)[1])
    assert [r["outcome"] for r in stats["rounds"]] == ["published", "skipped_nodata", "published"]
    assert stats["device_counts"]["ell_launches"] == 0 and stats["device_counts"]["peak_device_bytes"] is None
    if not torch.cuda.is_available():
        proc = cli("--rounds", "1")
        assert proc.returncode != 0 and "device='cpu'" in proc.stderr
