"""The quality plane and the flight recorder in the port
(``keystone_tpu_torch/obs/quality.py``, ``obs/flight.py``, copies of the
JAX package's stdlib-only modules) — parity on the same score sequences
and mirrors of ``tests/obs/test_quality.py`` and ``tests/obs/test_flight.py``.

Both packages run the same pure-Python arithmetic, so the bounds are
exact: identical decisions, sample counts, likelihood ratios and drift
scores.
"""

import json
import random

import pytest

from keystone_tpu.obs import quality as jq
from keystone_tpu_torch.obs import quality as tq
from keystone_tpu_torch.obs import spans
from keystone_tpu_torch.obs.flight import get_flight_recorder, install_flight_recorder, reset_flight_recorder
from keystone_tpu_torch.reliability import faultinject
from keystone_tpu_torch.reliability.recovery import get_recovery_log, reset_recovery_log


@pytest.fixture(autouse=True)
def _fresh():
    tq.reset_quality_plane()
    jq.reset_quality_plane()
    reset_flight_recorder()
    reset_recovery_log()
    yield
    tq.reset_quality_plane()
    jq.reset_quality_plane()
    reset_flight_recorder()


def _pairs(seed, n, cand_mean, base_mean=1.0, std=0.1):
    rng = random.Random(seed)
    return [(rng.gauss(cand_mean, std), rng.gauss(base_mean, std)) for _ in range(n)]


GATE_CASES = [
    # (seed, n, candidate mean, gate kwargs)
    (7, 400, 1.0, {"alpha": 0.05, "max_samples": 10_000}),
    (8, 400, 0.7, {"alpha": 0.05}),
    (9, 200, 1.0, {"alpha": 0.05, "min_samples": 8, "max_samples": 40}),
    (10, 300, 1.3, {"alpha": 0.05}),
    (11, 300, 0.95, {"alpha": 0.01, "max_samples": 256}),
    (12, 64, 0.0, {"alpha": 0.05, "min_samples": 24, "max_samples": 64}),
]


@pytest.mark.parametrize("seed,n,mean,kwargs", GATE_CASES)
def test_sequential_gate_decisions_equal_the_jax_packages(seed, n, mean, kwargs):
    mine, theirs = tq.SequentialGate("m", **kwargs), jq.SequentialGate("m", **kwargs)
    for cand, base in _pairs(seed, n, mean):
        assert mine.observe(candidate=cand, baseline=base) == theirs.observe(candidate=cand, baseline=base)
    assert mine.decision == theirs.decision
    assert mine.samples == theirs.samples
    assert mine.evidence() == theirs.evidence()


def test_sequential_gate_detects_a_regression_and_is_sticky():
    gate = tq.SequentialGate("m", alpha=0.05)
    verdict, n = "continue", 0
    for cand, base in _pairs(8, 400, 0.7):
        n += 1
        verdict = gate.observe(candidate=cand, baseline=base)
        if verdict != "continue":
            break
    assert verdict == "rollback" and n < 200
    assert gate.observe(candidate=2.0, baseline=0.0) == "rollback"


DRIFT_CASES = [
    # (baseline mean, shifted means in windows)
    (1.0, [0.7, 1.0, 0.5]),
    (1.0, [1.0, 1.02, 0.98]),
    (0.5, [0.9, 0.9, 0.1]),
]


@pytest.mark.parametrize("base,windows", DRIFT_CASES)
def test_drift_detector_decisions_equal_the_jax_packages(base, windows):
    mine = tq.DriftDetector(threshold=0.5, min_count=32, floor=0.5)
    theirs = jq.DriftDetector(threshold=0.5, min_count=32, floor=0.5)
    rng = random.Random(10)
    for _ in range(64):
        v = rng.gauss(base, 0.1)
        mine.observe(v)
        theirs.observe(v)
    mine.freeze_baseline()
    theirs.freeze_baseline()
    for i, mean in enumerate(windows):
        mine.current = type(mine.current)()
        theirs.current = type(theirs.current)()
        for _ in range(64 + 16 * i):
            v = rng.gauss(mean, 0.1)
            mine.observe(v)
            theirs.observe(v)
        assert (mine.check() is None) == (theirs.check() is None)
        assert mine.drift_score() == theirs.drift_score()
        assert mine.suggested_decay(1.0) == theirs.suggested_decay(1.0)
    assert mine.events == theirs.events


def test_plane_label_join_and_state_restore_equal_the_jax_packages():
    scores = [float(i % 3 == 0) for i in range(100)]
    mine, theirs = tq.get_quality_plane(), jq.get_quality_plane()
    assert mine.join_labels("m", scores) == theirs.join_labels("m", scores)
    assert mine.state("m") == theirs.state("m")
    saved = json.loads(json.dumps(mine.state("m")))
    tq.reset_quality_plane()
    tq.get_quality_plane().restore("m", saved)
    assert tq.get_quality_plane().state("m") == theirs.state("m")


def test_score_stream_state_roundtrip():
    stream = tq.ScoreStream()
    for v in [random.Random(3).gauss(0, 1) for _ in range(500)]:
        stream.observe(v)
    back = tq.ScoreStream.from_state(json.loads(json.dumps(stream.to_state())))
    assert back.to_state() == stream.to_state() and back.summary() == stream.summary()
    theirs = jq.ScoreStream.from_state(json.loads(json.dumps(stream.to_state())))
    assert theirs.summary() == stream.summary()


# --------------------------------------------------------- flight recorder


def test_ledger_hook_rings_and_bounds(tmp_path):
    recorder = install_flight_recorder("test", capacity=8, out_dir=str(tmp_path))
    assert get_flight_recorder() is recorder
    assert install_flight_recorder("other") is recorder  # the first role wins
    for i in range(20):
        get_recovery_log().record("retry", f"op-{i}", attempt=i)
    with recorder._lock:
        ring = list(recorder._ledger)
    assert len(ring) == 8 and ring[-1]["label"] == "op-19" and ring[0]["label"] == "op-12"
    assert not list(tmp_path.glob("flightrec-*.json"))  # a benign kind does not dump


def test_fault_probe_trigger_dumps_artifact_with_span_tail(tmp_path):
    install_flight_recorder("w0", out_dir=str(tmp_path))
    with spans.tracing_session("t"):
        with spans.span("serving-ish"):
            pass
        with faultinject.injected(faultinject.FaultSpec(match="serving.apply", kind="transient", calls=(1,))):
            with pytest.raises(ConnectionError):
                faultinject.probe("serving.apply")
    (artifact,) = tmp_path.glob("flightrec-w0-*.json")
    payload = json.loads(artifact.read_text())
    assert payload["trigger"] == "fault_probe" and payload["role"] == "w0"
    assert any(s["n"] == "serving-ish" and s["b"] >= s["a"] for s in payload["spans"])
    assert payload["ledger"][-1]["kind"] == "fault" and payload["perf_ledger"] == []


def test_refit_rollback_triggers_and_dumps_are_rate_limited(tmp_path):
    recorder = install_flight_recorder("refit", out_dir=str(tmp_path), min_dump_interval_s=3600)
    get_recovery_log().record("refit_rollback", "demo", reason="x")
    get_recovery_log().record("refit_rollback", "demo", reason="y")
    assert [d["trigger"] for d in recorder.dumps] == ["refit_rollback"]
    assert recorder.dump("manual", force=True) is not None


def test_hook_is_noop_without_recorder(tmp_path):
    assert get_flight_recorder() is None
    get_recovery_log().record("fault", "x")
    assert not list(tmp_path.glob("flightrec-*.json"))
