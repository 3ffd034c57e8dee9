"""The port's copies of the reliability and observability modules the
serving layer uses: mirrors of ``tests/reliability/test_retry.py`` and
``test_degrade.py``, the classification of a CUDA out-of-memory error,
fault injection, and ``percentile`` parity with the JAX package."""

import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import metrics, names
from keystone_tpu_torch.reliability import (
    KNOWN_PROBE_SITES,
    CorruptRecordError,
    Deadline,
    DeadlineExceeded,
    DegradationLadder,
    ErrorClass,
    FaultSpec,
    InjectedOOM,
    LadderExhausted,
    RetryPolicy,
    classify_error,
    get_recovery_log,
    halving_rungs,
    injected,
    is_oom,
    probe,
    run_with_deadline,
    wait_until,
)
from keystone_tpu_torch.workflow.executor import PipelineEnv


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()  # clears the port's recovery ledger too
    yield
    PipelineEnv.reset()


@pytest.fixture
def no_sleep_policy():
    """A RetryPolicy that never really sleeps but records what it would
    have slept."""
    slept = []
    return RetryPolicy(max_attempts=3, seed=0, sleep=slept.append), slept


# ------------------------------------------------------------ classification


@pytest.mark.parametrize(
    "exc,expected",
    [
        (RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating 1.2G"), ErrorClass.OOM),
        (ValueError("XLA allocation failure: Out of memory"), ErrorClass.OOM),
        (MemoryError(), ErrorClass.OOM),
        (RuntimeError("UNAVAILABLE: socket closed"), ErrorClass.TRANSIENT),
        (RuntimeError("coordinator heartbeat missed"), ErrorClass.TRANSIENT),
        (RuntimeError("worker preempted by scheduler"), ErrorClass.TRANSIENT),
        (ConnectionResetError("peer reset"), ErrorClass.TRANSIENT),
        (TimeoutError("no response"), ErrorClass.TRANSIENT),
        (DeadlineExceeded("node: deadline"), ErrorClass.DEADLINE),
        (RuntimeError("DEADLINE_EXCEEDED: rpc"), ErrorClass.DEADLINE),
        (CorruptRecordError("bad jpeg"), ErrorClass.CORRUPT_DATA),
        (RuntimeError("DATA_LOSS: truncated record"), ErrorClass.CORRUPT_DATA),
        (ValueError("block size 12 not divisible"), ErrorClass.PERMANENT),
        (TypeError("estimator dependencies must be datasets"), ErrorClass.PERMANENT),
        (FileNotFoundError("no archive(s) at /x"), ErrorClass.PERMANENT),
        (OSError("stale NFS file handle"), ErrorClass.TRANSIENT),
        (KeyError("label"), ErrorClass.PERMANENT),
    ],
)
def test_classification_table(exc, expected):
    assert classify_error(exc) is expected


def test_cuda_out_of_memory_classifies_as_oom():
    exc = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB total capacity)"
    )
    assert classify_error(exc) is ErrorClass.OOM and is_oom(exc)


def test_message_pattern_wins_over_type():
    assert classify_error(ValueError("RESOURCE_EXHAUSTED while compiling")) is ErrorClass.OOM


def test_classification_matches_the_jax_package():
    from keystone_tpu.reliability.errors import CLASSIFICATION_TABLE as JTABLE
    from keystone_tpu_torch.reliability.errors import CLASSIFICATION_TABLE

    assert [(c.value, p) for c, p in CLASSIFICATION_TABLE] == [(c.value, p) for c, p in JTABLE]


# ------------------------------------------------------------------- backoff


def test_backoff_schedule_is_deterministic_per_seed():
    p = RetryPolicy(max_attempts=5, base_delay_s=0.1, multiplier=2.0, seed=42)
    assert p.backoff_schedule() == p.backoff_schedule()
    assert p.backoff_schedule() != RetryPolicy(
        max_attempts=5, base_delay_s=0.1, multiplier=2.0, seed=43
    ).backoff_schedule()
    for i, d in enumerate(p.backoff_schedule()):
        nominal = 0.1 * 2.0**i
        assert nominal * (1 - p.jitter) <= d <= nominal * (1 + p.jitter)


def test_backoff_schedule_matches_the_jax_package():
    from keystone_tpu.reliability.retry import RetryPolicy as JPolicy

    kw = dict(max_attempts=6, base_delay_s=0.05, multiplier=3.0, max_delay_s=2.0, seed=7)
    assert RetryPolicy(**kw).backoff_schedule() == JPolicy(**kw).backoff_schedule()


def test_backoff_respects_max_delay():
    p = RetryPolicy(max_attempts=10, base_delay_s=1.0, multiplier=10.0,
                    max_delay_s=3.0, jitter=0.0, seed=0)
    assert p.backoff_schedule() == [1.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]


def test_call_sleeps_the_published_schedule(no_sleep_policy):
    policy, slept = no_sleep_policy
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("UNAVAILABLE: relay hiccup")
        return "ok"

    assert policy.call(flaky, label="flaky") == "ok"
    assert slept == policy.backoff_schedule()[: len(slept)]
    assert len(calls) == 3
    retries = get_recovery_log().events("retry")
    assert len(retries) == 2 and retries[-1].detail["error_class"] == "transient"
    counter = metrics.get_registry().get(names.RELIABILITY_EVENTS)
    assert counter.value(kind="retry") >= 2


def test_call_never_retries_permanent(no_sleep_policy):
    policy, slept = no_sleep_policy
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("bad shape")

    with pytest.raises(ValueError):
        policy.call(broken)
    assert len(calls) == 1 and slept == []


def test_call_never_retries_oom_by_default(no_sleep_policy):
    policy, slept = no_sleep_policy
    with pytest.raises(torch.cuda.OutOfMemoryError):
        policy.call(lambda: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("CUDA out of memory")))
    assert slept == []


def test_call_gives_up_after_max_attempts(no_sleep_policy):
    policy, slept = no_sleep_policy
    calls = []

    def always_down():
        calls.append(1)
        raise ConnectionError("UNAVAILABLE")

    with pytest.raises(ConnectionError):
        policy.call(always_down)
    assert len(calls) == policy.max_attempts
    assert len(slept) == policy.max_attempts - 1


# ----------------------------------------------------------------- deadlines


def test_run_with_deadline_passes_result_and_errors():
    assert run_with_deadline(lambda: 7, 5.0) == 7
    with pytest.raises(ValueError, match="inner"):
        run_with_deadline(lambda: (_ for _ in ()).throw(ValueError("inner")), 5.0)


def test_run_with_deadline_times_out():
    with pytest.raises(DeadlineExceeded, match="hung-node"):
        run_with_deadline(lambda: time.sleep(2.0), 0.1, label="hung-node")


def test_policy_deadline_recovers_hang():
    attempts = []

    def hangs_once():
        attempts.append(1)
        if len(attempts) == 1:
            time.sleep(2.0)
        return "late but fine"

    policy = RetryPolicy(max_attempts=2, deadline_s=0.2, sleep=lambda s: None)
    assert policy.call(hangs_once, label="hang") == "late but fine"
    assert len(attempts) == 2


def test_wait_until_polls_then_deadline():
    state = {"n": 0}

    def pred():
        state["n"] += 1
        return state["n"] >= 3

    assert wait_until(pred, Deadline.after(5.0), interval=0.0, sleep=lambda s: None)
    with pytest.raises(DeadlineExceeded, match="coordinator"):
        wait_until(lambda: False, Deadline.after(0.05), interval=0.01, label="coordinator")


def test_call_stops_retrying_past_the_deadline():
    fake_now = [100.0]
    slept = []
    policy = RetryPolicy(
        max_attempts=5, base_delay_s=1.0, multiplier=1.0, jitter=0.0, seed=0,
        sleep=lambda s: (slept.append(s), fake_now.__setitem__(0, fake_now[0] + s)),
    )
    deadline = Deadline(2.5, clock=lambda: fake_now[0])

    def always_transient():
        raise ConnectionError("UNAVAILABLE: flaky")

    with pytest.raises(ConnectionError):
        policy.call(always_transient, label="bounded", deadline=deadline)
    assert slept == [1.0, 1.0]
    abandoned = get_recovery_log().events("retry_abandoned")
    assert abandoned and abandoned[-1].detail["attempt"] == 3


def test_call_with_roomy_deadline_retries_normally():
    policy = RetryPolicy(max_attempts=3, base_delay_s=0.001, jitter=0.0, seed=0)
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise ConnectionError("UNAVAILABLE: flaky")
        return "ok"

    assert policy.call(flaky, deadline=Deadline(30.0)) == "ok"
    assert attempts["n"] == 3


# ------------------------------------------------------------------- ladders


def _oom():
    raise RuntimeError("RESOURCE_EXHAUSTED: fake OOM")


def test_halving_rungs_match_bench_timit_exact():
    full_n, ndev = 2_200_000, 8
    rungs = halving_rungs(full_n - full_n % ndev, full_n // 16, align=ndev)
    assert rungs[0] == 2_200_000 and all(v % ndev == 0 for v in rungs)
    assert rungs[-1] <= full_n // 16 < rungs[-2]
    expect, n = [n0 := full_n - full_n % ndev], n0
    while n > full_n // 16:
        n = (n // 2) - ((n // 2) % ndev)
        expect.append(n)
    assert rungs == expect


def test_halving_rungs_match_bench_cifar_and_wide_block():
    assert halving_rungs(50_000, 50_000 // 4) == [50_000, 25_000, 12_500]
    wide = halving_rungs(2_200_000, 8_192)
    assert wide[0] == 2_200_000 and wide[-1] <= 8_192 < wide[-2]
    assert halving_rungs(8_192, 8_192) == [8_192]


def test_ladder_degrades_on_oom_and_annotates():
    ladder = DegradationLadder([64, 32, 16], label="t")
    tried = []

    def attempt(b):
        tried.append(b)
        if b > 16:
            _oom()
        return {"block": b}

    out = ladder.annotate(ladder.run(attempt))
    assert tried == [64, 32, 16] and ladder.reduced
    assert out["extrapolated"] is True and out["reduced_from"] == 64
    assert "RESOURCE_EXHAUSTED" in out["reduction_reason"]
    ev = get_recovery_log().events("degrade")
    assert len(ev) == 1 and ev[0].detail["rung"] == 16


def test_ladder_degrades_on_cuda_oom():
    def attempt(b):
        if b > 8:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB")
        return b

    assert DegradationLadder([32, 16, 8], label="t").run(attempt) == 8


def test_ladder_success_on_first_rung_adds_no_fields():
    ladder = DegradationLadder([64, 32], label="t")
    out = ladder.annotate(ladder.run(lambda b: {"block": b}))
    assert not ladder.reduced
    assert "extrapolated" not in out and "reduced_from" not in out
    assert get_recovery_log().events("degrade") == []


def test_ladder_reraises_non_oom_immediately():
    ladder = DegradationLadder([64, 32], label="t")
    tried = []

    def attempt(b):
        tried.append(b)
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        ladder.run(attempt)
    assert tried == [64]


def test_ladder_exhaustion_keeps_last_error():
    with pytest.raises(LadderExhausted, match="RESOURCE_EXHAUSTED"):
        DegradationLadder([8, 4], label="solver").run(lambda b: _oom())
    assert isinstance(LadderExhausted("x"), RuntimeError)


def test_ladder_on_degrade_hook_and_last_error():
    seen = []
    ladder = DegradationLadder(
        [2, 1], label="t", on_degrade=lambda rung, err: seen.append((rung, err))
    )

    def attempt(b):
        if b == 2:
            _oom()
        assert "RESOURCE_EXHAUSTED" in ladder.last_error  # visible mid-run
        return b

    assert ladder.run(attempt) == 1
    assert seen == [(2, "RuntimeError: RESOURCE_EXHAUSTED: fake OOM")]


def test_ladder_rejects_empty_rungs():
    with pytest.raises(ValueError, match="empty rung"):
        DegradationLadder([], label="t")


# ------------------------------------------------------------ fault injection


def test_probe_is_a_no_op_without_an_injector():
    probe("serving.apply")
    assert "serving.apply" in KNOWN_PROBE_SITES


def test_injected_faults_fire_on_the_named_calls_only():
    with injected(FaultSpec(match="serving.apply", kind="oom", calls=(2,))) as injector:
        probe("serving.apply")
        with pytest.raises(InjectedOOM):
            probe("serving.apply")
        probe("serving.apply")
        probe("elsewhere")
        assert injector.calls("serving.apply") == 3
        with pytest.raises(RuntimeError, match="no nesting"):
            with injected():
                pass
    assert [e.detail["call_number"] for e in get_recovery_log().events("fault")] == [2]
    probe("serving.apply")  # the injector is gone with its block


def test_hang_fault_sleeps_through_the_injected_clock():
    slept = []
    with injected(FaultSpec(match="*", kind="hang", hang_s=7.0), sleep=slept.append):
        probe("anything")
    assert slept == [7.0]


def test_corrupt_fault_poisons_tensors_and_arrays_keeping_the_dataset_type():
    dataset = ArrayDataset((torch.ones(2, 3), torch.arange(2)), device="cpu")
    with injected(FaultSpec(match="apply", kind="corrupt", first_n=2)) as injector:
        out = injector.wrap("apply", lambda: dataset)()
        arr = injector.wrap("apply", lambda: np.ones(3, np.float32))()
    assert isinstance(out, ArrayDataset) and out.num_examples == 2
    assert torch.isnan(out.data[0]).all() and torch.equal(out.data[1], torch.arange(2))
    assert torch.equal(dataset.data[0], torch.ones(2, 3))  # the original is untouched
    assert np.isnan(arr).all()


# --------------------------------------------------------------- percentiles


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_matches_the_jax_package(seed):
    from keystone_tpu.obs.metrics import percentile as j_percentile
    from keystone_tpu_torch.obs.metrics import percentile

    samples = np.random.default_rng(seed).exponential(size=37 + seed).tolist()
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert percentile(samples, q) == j_percentile(samples, q)


def test_histogram_window_percentile_and_schema_metric():
    registry = metrics.MetricsRegistry()
    hist = names.metric(names.SERVING_BATCH_OCCUPANCY, registry)
    for v in (0.25, 0.5, 1.0):
        hist.observe(v, model="m")
    assert hist.buckets == metrics.RATIO_BUCKETS
    assert hist.percentile(50, model="m") == 0.5 and hist.count(model="m") == 3
    assert registry.snapshot()[f"{names.SERVING_BATCH_OCCUPANCY}_count{{model=m}}"] == 3.0
    names.metric(names.SERVING_REQUESTS, registry).inc(model="m")
    assert registry.names() == sorted([names.SERVING_BATCH_OCCUPANCY, names.SERVING_REQUESTS])
