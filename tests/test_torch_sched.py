"""The port's co-scheduler (``keystone_tpu_torch/sched/``) and its lease
path through the streaming fold and the refit daemon, held to the JAX
package's on the CPU.

- Pricing: the same Gram-fold facts, prices and chunk geometry down the
  provenance ladder (store/tune, roofline, default).
- ``MeshScheduler``: the same admit / defer / preempt decisions, the same
  schedule log, and the same pressure-aware cadence.
- A leased fold preempted at a chunk boundary commits its cursor, and
  the resumed fold equals the uninterrupted one.
- The co-scheduled demo at a small size: the port's serial and
  co-scheduled final states ≤ 1e-6 apart, and the port's final state ≤
  1e-5 from the JAX package's.
"""

from dataclasses import astuple

import numpy as np
import pytest

from keystone_tpu.obs import cost as jcost
from keystone_tpu.obs import store as jstore
from keystone_tpu.reliability import recovery as jrecovery
from keystone_tpu.sched import pricing as jpricing
from keystone_tpu.sched import scheduler as jsched
from keystone_tpu_torch.obs import cost as tcost
from keystone_tpu_torch.obs import store as tstore
from keystone_tpu_torch.reliability import recovery as trecovery
from keystone_tpu_torch.sched import pricing as tpricing
from keystone_tpu_torch.sched import scheduler as tsched
from torch_lock_witness import _port_lock_witness  # noqa: F401 (autouse fixture)

PEAKS = (2.0e12, 1.0e11)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "profile-store.jsonl"))
    for var in ("KEYSTONE_SCHED", "KEYSTONE_SCHED_RESIDENCY_BYTES", "KEYSTONE_SCHED_DEFAULT_ROWS_PER_S"):
        monkeypatch.delenv(var, raising=False)
    jstore.set_store(None)
    tstore.set_store(None)
    jrecovery.reset_recovery_log()
    trecovery.reset_recovery_log()
    jcost.set_roofline(jcost.Roofline(*PEAKS, backend="cpu"))
    tcost.set_roofline(tcost.Roofline(*PEAKS, backend="cpu"))
    yield
    jcost.reset_cost_observatory()
    tcost.reset_cost_observatory()
    jstore.set_store(None)
    tstore.set_store(None)
    jsched.set_scheduler(None)
    tsched.set_scheduler(None)


GEOMETRIES = [(8192, 64, 4), (65536, 2048, 10), (1000, 1, 1), (0, 16, 2), (250_000, 512, 138)]


@pytest.mark.parametrize("rows,width,classes", GEOMETRIES)
def test_prices_equal_the_jax_packages(rows, width, classes):
    assert tpricing.gram_stream_facts(rows, width, classes) == jpricing.gram_stream_facts(rows, width, classes)
    t = tpricing.price_stream_fold(rows, width, classes)
    j = jpricing.price_stream_fold(rows, width, classes)
    assert astuple(t) == astuple(j) and t.source == "roofline"
    assert t.to_json() == j.to_json()
    assert tpricing.choose_chunk_rows(rows, width, classes) == jpricing.choose_chunk_rows(rows, width, classes)


def test_a_measured_rate_prices_before_the_roofline(tmp_path, monkeypatch):
    prices = []
    for name, store_mod, pricing in (("jax", jstore, jpricing), ("port", tstore, tpricing)):
        monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / f"{name}.jsonl"))
        store_mod.set_store(None)
        store = store_mod.get_store()
        store.record("stream:()" + ":cr1024", "n2^13", chunk_rows=1024, rows_per_s=4.0e5, prefetch_depth=3)
        store.record("stream:()" + ":cr2048", "n2^13", chunk_rows=2048, rows_per_s=6.0e5, source="tune",
                     prefetch_depth=2)
        prices.append((astuple(pricing.price_stream_fold(8192, 64, 4, store=store)),
                       pricing.choose_chunk_rows(8192, 64, 4, store=store)))
    assert prices[0] == prices[1]
    assert prices[1][0][1] == "tune" and prices[1][1] == (2048, 2, "tune")


def test_without_a_roofline_the_default_rate_prices(monkeypatch):
    monkeypatch.setattr(jcost, "get_roofline", lambda *a, **k: None)
    monkeypatch.setattr(tcost, "get_roofline", lambda *a, **k: None)
    monkeypatch.setenv("KEYSTONE_SCHED_DEFAULT_ROWS_PER_S", "125000")
    t, j = tpricing.price_stream_fold(50_000, 32, 2), jpricing.price_stream_fold(50_000, 32, 2)
    assert astuple(t) == astuple(j) and t.source == "default" and t.seconds == pytest.approx(0.4)


class _SLO:
    """An SLO controller stand-in: scripted headroom and rung."""

    class _Admission:
        rung_index = 0

    def __init__(self, headroom):
        self._headroom = list(headroom)
        self.admission = self._Admission()

    def headroom(self):
        return self._headroom.pop(0) if self._headroom else 1.0


def _clock():
    state = {"t": 100.0}

    def tick():
        state["t"] += 0.25
        return state["t"]

    return tick


def _scenario(mod):
    backlog = iter([0, 20, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0])
    sched = mod.MeshScheduler(
        slo=_SLO([0.9, 0.5, 0.1, 0.8, 0.9, 0.9, 0.05, 0.05, 0.9, 0.9]),
        backlog_fn=lambda: next(backlog, 0), clock=_clock(), name="m",
        sustain_checks=2, headroom_floor=0.25, backlog_limit=8,
    )
    trail = []
    for i in range(4):
        lease = sched.submit(mod.LeaseRequest(name=f"fold-{i}", rows=4096 * (i + 1), width=64, classes=4))
        trail.append((lease.id, lease.admitted, lease.state, lease.displaced_by, lease.price.source))
        if lease.admitted:
            yields = [lease.should_yield() for _ in range(3)]
            trail.append(tuple(yields))
            if any(yields):
                lease.mark_preempted(lease.boundary_checks)
            sched.release(lease)
    sched.seed_pressure_after(1)
    with sched.lease(mod.LeaseRequest(name="seeded", kind="tune_probe", rows=512, width=8, classes=2)) as lease:
        trail.append((lease is not None, lease.should_yield(), lease.should_yield(), lease.displaced_by))
    sched.seed_pressure_after(None)
    sched.force_pressure(True)
    deferred = sched.submit(mod.LeaseRequest(name="forced", rows=64, width=8, classes=2))
    trail.append((deferred.admitted, deferred.state, deferred.displaced_by))
    sched.force_pressure(None)
    schedule = [{k: v for k, v in e.items() if k not in ("measured_s", "ratio")} for e in sched.schedule()]
    stats = sched.stats()
    stats.pop("idle_harvest_s")
    return trail, schedule, stats


def test_mesh_scheduler_decides_as_the_jax_package_does():
    t, j = _scenario(tsched), _scenario(jsched)
    assert t == j
    outcomes = t[2]["outcomes"]
    assert outcomes["preempted"] == 2 and outcomes["deferred"] == 1 and outcomes["completed"] == 3
    assert t[0][-1] == (False, "deferred", "forced pressure (seeded)")


@pytest.mark.parametrize("pressure", [False, True])
def test_pressure_aware_interval_equals_the_jax_packages(pressure):
    for base in (0.5, 30.0):
        for fill in np.linspace(-0.2, 1.3, 16):
            assert tsched.pressure_aware_interval(base, fill, pressure) == jsched.pressure_aware_interval(
                base, fill, pressure
            )


def test_maybe_lease_is_a_no_op_without_a_scheduler(monkeypatch):
    with tsched.maybe_lease("x", "finish") as lease:
        assert lease is None
    scheduler = tsched.MeshScheduler(device="cpu")
    tsched.set_scheduler(scheduler)
    with tsched.maybe_lease("x", "finish", rows=10, width=4, classes=2) as lease:
        assert lease is not None and lease.admitted
    monkeypatch.setenv("KEYSTONE_SCHED", "off")
    assert tsched.get_scheduler() is None
    assert scheduler.stats()["outcomes"] == {"completed": 1}


# ------------------------------------------------------------- the lease path


class _YieldAfter:
    """A lease that yields at its ``n``-th chunk boundary."""

    def __init__(self, n):
        self.n, self.checks, self.preempted_at = n, 0, None

    def should_yield(self):
        self.checks += 1
        return self.checks >= self.n

    def mark_preempted(self, chunk_index):
        self.preempted_at = chunk_index


def test_a_preempted_fold_resumes_from_its_cursor_to_the_uninterrupted_fit(tmp_path):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.reliability.checkpoint import CheckpointStore
    from keystone_tpu_torch.reliability.durable import arm_durable_fold
    from keystone_tpu_torch.workflow.streaming import ChunkStream, last_stream_report

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2048, 16)).astype(np.float32)
    y = rng.standard_normal((2048, 3)).astype(np.float32)

    def stream():
        return ChunkStream(ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"), (),
                           chunk_rows=256, device="cpu")

    whole = LinearMapEstimator(reg=1e-2, device="cpu").fit_stream(stream())
    store = CheckpointStore(str(tmp_path / "ck"), device="cpu")
    first = stream()
    est = LinearMapEstimator(reg=1e-2, device="cpu")
    first.durable, resume = arm_durable_fold(first, est, store, ckpt_every=1)
    assert resume is None
    first.lease = _YieldAfter(3)
    est.fit_stream(first)
    report = last_stream_report()
    assert report.preempted_at_chunk == 3 == first.lease.preempted_at and report.chunks == 3
    again = stream()
    est2 = LinearMapEstimator(reg=1e-2, device="cpu")
    again.durable, resume = arm_durable_fold(again, est2, store, ckpt_every=1)
    assert resume is not None and again.durable.start_chunk == 3
    resumed = est2.fit_stream(again, state=resume)
    assert last_stream_report().resumed_from_chunk == 3
    np.testing.assert_allclose(resumed.weights.numpy(), whole.weights.numpy(), rtol=0, atol=1e-6)


def test_a_pressured_card_defers_the_round_and_keeps_the_rows(tmp_path):
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.refit.daemon import RefitConfig, RefitDaemon
    from keystone_tpu_torch.refit.tap import TrafficTap

    tap = TrafficTap(capacity_rows=4096)
    rng = np.random.default_rng(1)
    tap.feed(rng.standard_normal((1024, 8)).astype(np.float32), np.eye(2, dtype=np.float32)[rng.integers(0, 2, 1024)])
    scheduler = tsched.MeshScheduler(device="cpu")
    scheduler.force_pressure(True)
    daemon = RefitDaemon(LinearMapEstimator(device="cpu"), tap, object(), scheduler=scheduler,
                         config=RefitConfig(min_rows=256))
    assert daemon.run_once() == "deferred"
    assert tap.depth() == 1024 and daemon.outcomes[-1]["displaced_by"] == "forced pressure (seeded)"
    assert scheduler.stats()["outcomes"] == {"deferred": 1}


# ------------------------------------------------------------------ the demo


DEMO = dict(d=16, classes=3, rounds=3, rows_per_round=2048, chunk_rows=256, serve_requests=24, serve_rps=800.0)


def _capture_daemons(monkeypatch, module):
    made = []
    original = module.RefitDaemon

    class Recording(original):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(module, "RefitDaemon", Recording)
    return made


def test_cosched_demo_matches_its_serial_run_and_the_jax_package(tmp_path, monkeypatch):
    import keystone_tpu.refit.daemon as jdaemon
    import keystone_tpu_torch.refit.daemon as tdaemon
    from keystone_tpu.sched.demo import CoschedDemoConfig as JConfig
    from keystone_tpu.sched.demo import run_cosched_demo as j_run
    from keystone_tpu_torch.sched.demo import CoschedDemoConfig, run_cosched_demo

    j_daemons = _capture_daemons(monkeypatch, jdaemon)
    t_daemons = _capture_daemons(monkeypatch, tdaemon)
    j_ev = j_run(JConfig(store_dir=str(tmp_path / "j"), **DEMO))
    t_ev = run_cosched_demo(CoschedDemoConfig(store_dir=str(tmp_path / "t"), **DEMO), device="cpu")
    assert t_ev["dropped"] == 0 and t_ev["preemptions"] == 1 and t_ev["preempted_at_chunk"] is not None
    assert t_ev["parity_max_abs_diff"] <= 1e-6 and t_ev["parity_ok"]
    assert t_ev["publishes"] == j_ev["publishes"] and t_ev["deferred_rounds"] == j_ev["deferred_rounds"]
    assert t_ev["leases"] == j_ev["leases"] and t_ev["preempted_at_chunk"] == j_ev["preempted_at_chunk"]
    assert t_ev["ledger_kinds"] == j_ev["ledger_kinds"]
    assert [r["outcomes"] for r in t_ev["rounds"]] == [r["outcomes"] for r in j_ev["rounds"]]
    # The scheduled daemon is the first each demo builds.
    t_w = t_daemons[0].estimator.finish_from_state(t_daemons[0].state).weights.double().numpy()
    j_w = np.asarray(j_daemons[0].estimator.finish_from_state(j_daemons[0]._state).weights, np.float64)
    assert np.linalg.norm(t_w - j_w) <= 1e-5 * np.linalg.norm(j_w)


def test_explain_schedule_prints_the_lease_log(capsys, monkeypatch):
    import argparse

    import keystone_tpu_torch.sched.demo as demo
    from keystone_tpu_torch.workflow import explain

    real = demo.run_cosched_demo
    monkeypatch.setattr(demo, "run_cosched_demo",
                        lambda config, device=None: real(demo.CoschedDemoConfig(seed=config.seed, **DEMO),
                                                         device=device))
    args = argparse.Namespace(schedule=True, seed=0, out=None, as_json=False, device="cpu")
    assert explain.explain_from_args(args) == 0
    out = capsys.readouterr().out
    assert "cosched-1" in out and "preempted at chunk" in out and "parity_max_abs_diff" in out


def test_a_scheduled_fold_takes_the_roofline_chunk_when_asked():
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.refit.daemon import RefitConfig, RefitDaemon
    from keystone_tpu_torch.refit.tap import TrafficTap
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    rng = np.random.default_rng(2)
    x = rng.standard_normal((6000, 8)).astype(np.float32)
    y = rng.standard_normal((6000, 2)).astype(np.float32)
    scheduler = tsched.MeshScheduler(device="cpu")
    want = scheduler.chunk_rows_for(rows=6000, width=8, classes=2, default=256)[0]
    for auto, chunk in ((False, 256), (True, want)):
        daemon = RefitDaemon(LinearMapEstimator(device="cpu"), TrafficTap(), object(), scheduler=scheduler,
                             config=RefitConfig(chunk_rows=256, auto_chunk_rows=auto))
        daemon._fold(x, y)
        assert last_stream_report().chunk_rows == min(chunk, 6000)
    assert want != 256  # a memory-bound fold at this geometry takes larger chunks
