"""The port's cost observatory (``keystone_tpu_torch/obs/cost.py``) and
``obs/device.py``, held to the JAX package's on the CPU.

- ``Roofline`` predictions and placement equal the JAX package's to
  rel 1e-12 on the same peaks and facts, and the mixed-kind placement
  reduces to them for one kind.
- The drift sentinel raises the same alarms on the same series (exact).
- The launch sites' facts: 2·m·n·k FLOP and (m·k + k·n + m·n)·itemsize
  bytes a product; the ELL kernel's counts are the kernel table's bound
  counts (PERF.md).
- A traced fit with the observatory on lands one ledger entry per node,
  with facts on the solver's node; the flight dump carries them.
- ``explain`` reports the JAX package's structure, and with an injected
  roofline a node's roofline prediction is its facts over the peaks.
"""

import json

import numpy as np
import pytest
import torch

from keystone_tpu.obs import cost as jcost
from keystone_tpu.obs import store as jstore
from keystone_tpu_torch.obs import cost as tcost
from keystone_tpu_torch.obs import device as tdevice
from keystone_tpu_torch.obs import store as tstore
from keystone_tpu_torch.ops.cuda import blocksparse as tbs
from keystone_tpu_torch.ops.cuda import gemm as tgemm
from keystone_tpu_torch.workflow.executor import PipelineEnv

PEAKS = (4.5e11, 6.0e10)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A store file of this test's own (both packages read
    ``KEYSTONE_PROFILE_STORE``) and a fresh observatory in both."""
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "profile-store.jsonl"))
    for mod in (jcost, tcost):
        mod.reset_cost_observatory()
    jstore.set_store(None)
    tstore.set_store(None)
    PipelineEnv.reset()
    yield
    for mod in (jcost, tcost):
        mod.reset_cost_observatory()
        mod.set_cost_observatory(None)
    jstore.set_store(None)
    tstore.set_store(None)
    PipelineEnv.reset()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# ------------------------------------------------------------------ roofline


def test_roofline_predictions_and_placement_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    j = jcost.Roofline(*PEAKS, backend="cpu")
    t = tcost.Roofline(*PEAKS, backend="cpu")
    assert _rel(t.ridge_intensity, j.ridge_intensity) <= 1e-12
    for flops, nbytes in zip(10 ** rng.uniform(3, 13, 200), 10 ** rng.uniform(3, 12, 200)):
        assert _rel(t.predicted_seconds(flops, nbytes), j.predicted_seconds(flops, nbytes)) <= 1e-12
        intensity = flops / nbytes
        assert t.classify(intensity) == j.classify(intensity)
        # One kind at the fp32 roof: the mixed-kind placement is the JAX
        # package's classify and predicted_seconds.
        placement, floor = t.place({"ieee_fp32": flops}, nbytes)
        assert placement == j.classify(intensity)
        assert _rel(floor, j.predicted_seconds(flops, nbytes)) <= 1e-12
    for flops, nbytes in ((None, 1e6), (1e9, None), (None, None), (0.0, 5.0)):
        assert t.predicted_seconds(flops, nbytes) == j.predicted_seconds(flops, nbytes)
    assert t.classify(None) is None and j.classify(None) is None
    assert set(j.to_json()) <= set(t.to_json())


def test_products_are_priced_at_the_peak_of_their_kind():
    roof = tcost.Roofline(1e12, 1e11, peak_flops_by_kind={"ieee_fp32": 1e12, "tf32": 8e12, "bf16": 16e12})
    # A TF32 Gram at TF32's peak, never at the fp32 roof.
    placement, floor = roof.place({"tf32": 8e12}, 1e9)
    assert placement == "compute-bound" and floor == pytest.approx(1.0, rel=1e-12)
    placement, floor = roof.place({"tf32": 8e12, "ieee_fp32": 1e12, "bf16_inputs": 16e12}, 1e9)
    assert floor == pytest.approx(3.0, rel=1e-12)
    # The ELL kernel's fp32 FMAs are priced at the fp32 roof.
    assert roof.peak_for("ell_fp32") == 1e12 and roof.peak_for("fp64") == 1e12
    placement, floor = roof.place({"ieee_fp32": 1e9}, 1e12)
    assert placement == "memory-bound" and floor == pytest.approx(10.0, rel=1e-12)


def test_the_probe_measures_every_kind_and_the_store_carries_it(tmp_path):
    roof = tcost.get_roofline(device="cpu")
    assert roof.backend == "cpu" and roof.source == "probe"
    assert set(roof.peak_flops_by_kind) == set(tcost.PROBE_KINDS)
    assert all(v > 0 for v in roof.peak_flops_by_kind.values()) and roof.peak_bytes_per_s > 0
    assert roof.peak_flops_per_s == roof.peak_flops_by_kind["ieee_fp32"]
    tcost.set_roofline(None)
    again = tcost.get_roofline(device="cpu")
    assert again.source == "store" and again.peak_flops_by_kind == roof.peak_flops_by_kind
    keys = {k for k, _s, _m in tstore.get_store().entries(key_prefix="roofline:")}
    assert keys == {"roofline:cpu"}


# ------------------------------------------------------------------- harvest


def test_product_facts_count_each_operand_once():
    facts = tcost.harvest_cost_facts("gemm", "tf32", {"m": 64, "n": 32, "k": 128, "itemsize": 4})
    assert facts.flops == 2.0 * 64 * 32 * 128
    assert facts.bytes_accessed == (64 * 128 + 128 * 32 + 64 * 32) * 4 and facts.kind == "tf32"
    batched = tcost.harvest_cost_facts("gemm", "bf16", {"m": 8, "n": 4, "k": 16, "itemsize": 4, "batch": 3})
    assert batched.flops == 3 * 2.0 * 8 * 4 * 16
    assert tcost.harvest_cost_facts("nope", None, {}) is None
    assert tcost.harvest_cost_facts("gemm", "tf32", {"m": 1}) is None


def test_ell_launch_facts_are_the_kernel_tables_bound_counts():
    rng = np.random.RandomState(0)
    nbr, k, bm, bn, n = 12, 5, 4, 8, 7
    d_pad = 10 * bn
    counts = torch.from_numpy(rng.randint(0, k + 1, nbr).astype(np.int32))
    indices = torch.from_numpy(rng.randint(0, d_pad // bn, (nbr, k)).astype(np.int32))
    blocks = torch.from_numpy(rng.randn(nbr, k, bm, bn).astype(np.float32))
    b = torch.from_numpy(rng.randn(d_pad, n).astype(np.float32))
    frame = tcost.push_frame("node")
    try:
        tbs.ell_matmul(indices, blocks, b, counts)
        tbs.ell_matmul(indices, blocks, b)
    finally:
        tcost.pop_frame(frame)
    stored = int(counts.sum())
    with_counts = tcost.harvest_cost_facts(frame.notes[0].site, frame.notes[0].kind, frame.notes[0].shape)
    # chip_smoke.py's bound: stored indices, counts, stored blocks, b and
    # the output, each once; 2 × stored blocks × bm × bn × N FLOP.
    assert with_counts.flops == 2.0 * stored * bm * bn * n
    assert with_counts.bytes_accessed == (
        stored * 4 + nbr * 4 + stored * bm * bn * 4 + b.numel() * 4 + nbr * bm * n * 4
    )
    every_slot = tcost.harvest_cost_facts(frame.notes[1].site, frame.notes[1].kind, frame.notes[1].shape)
    assert every_slot.flops == 2.0 * nbr * k * bm * bn * n


def test_launch_sites_note_only_inside_a_frame():
    a = torch.randn(16, 8)
    tgemm.gemm(a, a.T, "ieee_fp32")
    assert tcost.current_frame() is None
    frame = tcost.push_frame("x")
    try:
        tgemm.gemm(a, a.T, "tf32")
        tgemm.gemm_tn_chunked(a, a, "bf16")
        tgemm.gemm_batched(a.reshape(2, 8, 8), a.reshape(2, 8, 8), "ieee_fp32")
    finally:
        tcost.pop_frame(frame)
    flops_by_kind, nbytes, sites = tcost._harvest_frame(frame)
    assert flops_by_kind == {"tf32": 2.0 * 16 * 16 * 8, "bf16": 2.0 * 8 * 8 * 16, "ieee_fp32": 2 * 2.0 * 8 * 8 * 8}
    assert sites["gemm:tf32"]["launches"] == 1 and nbytes > 0


# ------------------------------------------------------------------ sentinel


def _drive(mod, store_mod, monkeypatch, tmp_path, series, key="autocache:abc", shape="n2^10"):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "store.jsonl"))
    store_mod.set_store(None)
    store = store_mod.get_store()
    store.record(key, shape, run_time_s=0.01)
    sentinel = mod.DriftSentinel()
    prediction = mod.Prediction(model="autocache", key=key, shape=shape, seconds=0.01, calibrated=True)
    fired = []
    for measured in series:
        event = sentinel.observe("node", prediction, measured_s=measured)
        fired.append(None if event is None else (event["ratio"], event["stale_marked"]))
    rate = mod.Prediction(model="measured_knob", key="stream:x:cr64", shape=shape, rows_per_s=1e6, calibrated=True)
    store.record("stream:x:cr64", shape, rows_per_s=1e6)
    for achieved in (1e6, 2e5, 2e5, 2e5, 9e5):
        event = sentinel.observe("fold", rate, measured_rate=achieved)
        fired.append(None if event is None else (event["ratio"], event["stale_marked"]))
    return fired, store.lookup(key, shape, include_stale=True)


@pytest.mark.parametrize("series", [
    [0.01, 0.011, 0.05, 0.06, 0.012, 0.2, 0.2, 0.2],
    [0.02, 0.021, 0.019, 0.08, 0.003, 0.09, 0.1, 0.4],
])
def test_drift_sentinel_raises_the_jax_packages_alarms(tmp_path, monkeypatch, series):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j_fired, j_entry = _drive(jcost, jstore, monkeypatch, tmp_path / "j", series)
    t_fired, t_entry = _drive(tcost, tstore, monkeypatch, tmp_path / "t", series)
    assert t_fired == j_fired
    assert any(f is not None for f in t_fired)
    assert tstore.is_stale(t_entry) == jstore.is_stale(j_entry)
    assert t_entry.get("measured_wall_s") == j_entry.get("measured_wall_s")


# ------------------------------------------------------------ ledger, flight


def _small_fit():
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.serving.synthetic import SyntheticDense

    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 32)).astype(np.float32)
    y = rng.standard_normal((512, 3)).astype(np.float32)
    w = torch.from_numpy((rng.standard_normal((32, 32)) / 6).astype(np.float32))
    feat = SyntheticDense([w]).to_pipeline()
    return feat.then_label_estimator(
        BlockLeastSquaresEstimator(16, num_iter=1, reg=1e-2, device="cpu"),
        ArrayDataset(x, device="cpu"), ArrayDataset(y, device="cpu"),
    ), ArrayDataset(x[:64], device="cpu")


def test_a_fit_under_the_observatory_lands_facts_on_the_solver_node(tmp_path):
    from keystone_tpu_torch.obs.flight import FlightRecorder
    from keystone_tpu_torch.obs.spans import tracing_session

    tcost.set_roofline(tcost.Roofline(*PEAKS, backend="cpu"))
    tcost.set_cost_observatory(True)
    tcost.record_all_nodes(True)
    pipe, x_eval = _small_fit()
    cursor = tcost.get_ledger().cursor()
    with tracing_session("t"):
        pipe.apply(x_eval).get()
    entries = tcost.get_ledger().entries(cursor)
    by_node = {e.node: e for e in entries}
    fit = by_node["BlockLeastSquaresEstimator"]
    assert fit.flops and fit.bytes_accessed and fit.sites and fit.roofline in ("compute-bound", "memory-bound")
    assert fit.flops == sum(fit.flops_by_kind.values()) == sum(s["flops"] for s in fit.sites.values())
    placement, floor = tcost.Roofline(*PEAKS).place(fit.flops_by_kind, fit.bytes_accessed)
    assert fit.roofline == placement and fit.bound_frac == pytest.approx(floor / fit.seconds, rel=1e-4)
    assert fit.predicted_model == "roofline" and fit.predicted_s == pytest.approx(floor)
    dump = FlightRecorder("test", out_dir=str(tmp_path)).dump("test")
    with open(dump) as f:
        ledger = json.load(f)["perf_ledger"]
    assert any(e["node"] == "BlockLeastSquaresEstimator" and e.get("flops") for e in ledger)


def test_the_observatory_off_notes_nothing():
    pipe, x_eval = _small_fit()
    cursor = tcost.get_ledger().cursor()
    pipe.apply(x_eval).get()
    assert tcost.get_ledger().entries(cursor) == []


# ------------------------------------------------------------------- explain


def _explain_args(**overrides):
    import argparse

    args = dict(pipeline="synthetic", rows=1024, dim=32, classes=3, passes=2, seed_drift=0.0, seed=0,
                out=None, as_json=True, schedule=False, num_ffts=2, device="cpu")
    args.update(overrides)
    return argparse.Namespace(**args)


def test_explain_reports_the_jax_packages_structure(capsys):
    from keystone_tpu.workflow import explain as jexplain
    from keystone_tpu_torch.workflow import explain as texplain

    jcost.set_roofline(jcost.Roofline(*PEAKS, backend="cpu"))
    tcost.set_roofline(tcost.Roofline(*PEAKS, backend="cpu"))
    assert jexplain.explain_from_args(_explain_args(device=None)) == 0
    j_report = json.loads(capsys.readouterr().out.split("EXPLAIN_JSON:", 1)[1])
    assert texplain.explain_from_args(_explain_args()) == 0
    t_report = json.loads(capsys.readouterr().out.split("EXPLAIN_JSON:", 1)[1])
    assert set(j_report) <= set(t_report)
    assert t_report["passes"] == j_report["passes"] and t_report["harvest_compiles"] == 0
    assert set(j_report["store"]) == set(t_report["store"])
    assert set(j_report["roofline"]) <= set(t_report["roofline"])
    assert [n["node"] for n in t_report["nodes"]] == [n["node"] for n in j_report["nodes"]]
    for node in t_report["nodes"]:
        if node.get("predicted_model") == "roofline":
            _placement, floor = tcost.Roofline(*PEAKS).place(node["flops_by_kind"], node.get("bytes_accessed"))
            assert node["predicted_s"] == pytest.approx(floor, rel=1e-12)
    fit = [n for n in t_report["nodes"] if n["node"] == "BlockLeastSquaresEstimator"][0]
    assert fit["provenance"]["model"] == "autocache" and fit["provenance"]["store_key"].startswith("autocache:")


def test_explain_seeded_drift_marks_the_corrupted_entry_stale(capsys, monkeypatch):
    from keystone_tpu_torch.workflow import explain as texplain

    tcost.set_roofline(tcost.Roofline(*PEAKS, backend="cpu"))
    # A 100× corruption against the default 4× band: it fires however the
    # host's walls move.
    rc = texplain.explain_from_args(_explain_args(seed_drift=100.0, passes=2))
    report = json.loads(capsys.readouterr().out.split("EXPLAIN_JSON:", 1)[1])
    assert report["seeded_corruptions"] == 1
    assert rc == 2 and len(report["drift_events"]) == 1
    assert report["store"]["stale_entries"] == 1 and report["drift_events"][0]["stale_marked"]


# -------------------------------------------------------------------- device


def test_memory_snapshot_on_the_host_reads_rss_as_the_jax_package_does():
    snap = tdevice.memory_snapshot("cpu")
    assert snap["source"] == "rss" and snap["bytes_in_use"] > 0 and snap["peak_bytes_in_use"] > 0
    assert tdevice.memory_snapshot(None)["source"] == "rss"


def test_stage_memory_publishes_the_peak_gauge():
    from keystone_tpu_torch.obs import names

    with tdevice.stage_memory("unit", "cpu"):
        _ = torch.zeros(1024)
    assert names.metric(names.PEAK_MEMORY_BYTES).value(stage="unit", device="all") > 0


def test_device_annotations_follow_the_switch(monkeypatch):
    monkeypatch.setenv("KEYSTONE_DEVICE_ANNOTATIONS", "0")
    tdevice.set_device_annotations(None)
    assert not tdevice.annotations_enabled()
    tdevice.set_device_annotations(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tdevice.device_annotation("keystone/node/x"):
                torch.ones(4).sum()
        assert any(e.name == "keystone/node/x" for e in prof.events())
    finally:
        tdevice.set_device_annotations(None)
