"""Runs of the real cells at a tiny size on the CPU: the plain reference
agrees with the port, the control (TF32 products) does not, and a run
without a card fails instead of falling back to the CPU."""

import json
import subprocess
import sys

import pytest
import torch

from kbench.harness.checks import passed, score_gap
from kbench.harness.layout import KBENCH_DIR
from kbench.tests.tiny import TinyLayout, tiny_run

ROOT = KBENCH_DIR.parent


@pytest.mark.parametrize("cell", ["timit.fit", "cifar.fit", "cifar.serve"])
def test_reference_agrees_with_the_port(cell):
    run = tiny_run(cell)
    assert run.attempted >= 1 and run.failed == 0
    gaps = {k: v for k, v in run.readings.items() if k.endswith("_score_gap")}
    assert gaps and all(v < 2e-5 for v in gaps.values()), gaps
    assert run.readings.get("unanswered_requests", 0) == 0


@pytest.mark.parametrize("cell", ["timit.fit", "cifar.fit"])
def test_control_separates_from_the_port(cell):
    layout = TinyLayout()
    found = layout.cell(cell)
    config = found.config
    system, reference = layout.module("systems", config["name"]), layout.module("reference", config["name"])
    seed = 12345
    data = system.make_data(config, seed, torch.device("cpu"))
    sets = system.eval_sets(config, data, seed)
    want = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "fp64", "cpu")
    ieee = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "fp32", "cpu")
    tf32 = reference.fit_and_score(config, system.fit_inputs(data), sets, seed, "tf32", "cpu")
    for name in sets:
        assert score_gap(tf32[name], want[name]) > 10 * score_gap(ieee[name], want[name])


def test_traced_run_reads_its_program_metrics():
    run = tiny_run("timit.fit", traced=True)
    from kbench.harness.runner import metrics_of

    metrics = metrics_of(run)
    assert set(metrics) >= {"featurizer_build_s.fit", "executor_outside_share.fit"}
    assert 0 <= metrics["executor_outside_share.fit"]["value"] <= 100
    assert run.trace is not None and run.trace.window_s > 0
    # No card, no device metric: nothing is read from a CPU run under a
    # device metric's name.
    assert not {"fit_mfu", "gemm_roofline.fit", "device_idle_share.fit"} & set(metrics)


def test_result_line_shape():
    from kbench.harness.runner import report

    run = tiny_run("cifar.serve")
    import io

    out, err = io.StringIO(), io.StringIO()
    assert report(run, out, err) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"serve_p95_ms", "setup_s"}
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    assert line["correct"] == passed(line["checks"])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is for machines without one")
    out = subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", "timit.fit", "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_no_program_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    cannot run: the port is missing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(KBENCH_DIR, tmp_path / "kbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", "timit.fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert out.returncode != 0 and "{" not in out.stdout
