"""The port's observability commands against the JAX package's on the CPU:
``bench-diff``, ``quality``, ``trace`` (stub workers) and ``profile``; and
the fleet trace's merge after the fleet stops.

- ``bench-diff``: the same verdicts and exit codes (or the same refusal)
  on each consecutive pair of the repo's ``BENCH_r0*.json``.
- ``quality``: the same ``QUALITY_STATS`` JSON on the same seeds.
- ``trace`` with the stub backend: the same processes and span names.
- The merge: workers whose every fragment-bearing beat comes after the
  requests still appear whole in the merged trace (their exit lines
  carry the fragments); a worker whose exit line never comes is named in
  ``fragments_missing``. No fixed wait anywhere.
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

from keystone_tpu.obs import benchdiff as jbench
from keystone_tpu.obs import quality_cli as jquality
from keystone_tpu_torch.obs import benchdiff as tbench
from keystone_tpu_torch.obs import quality_cli as tquality

REPO = Path(__file__).resolve().parents[1]
BENCHES = sorted(REPO.glob("BENCH_r0*.json"))


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = fn(*args)
        except Exception as exc:  # both packages must refuse alike
            return ("raised", type(exc).__name__, str(exc)), buf.getvalue()
    return ("rc", rc), buf.getvalue()


@pytest.mark.parametrize("pair", list(zip(BENCHES, BENCHES[1:])), ids=lambda p: f"{p[0].stem}-{p[1].stem}")
def test_bench_diff_rules_as_the_jax_package_does(pair):
    argv = ["--baseline", str(pair[0]), "--current", str(pair[1])]
    j_rc, j_out = _run(jbench.main, argv)
    t_rc, t_out = _run(tbench.main, argv)
    assert t_rc == j_rc
    j_verdict = [line for line in j_out.splitlines() if line.startswith("BENCH_DIFF_JSON:")]
    t_verdict = [line for line in t_out.splitlines() if line.startswith("BENCH_DIFF_JSON:")]
    assert t_verdict == j_verdict


def test_bench_diff_never_gates_timings_across_platforms(tmp_path):
    leg = {"fit_s": 1.0, "dropped": 0, "chunks": 8}
    base, slow = {"platform": "gpu", "leg": leg}, {"platform": "cpu", "leg": dict(leg, fit_s=9.0)}
    for name, body in (("base", base), ("slow", slow), ("slow_gpu", dict(slow, platform="gpu"))):
        (tmp_path / f"{name}.json").write_text(json.dumps(body))
    rc, out = _run(tbench.main, ["--baseline", str(tmp_path / "base.json"), "--current", str(tmp_path / "slow.json")])
    verdict = json.loads(out.split("BENCH_DIFF_JSON:", 1)[1].splitlines()[0])
    assert rc == ("rc", 0) and not verdict["timings_comparable"]
    rc, _ = _run(tbench.main, ["--baseline", str(tmp_path / "base.json"), "--current",
                               str(tmp_path / "slow_gpu.json")])
    assert rc == ("rc", 1)


def _quality_args(**kw):
    import argparse

    args = dict(rows=256, shift=0.0, seed=0, model="default", features=4, alpha=None, max_samples=None,
                labels=64, as_json=True)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("shift,seed", [(0.0, 0), (3.0, 0), (3.0, 7), (0.5, 3)])
def test_quality_decides_as_the_jax_package_does(shift, seed):
    j_rc, j_out = _run(jquality.quality_from_args, _quality_args(shift=shift, seed=seed))
    t_rc, t_out = _run(tquality.quality_from_args, _quality_args(shift=shift, seed=seed))
    assert t_rc == j_rc
    assert t_out.strip().splitlines()[-1] == j_out.strip().splitlines()[-1]
    if shift >= 3.0:
        assert t_rc == ("rc", 2) and json.loads(t_out.split("QUALITY_STATS:", 1)[1])["rollbacks"] == 1


def _trace(package, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", package, "trace", "--workers", "2", "--requests", "24", "--out-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    stats = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("TRACE_STATS:")][0].split(":", 1)[1])
    with open(stats["trace_path"]) as f:
        merged = json.load(f)
    names = {}
    for event in merged["traceEvents"]:
        if event.get("ph") == "X":
            role = merged["otherData"]["processes"][str(event["pid"])]
            names.setdefault(role, set()).add(event["name"])
    return stats, names


def test_trace_with_stub_workers_names_the_jax_packages_processes_and_spans(tmp_path):
    j_stats, j_names = _trace("keystone_tpu", tmp_path / "j")
    t_stats, t_names = _trace("keystone_tpu_torch", tmp_path / "t")
    assert sorted(t_stats["processes"].values()) == sorted(j_stats["processes"].values())
    assert sorted(t_names) == ["frontend", "worker0", "worker1"]
    assert t_names == j_names
    assert t_stats["errors"] == j_stats["errors"] == 0 and t_stats["fragments_missing"] == []


# -------------------------------------------------------------- the merge


def _stub_fleet(heartbeat_s):
    from keystone_tpu_torch.obs.fleet import FLEET_TRACE_ENV
    from keystone_tpu_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor

    return WorkerSupervisor(
        {"stub": {"delay_ms": 1}},
        SupervisorConfig(workers=2, heartbeat_s=heartbeat_s, hang_timeout_s=120.0),
        env={FLEET_TRACE_ENV: "1"},
    ).start()


def _roles_with_requests(merged):
    roles = set()
    for event in merged["traceEvents"]:
        if event.get("ph") == "X" and event["name"] == "worker:request":
            roles.add(merged["otherData"]["processes"][str(event["pid"])])
    return roles


def test_fleet_trace_holds_workers_whose_beats_come_too_late():
    """A 60 s heartbeat: after each worker's first beat (sent as it
    starts) none ships another while the fleet serves, so without the
    exit line's fragments the merged trace would hold no worker span."""
    fleet = _stub_fleet(heartbeat_s=60.0)
    try:
        fleet.wait_ready()
        futures = [fleet.submit([float(i)], key=str(i)) for i in range(16)]
        assert [f.result(timeout=60) for f in futures] == [[2.0 * i] for i in range(16)]
    finally:
        fleet.stop(drain=True)
    merged = fleet.fleet.merge(fragments_missing=fleet.fragments_missing())
    assert merged["otherData"]["fragments_missing"] == []
    assert _roles_with_requests(merged) == {"worker0", "worker1"}


def test_fleet_trace_names_a_worker_whose_exit_line_never_came():
    fleet = _stub_fleet(heartbeat_s=60.0)
    try:
        fleet.wait_ready()
        futures = [fleet.submit([float(i)], key=str(i)) for i in range(8)]
        [f.result(timeout=60) for f in futures]

        def kill(worker):  # the process dies before it can write its exit line
            worker.proc.kill()
            worker.proc.wait(30)

        fleet._shutdown_worker = kill
    finally:
        fleet.stop(drain=True)
    merged = fleet.fleet.merge(fragments_missing=fleet.fragments_missing())
    assert merged["otherData"]["fragments_missing"] == ["worker0", "worker1"]


# ------------------------------------------------------------------ profile


def test_profile_on_the_cpu_writes_a_nested_trace_and_memory_gauges(tmp_path, monkeypatch):
    from keystone_tpu_torch import cli
    from keystone_tpu_torch.obs import cost
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "ps.jsonl"))
    cost.set_roofline(cost.Roofline(1e11, 1e10, backend="cpu"))
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["profile", "--rows", "256", "--num-ffts", "1", "--block-size", "64",
                           "--serve-requests", "8", "--out-dir", str(tmp_path), "--device", "cpu"])
    finally:
        cost.reset_cost_observatory()
        PipelineEnv.reset()
    assert rc == 0
    summary = json.loads(buf.getvalue().split("PROFILE_JSON:", 1)[1].splitlines()[0])
    assert summary["device"] == "cpu" and summary["serve"]["errors"] == 0
    trace = json.loads((tmp_path / "profile_trace.json").read_text())
    spans = {e["args"]["span_id"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X" and "span_id" in e["args"]}

    def chain(event):
        out = []
        while event is not None:
            out.append(event["name"])
            event = spans.get(event["args"].get("parent_id"))
        return out

    chains = [chain(e) for e in spans.values() if e["name"] == "solver:fit"]
    assert any(c[-1] == "profile" and any(n.startswith("node:") for n in c) for c in chains)
    prom = (tmp_path / "profile_metrics.prom").read_text()
    for stage in ("fit", "apply", "serve"):
        line = [ln for ln in prom.splitlines() if ln.startswith(f'keystone_peak_memory_bytes{{stage="{stage}"')][0]
        assert float(line.rsplit(" ", 1)[1]) > 0
    assert "# TYPE keystone_cost_ledger_entries_total counter" in prom
