"""``python -m keystone_tpu_torch check`` on the CPU: the exit-code
contract (0 clean, 1 findings or error diagnostics, 2 nothing to do), the
JSON shape, and the zero-device-work report of ``--pipeline`` — held
against the JAX package's ``check`` on the same seeded plans."""

import json
import os
import subprocess
import sys
import textwrap
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

from keystone_tpu_torch.lint.check import check_from_args
from keystone_tpu_torch.workflow.executor import PipelineEnv

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset_port_pipeline_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def run_check(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "check", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=None if env is None else {**os.environ, **env},
    )


def _payload(proc):
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _args(**kw):
    base = dict(
        lint=None, concurrency=None, pipeline=None, input_spec=None, buckets=None,
        warmed_buckets=None, seed_mismatch=False, store_report=False, device="cpu", as_json=True,
    )
    base.update(kw)
    return Namespace(**base)


def _run_in_process(capsys, **kw):
    code = check_from_args(_args(**kw))
    return code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_check_without_flags_is_usage_error(capsys):
    assert check_from_args(_args(as_json=False)) == 2
    assert "nothing to do" in capsys.readouterr().out


def test_check_lint_and_concurrency_port_tree_one_payload():
    """KV5xx and KV6xx findings ride one --json payload (both clean on the
    port's tree), the lock graph is exported for the witness, and the
    static pass imported no backend."""
    proc = run_check("--lint", "--concurrency", "--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    payload = _payload(proc)
    assert payload["ok"] is True
    assert payload["lint"]["findings"] == [] and payload["concurrency"]["findings"] == []
    assert payload["concurrency"]["torch_free"] is True
    graph = payload["concurrency"]["lock_graph"]
    assert len(graph["locks"]) >= 40 and graph["edges"]


SEEDED_CONCURRENCY = textwrap.dedent(
    """
    import threading


    class Telemetry:
        def __init__(self):
            self._lock = threading.Lock()
            self._served = 0
            self._worker = threading.Thread(target=self._loop, daemon=True)

        def _loop(self):
            while True:
                self._served += 1

        def record(self):
            with self._lock:
                self._served += 1

        def snapshot(self):
            with self._lock:
                return self._served


    class Gate:
        def __init__(self, ledger: "Ledger"):
            self._lock = threading.Lock()
            self._ledger = ledger

        def poke(self):
            with self._lock:
                pass

        def admit(self):
            with self._lock:
                self._ledger.poke()


    class Ledger:
        def __init__(self, gate: Gate):
            self._lock = threading.Lock()
            self._gate = gate

        def poke(self):
            with self._lock:
                pass

        def settle(self):
            with self._lock:
                self._gate.poke()
    """
)


def test_check_concurrency_seeded_fixture_exits_1(tmp_path):
    """A seeded file (a lock-order cycle and an unlocked guarded write)
    exits 1 with KV601 and KV602, without importing torch — as the JAX
    package's check does on its own fixture."""
    seeded = tmp_path / "concurrency_seeded.py"
    seeded.write_text(SEEDED_CONCURRENCY)
    proc = run_check("--concurrency", str(seeded), "--json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    conc = _payload(proc)["concurrency"]
    assert {f["rule"] for f in conc["findings"]} == {"KV601", "KV602"}
    assert conc["torch_free"] is True
    jproc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu", "check", "--concurrency", str(seeded), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert jproc.returncode == 1
    jconc = _payload(jproc)["concurrency"]
    assert [(f["rule"], f["line"]) for f in conc["findings"]] == [(f["rule"], f["line"]) for f in jconc["findings"]]


def test_check_lint_seeded_file_exits_1(tmp_path, capsys):
    seeded = tmp_path / "seeded.py"
    seeded.write_text("import os\nknob = os.environ.get('KEYSTONE_SOMETHING')\n")
    code, payload = _run_in_process(capsys, lint=[str(seeded)])
    assert code == 1 and payload["ok"] is False
    assert [f["rule"] for f in payload["lint"]["findings"]] == ["KV501"]


ZERO = {"ell_launches": 0, "binding_calls": 0, "memory_allocated_delta": 0}


def test_check_pipeline_seeded_mismatch_and_cold_bucket(capsys):
    from keystone_tpu.lint.check import check_from_args as j_check_from_args

    code, payload = _run_in_process(
        capsys, pipeline="synthetic", seed_mismatch=True, buckets="8,32", warmed_buckets="8"
    )
    assert code == 1
    codes = [d["code"] for d in payload["pipeline"]["diagnostics"]]
    assert codes == ["KV101", "KV301"]
    assert payload["device_counts"] == ZERO
    assert payload["device_memory_bytes"] is None
    jcode = j_check_from_args(Namespace(**{k: v for k, v in vars(_args(
        pipeline="synthetic", seed_mismatch=True, buckets="8,32", warmed_buckets="8")).items() if k != "device"}))
    jpayload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcode == code
    assert [(d["code"], d["severity"]) for d in jpayload["pipeline"]["diagnostics"]
            if d["code"] not in ("KV203", "KV304")] == [
        (d["code"], d["severity"]) for d in payload["pipeline"]["diagnostics"]
    ]


def test_check_pipeline_clean_synthetic_passes(capsys):
    code, payload = _run_in_process(capsys, pipeline="synthetic", buckets="8,32", warmed_buckets="8,32")
    assert code == 0 and payload["pipeline"]["ok"] is True
    assert payload["device_counts"] == ZERO
    assert [n["spec"] for n in payload["pipeline"]["nodes"]] == ["(16, 64):float32"]


@pytest.fixture(scope="module")
def mnist_artifact(tmp_path_factory):
    """A small fitted MNIST random-FFT pipeline, saved: the artifact the
    ``check --pipeline PATH`` cases read."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.data.loaders.csv import LabeledData
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_pipeline

    rng = np.random.default_rng(0)
    train = LabeledData(
        labels=ArrayDataset(rng.integers(0, 10, 1024).astype(np.int32), device="cpu"),
        data=ArrayDataset(rng.standard_normal((1024, 784)).astype(np.float32), device="cpu"),
    )
    PipelineEnv.reset()
    fitted = build_pipeline(MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=1.0), train, device="cpu").fit()
    path = str(tmp_path_factory.mktemp("mnist") / "mnist.pt")
    fitted.save(path)
    PipelineEnv.reset()
    return path


@pytest.mark.parametrize(
    "extra,code,codes",
    [
        ([], 0, []),
        (["--warmed-buckets", "16"], 1, ["KV301"]),
        (["--warmed-buckets", "16,64", "--seed-mismatch"], 1, ["KV101", "KV101"]),
    ],
    ids=["clean", "cold-bucket", "seed-mismatch"],
)
def test_check_pipeline_artifact_exit_codes(mnist_artifact, extra, code, codes):
    """The saved MNIST plan at 16×784: clean with every bucket warmed,
    KV301 with one missing, KV101 at each of the two FFT branches with a
    783-wide request — and no launch, binding call or card byte in any of
    them. The branches run on ``meta``; the Gather and VectorCombiner have
    no ``out_spec`` (in the JAX package neither), so what follows them
    reads unknown."""
    args = ["--pipeline", mnist_artifact, "--input-spec", "16x784:float32", "--buckets", "16,64",
            "--device", "cpu", "--json"]
    if "--warmed-buckets" not in extra:
        args += ["--warmed-buckets", "16,64"]
    proc = run_check(*args, *extra)
    assert proc.returncode == code, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload = _payload(proc)
    errors = [d["code"] for d in payload["pipeline"]["diagnostics"] if d["severity"] == "error"]
    assert errors == codes
    assert payload["device_counts"] == ZERO
    if code == 0:
        branches = [n["spec"] for n in payload["pipeline"]["nodes"] if n["label"].startswith("Fused[Random")]
        assert branches == ["(16, 512):float32"] * 2


def test_check_store_report(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", "off")
    code, payload = _run_in_process(capsys, store_report=True)
    assert code == 0 and payload["store"] == {"enabled": False}
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "ps.jsonl"))
    code, payload = _run_in_process(capsys, store_report=True)
    assert code == 0 and payload["store"]["enabled"] is True and payload["store"]["tuned_keys"] == []


def test_check_pipeline_without_device_raises_when_no_cuda(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_from_args(_args(pipeline="synthetic", device=None))
