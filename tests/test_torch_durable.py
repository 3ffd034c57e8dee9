"""Durable fits in the port (``keystone_tpu_torch/reliability/durable.py``,
the durable fold of ``workflow/streaming.py``, ``workflow/fitcmd.py``) on
the CPU: mid-stream checkpoints, crash-resume parity, KV306 stale-entry
refusal, geometry discards and the fingerprint rules — mirrors of the
one-device cases of ``tests/workflow/test_durable_stream.py``, plus
parity with the JAX package.

In-process, a transient fault at ``streaming.chunk`` aborts the fold and
``PipelineEnv.reset()`` stands in for the fresh process; the last tests
run the ``fit`` CLI in real processes, with a SIGKILL.

Bounds: a resumed fit against the uninterrupted one, 1e-6 relative (the
JAX test's bound; both fold the same chunks in the same order); the
port's fits against the JAX package's, 1e-5 relative; the sketched
solver's resumed fit against its uninterrupted one, 1e-5.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinear
from keystone_tpu.parallel.partitioner import partition_disabled
from keystone_tpu.reliability.durable import StreamCursor as JStreamCursor
from keystone_tpu.reliability.durable import stream_ckpt_chunks as j_stream_ckpt_chunks
from keystone_tpu.workflow.pipeline import BatchTransformer as JBatchTransformer
from keystone_tpu.workflow.verify import verify_stream_resume as j_verify_stream_resume
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.reliability import enable_checkpointing, faultinject
from keystone_tpu_torch.reliability import durable
from keystone_tpu_torch.reliability.durable import (
    StreamCursor,
    load_resume_entry,
    resume_key,
    stream_ckpt_chunks,
)
from keystone_tpu_torch.reliability.faultinject import FaultSpec
from keystone_tpu_torch.reliability.recovery import get_recovery_log
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import BatchTransformer
from keystone_tpu_torch.workflow.streaming import last_stream_report
from keystone_tpu_torch.workflow.verify import VerificationError, verify_stream_resume

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N, D, K, CHUNK = 512, 8, 2, 64  # 8 chunks
rng = np.random.default_rng(7)
X = rng.normal(size=(N, D)).astype(np.float32)
W = rng.normal(size=(D, K)).astype(np.float32)
Y = (X @ W + 0.01 * rng.normal(size=(N, K))).astype(np.float32)
PROBE = rng.normal(size=(32, D)).astype(np.float32)


class Scale(BatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    def apply_arrays(self, a):
        return a * self.c


class JScale(JBatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    def apply_arrays(self, a):
        return a * self.c


def build(x=X, y=Y, estimator=None):
    return Scale(2.0).to_pipeline().then_label_estimator(
        estimator or LinearMapEstimator(reg=1e-3, device="cpu"),
        ArrayDataset(x, device="cpu"),
        ArrayDataset(y, device="cpu"),
    )


def preds(fitted):
    return fitted.apply_batch(ArrayDataset(PROBE, device="cpu")).data.numpy()


def rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


@pytest.fixture()
def chunked(monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    monkeypatch.setenv("KEYSTONE_STREAM_CKPT_CHUNKS", "2")


@pytest.fixture()
def reference(chunked):
    """Uninterrupted predictions (no store attached)."""
    PipelineEnv.reset()
    out = preds(build().fit())
    PipelineEnv.reset()
    return out


def _crash_at(store_dir, call):
    """Run a durable fit that dies at streaming.chunk call ``call``."""
    PipelineEnv.reset()
    enable_checkpointing(str(store_dir), device="cpu")
    with pytest.raises(ConnectionError):
        with faultinject.injected(FaultSpec(match="streaming.chunk", kind="transient", calls=(call,))):
            build().fit()


# ----------------------------------------------------------- checkpoints


def test_mid_fit_checkpoints_commit_and_retire(tmp_path, chunked):
    store = enable_checkpointing(str(tmp_path), device="cpu")
    fitted = build().fit()
    report = last_stream_report()
    # 8 chunks, every 2 → commits before chunks 3, 5, 7.
    assert report.checkpoints == 3
    assert len(report.checkpoint_s) == len(report.checkpoint_bytes) == 3
    assert all(b > 0 for b in report.checkpoint_bytes)
    assert report.resumed_from_chunk is None
    kinds = [e.kind for e in get_recovery_log().events()]
    assert kinds.count("stream_checkpoint") == 3
    # A COMPLETED fit retires its resume entry.
    key = resume_key(LinearMapEstimator(reg=1e-3, device="cpu"), (Scale(2.0),), N)
    assert load_resume_entry(store, key) is None
    assert preds(fitted).shape == (32, K)


def test_checkpoint_off_path_untouched(tmp_path, chunked, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CKPT_CHUNKS", "0")
    enable_checkpointing(str(tmp_path), device="cpu")
    build().fit()
    report = last_stream_report()
    assert report.checkpoints == 0 and report.resumed_from_chunk is None
    assert not get_recovery_log().events("stream_checkpoint")


@pytest.mark.parametrize(
    "env,rows",
    [({"KEYSTONE_STREAM_CKPT_AUTO_ROWS": "1000"}, 999),
     ({"KEYSTONE_STREAM_CKPT_AUTO_ROWS": "1000"}, 1000),
     ({}, 1_048_576),
     ({"KEYSTONE_STREAM_CKPT_CHUNKS": "5"}, 10),
     ({"KEYSTONE_STREAM_CKPT_CHUNKS": "0"}, 10**9),
     ({"KEYSTONE_STREAM_CKPT_AUTO_EVERY": "7"}, 2_000_000)],
)
def test_auto_arm_cadence_matches_the_jax_package(monkeypatch, env, rows):
    for name in ("KEYSTONE_STREAM_CKPT_CHUNKS", "KEYSTONE_STREAM_CKPT_AUTO_ROWS", "KEYSTONE_STREAM_CKPT_AUTO_EVERY"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert stream_ckpt_chunks(rows) == j_stream_ckpt_chunks(rows)
    if not env and rows == 1_048_576:
        assert stream_ckpt_chunks(rows) == 32


# ---------------------------------------------------------- crash-resume


def test_crash_resume_parity(tmp_path, reference):
    _crash_at(tmp_path, call=5)  # commits at 2 and 4, dies at the 5th
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    fitted = build().fit()
    report = last_stream_report()
    assert report.resumed_from_chunk == 4 and report.reingested_chunks == 4 == report.chunks
    assert "stream_resume" in {e.kind for e in get_recovery_log().events()}
    assert rel_err(preds(fitted), reference) <= 1e-6


def test_resumed_fit_equals_the_jax_packages_fit(tmp_path, reference):
    _crash_at(tmp_path, call=7)
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    resumed = preds(build().fit())
    assert last_stream_report().resumed_from_chunk == 6
    with partition_disabled():
        jfit = JScale(2.0).to_pipeline().then_label_estimator(
            JLinear(reg=1e-3), JArrayDataset(X), JArrayDataset(Y)
        ).fit()
    want = np.asarray(jfit.apply_batch(JArrayDataset(PROBE)).data)
    assert rel_err(resumed, want) <= 1e-5
    assert rel_err(reference, want) <= 1e-5


def test_sketched_solver_resumes_to_its_uninterrupted_fit(tmp_path, chunked):
    from keystone_tpu_torch.sketch import SketchedLeastSquaresEstimator

    def sketched():
        return SketchedLeastSquaresEstimator(reg=1e-3, sketch_size=64, device="cpu")

    want = preds(build(estimator=sketched()).fit())
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    with pytest.raises(ConnectionError):
        with faultinject.injected(FaultSpec(match="streaming.chunk", kind="transient", calls=(6,))):
            build(estimator=sketched()).fit()
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    got = preds(build(estimator=sketched()).fit())
    assert last_stream_report().resumed_from_chunk == 4
    assert rel_err(got, want) <= 1e-5


def test_stale_resume_refused_kv306_warn_mode(tmp_path, reference):
    _crash_at(tmp_path, call=5)
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    drifted_x = X + np.float32(0.25)
    fitted = build(x=drifted_x).fit()
    report = last_stream_report()
    assert report.resumed_from_chunk is None and report.chunks == 8
    assert "resume_refused" in {e.kind for e in get_recovery_log().events()}
    PipelineEnv.reset()
    clean = preds(build(x=drifted_x).fit())
    assert rel_err(preds(fitted), clean) <= 1e-6


def test_stale_resume_raises_in_strict_mode_and_preserves_entry(tmp_path, reference, monkeypatch):
    _crash_at(tmp_path, call=5)
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    monkeypatch.setenv("KEYSTONE_VERIFY", "strict")
    with pytest.raises(VerificationError, match="KV306"):
        build(x=X + np.float32(0.25)).fit()
    monkeypatch.setenv("KEYSTONE_VERIFY", "warn")
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    fitted = build().fit()
    assert last_stream_report().resumed_from_chunk == 4
    assert rel_err(preds(fitted), reference) <= 1e-6


def test_geometry_drift_discards_entry(tmp_path, chunked, monkeypatch):
    _crash_at(tmp_path, call=5)
    PipelineEnv.reset()
    enable_checkpointing(str(tmp_path), device="cpu")
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK * 2))
    fitted = build().fit()
    assert last_stream_report().resumed_from_chunk is None
    assert "resume_discard" in {e.kind for e in get_recovery_log().events()}
    assert preds(fitted).shape == (32, K)


def _cursor(cls):
    return cls(
        chunk_index=4, rows_consumed=256, chunk_rows=64, dataset_digest="aaa",
        labels_digest="bbb", chain_digest="ccc", feature_width=8, feature_dtype="float32",
    )


SAME = {"dataset_digest": "aaa", "labels_digest": "bbb", "chain_digest": "ccc",
        "feature_width": 8, "feature_dtype": "float32"}


@pytest.mark.parametrize(
    "changes",
    [{}, {"dataset_digest": "zzz"}, {"labels_digest": "zzz"}, {"chain_digest": "zzz"},
     {"feature_width": 16}, {"feature_dtype": "float64"},
     {"dataset_digest": "zzz", "feature_width": 16}],
)
def test_kv306_flags_the_same_fields_as_the_jax_package(changes):
    report = verify_stream_resume(_cursor(StreamCursor), {**SAME, **changes})
    jreport = j_verify_stream_resume(_cursor(JStreamCursor), {**SAME, **changes})
    assert report.ok == jreport.ok == (not changes)
    fields = [(d.code, d.details["field"]) for d in report.errors()]
    assert fields == [(d.code, d.details["field"]) for d in jreport.errors()]
    assert sorted(f for _, f in fields) == sorted(changes)


def test_dataset_fingerprint_bounded_and_sensitive(monkeypatch):
    big = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    base = durable.dataset_fingerprint(ArrayDataset(big.copy(), device="cpu"))
    assert base == durable.dataset_fingerprint(ArrayDataset(big.copy(), device="cpu"))
    monkeypatch.setattr(durable, "FULL_HASH_MAX_BYTES", 16)
    sampled = durable.dataset_fingerprint(ArrayDataset(big.copy(), device="cpu"))
    assert sampled != base
    assert sampled == durable.dataset_fingerprint(ArrayDataset(big.copy(), device="cpu"))
    drifted = big.copy()
    drifted[0, 0] += 1.0  # the first row is always sampled
    assert durable.dataset_fingerprint(ArrayDataset(drifted, device="cpu")) != sampled
    assert durable.dataset_fingerprint(ArrayDataset(big[:32].copy(), device="cpu")) != sampled


def test_dataset_fingerprint_samples_rows_past_the_limit(monkeypatch):
    monkeypatch.setattr(durable, "FINGERPRINT_SAMPLE_ROWS", 3)
    monkeypatch.setattr(durable, "FULL_HASH_MAX_BYTES", 64)
    big = np.arange(9 * 4, dtype=np.float32).reshape(9, 4)  # rows 0, 4, 8 sampled
    base = durable.dataset_fingerprint(ArrayDataset(big.copy(), device="cpu"))
    unsampled = big.copy()
    unsampled[1] += 1.0
    assert durable.dataset_fingerprint(ArrayDataset(unsampled, device="cpu")) == base
    sampled = big.copy()
    sampled[4] += 1.0
    assert durable.dataset_fingerprint(ArrayDataset(sampled, device="cpu")) != base


def test_dataset_fingerprint_of_a_tensor_equals_its_numpy_twins():
    class Host:
        def __init__(self, data):
            self.data = data
            self.num_examples = len(data)

    arr = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    assert durable.dataset_fingerprint(Host(arr)) == durable.dataset_fingerprint(Host(torch.from_numpy(arr)))


def test_resume_key_is_coarse_and_chain_digest_reads_content():
    est = LinearMapEstimator(reg=1e-3, device="cpu")
    assert resume_key(est, (Scale(2.0),), N) == resume_key(est, (Scale(3.0),), N)
    assert resume_key(est, (Scale(2.0),), N) != resume_key(est, (Scale(2.0),), N + 1)
    assert durable.chain_digest((Scale(2.0),)) != durable.chain_digest((Scale(3.0),))


def test_faulted_fold_joins_prefetch_workers(tmp_path, chunked):
    def prefetch_threads():
        return [t for t in threading.enumerate() if t.is_alive() and "prefetch" in t.name]

    assert not prefetch_threads()
    _crash_at(tmp_path, call=3)
    assert not prefetch_threads()


# ------------------------------------------------------------ the CLI


def _fit_cli(args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "fit", *args],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, **(env or {})},
    )


def _stats(proc):
    line = next(l for l in proc.stdout.splitlines() if l.startswith("FIT_STATS:"))
    return json.loads(line.split("FIT_STATS:", 1)[1])


def test_fit_cli_kill_resume_and_prefix_restore(tmp_path):
    common = ["--rows", "2048", "--chunk-rows", "128", "--ckpt-chunks", "4", "--device", "cpu"]
    ref = _fit_cli(common + ["--store-dir", str(tmp_path / "ref"), "--out", str(tmp_path / "ref.npz")])
    assert ref.returncode == 0, ref.stderr[-2000:]
    kill = json.dumps([{"match": "streaming.chunk", "kind": "kill", "calls": [11]}])
    killed = _fit_cli(common + ["--store-dir", str(tmp_path / "dur")], env={"KEYSTONE_FAULT_SPECS": kill})
    assert killed.returncode == -9
    strict = _fit_cli(common + ["--store-dir", str(tmp_path / "dur"), "--drift-data", "0.5"],
                      env={"KEYSTONE_VERIFY": "strict"})
    assert strict.returncode != 0 and "KV306" in strict.stderr
    res = _fit_cli(common + ["--store-dir", str(tmp_path / "dur"), "--out", str(tmp_path / "res.npz"),
                             "--expect-resume"])
    assert res.returncode == 0, res.stderr[-2000:]
    stats = _stats(res)
    assert stats["resumed_from_chunk"] == 8 and stats["reingested_chunks"] == 8
    a, b = np.load(tmp_path / "ref.npz")["preds"], np.load(tmp_path / "res.npz")["preds"]
    assert rel_err(b, a) <= 1e-6
    entries = os.listdir(tmp_path / "dur")
    assert len(entries) == 1 and entries[0].endswith(".pkl")  # the fitted prefix; no resume entry left
    again = _fit_cli(common + ["--store-dir", str(tmp_path / "dur")])
    stats = _stats(again)
    assert not stats["streamed"] and "checkpoint_hit" in stats["ledger_kinds"]
    assert stats["preds_norm"] == pytest.approx(float(np.linalg.norm(a)), rel=1e-6)


def test_fit_cli_equals_the_jax_packages_fit_on_the_same_data(tmp_path, monkeypatch):
    """The port's ``fit`` CLI draws its training data unlike the JAX CLI
    (spawned blocks, not one stream), so the JAX package fits in process on
    the port's draws: the CLI's probe predictions against it, ≤ 1e-5
    relative. The CLI also reports its own launch counts."""
    from keystone_tpu.workflow.fitcmd import FitDemoScaler as JFitDemoScaler
    from keystone_tpu_torch.workflow.fitcmd import synthetic_problem

    out = tmp_path / "port.npz"
    proc = _fit_cli(["--rows", "2048", "--chunk-rows", "128", "--device", "cpu",
                     "--store-dir", str(tmp_path / "store"), "--out", str(out)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    stats = _stats(proc)
    assert stats["streamed"] and stats["chunks"] == 16
    counts = stats["device_counts"]
    assert counts["ell_launches"] == 0 and counts["peak_device_bytes"] is None
    x, y, probe = synthetic_problem(2048, 16, 3, seed=0)
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", "128")
    with partition_disabled():
        jfit = JFitDemoScaler(scale=2.0, shift=0.5).to_pipeline().then_label_estimator(
            JLinear(reg=1e-3), JArrayDataset(x), JArrayDataset(y)
        ).fit()
    want = np.asarray(jfit.apply_batch(JArrayDataset(probe)).data)
    assert rel_err(np.load(out)["preds"], want) <= 1e-5


def test_fit_cli_without_a_card_or_device_flag_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _fit_cli(["--store-dir", str(tmp_path)])
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
