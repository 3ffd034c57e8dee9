"""The sharded durable fold and shard-loss recovery in the port, held
against the JAX package on the same numpy inputs: the port on 8 CPU
shards, the JAX package on the conftest's 8 virtual devices.

Mirrors the sharded cases of ``tests/workflow/test_durable_stream.py``
(crash-resume on 8 shards and on one device from a sharded checkpoint,
shard loss, the seed-bearing shard 0, a loss before the first chunk, two
losses, no leaked prefetch threads) and the recovery half of
``tests/workflow/test_partition2d.py`` (cross-mesh resume, a 2-D
checkpoint resumed on one device, a loss on the model axis, the seed
block in 2-D, a 1 × 8 loss). Each case runs both packages with the same
environment and the same injected fault, and holds the port's
predictions to the JAX package's (≤ 1e-5 relative), its report's
recovery fields to the JAX package's, and its predictions to its own
uninterrupted fit with the JAX test's bound."""

import contextlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinear
from keystone_tpu.parallel.partitioner import partition_disabled as j_partition_disabled
from keystone_tpu.reliability import enable_checkpointing as j_enable_checkpointing
from keystone_tpu.reliability import faultinject as jfaultinject
from keystone_tpu.reliability.recovery import get_recovery_log as j_recovery_log
from keystone_tpu.workflow.executor import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.pipeline import BatchTransformer as JBatchTransformer
from keystone_tpu.workflow.streaming import last_stream_report as j_last_stream_report
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch.parallel.partitioner import partition_disabled
from keystone_tpu_torch.reliability import enable_checkpointing
from keystone_tpu_torch.reliability import faultinject
from keystone_tpu_torch.reliability.recovery import get_recovery_log, reset_recovery_log
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import BatchTransformer
from keystone_tpu_torch.workflow.streaming import last_stream_report

CPU = torch.device("cpu")
CHUNK = 64
TOL = 1e-5


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


def _problem(n, d, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = (x @ w + 0.01 * rng.normal(size=(n, k))).astype(np.float32)
    return x, y, rng.normal(size=(32, d)).astype(np.float32)


ONE_D = _problem(512, 8, 2, 7)
TWO_D = _problem(512, 64, 3, 11)  # wide enough for 8 model shards

PORT = SimpleNamespace(
    name="port",
    pipe=lambda x, y: Scale(2.0).to_pipeline().then_label_estimator(
        LinearMapEstimator(reg=1e-3, device=CPU), ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)
    ),
    preds=lambda f, p: f.apply_batch(ArrayDataset(p, device=CPU)).data.numpy(),
    reset=PipelineEnv.reset,
    enable=lambda path: enable_checkpointing(path, device=CPU),
    injected=faultinject.injected,
    FaultSpec=faultinject.FaultSpec,
    report=last_stream_report,
    one_device=partition_disabled,
    mesh=lambda: use_mesh(make_mesh(devices=[CPU] * 8)),
    kinds=lambda: {e.kind for e in get_recovery_log().events()},
)
JAX = SimpleNamespace(
    name="jax",
    pipe=lambda x, y: JScale(2.0).to_pipeline().then_label_estimator(
        JLinear(reg=1e-3), JArrayDataset(x), JArrayDataset(y)
    ),
    preds=lambda f, p: np.asarray(f.apply_batch(JArrayDataset(p)).data),
    reset=JPipelineEnv.reset,
    enable=j_enable_checkpointing,
    injected=jfaultinject.injected,
    FaultSpec=jfaultinject.FaultSpec,
    report=j_last_stream_report,
    one_device=j_partition_disabled,
    mesh=contextlib.nullcontext,  # the conftest's 8 virtual devices
    kinds=lambda: {e.kind for e in j_recovery_log().events()},
)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    monkeypatch.setenv("KEYSTONE_STREAM_CKPT_CHUNKS", "2")
    reset_recovery_log()
    PipelineEnv.reset()
    JPipelineEnv.reset()
    yield
    PipelineEnv.reset()
    JPipelineEnv.reset()


def _fit(pkg, problem, shard_loss=(), one_device=False, store=None, crash_at=None):
    """One fit of ``pkg``'s pipeline: returns (predictions or None after a
    crash, the stream report, recovery event kinds)."""
    x, y, probe = problem
    specs = []
    if shard_loss:
        specs.append(pkg.FaultSpec(match="parallel.shard_loss", kind="transient", calls=tuple(shard_loss)))
    if crash_at is not None:
        specs.append(pkg.FaultSpec(match="streaming.chunk", kind="transient", calls=(crash_at,)))
    with pkg.mesh():
        pkg.reset()
        if store is not None:
            pkg.enable(str(store / pkg.name))
        with pkg.one_device() if one_device else contextlib.nullcontext():
            with pkg.injected(*specs):
                if crash_at is not None:
                    with pytest.raises(ConnectionError):
                        pkg.pipe(x, y).fit()
                    return None, pkg.report(), pkg.kinds()
                fitted = pkg.pipe(x, y).fit()
    return pkg.preds(fitted, probe), pkg.report(), pkg.kinds()


def _reference(problem):
    """The port's uninterrupted single-device predictions, no store."""
    out, _, _ = _fit(PORT, problem, one_device=True)
    return out


def _both(problem, **kw):
    t = _fit(PORT, problem, **kw)
    j = _fit(JAX, problem, **kw)
    if t[0] is not None:
        assert _rel(t[0], j[0]) <= TOL
    return t, j


FIELDS = ("shards", "model_shards", "shard_losses", "reingested_chunks", "resumed_from_chunk", "chunks")


def _same_recovery(t_report, j_report):
    for field in FIELDS:
        assert getattr(t_report, field) == getattr(j_report, field), field


# ------------------------------------------------------------ crash-resume


def test_crash_resume_parity_sharded(tmp_path):
    ref = _reference(ONE_D)
    (_, t_crash, _), (_, j_crash, _) = _both(ONE_D, store=tmp_path, crash_at=5)
    assert t_crash.chunks == j_crash.chunks == 4
    (t, t_rep, t_kinds), (_, j_rep, _) = _both(ONE_D, store=tmp_path)
    _same_recovery(t_rep, j_rep)
    assert t_rep.resumed_from_chunk == 4 and t_rep.reingested_chunks == 4 == t_rep.chunks
    assert t_rep.shards == 8
    assert _rel(t, ref) <= 1e-6
    assert "stream_resume" in t_kinds


def test_crash_resume_parity_one_device_from_sharded_checkpoint(tmp_path):
    ref = _reference(ONE_D)
    _both(ONE_D, store=tmp_path, crash_at=3)
    (t, t_rep, _), (_, j_rep, _) = _both(ONE_D, store=tmp_path, one_device=True)
    _same_recovery(t_rep, j_rep)
    assert t_rep.resumed_from_chunk == 2 and t_rep.shards == 1
    assert _rel(t, ref) <= 1e-6


# -------------------------------------------------------------- shard loss


def test_shard_loss_mid_stream_completes_on_survivors():
    ref = _reference(ONE_D)
    (t, t_rep, t_kinds), (_, j_rep, _) = _both(ONE_D, shard_loss=(3,))
    _same_recovery(t_rep, j_rep)
    assert (t_rep.shard_losses, t_rep.shards, t_rep.reingested_chunks) == (1, 7, 2)
    assert _rel(t, ref) <= 1e-5
    assert {"shard_loss", "shard_resume"} <= t_kinds


def test_seed_bearing_shard_zero_loss_recovers_exactly(monkeypatch):
    monkeypatch.setenv("KEYSTONE_SHARD_LOSS_INDEX", "0")
    ref = _reference(ONE_D)
    (t, t_rep, _), (_, j_rep, _) = _both(ONE_D, shard_loss=(4,))
    _same_recovery(t_rep, j_rep)
    assert t_rep.shard_losses == 1
    assert _rel(t, ref) <= 1e-5


def test_loss_before_first_chunk_keeps_compile_accounting_exact():
    ref = _reference(ONE_D)
    (t, t_rep, _), (_, j_rep, _) = _both(ONE_D, shard_loss=(1,))
    _same_recovery(t_rep, j_rep)
    assert t_rep.shard_losses == 1 and t_rep.reingested_chunks == 0
    assert t_rep.compiles_steady_state == j_rep.compiles_steady_state == 0
    assert _rel(t, ref) <= 1e-5


def test_two_sequential_losses_still_converge():
    ref = _reference(ONE_D)
    (t, t_rep, _), (_, j_rep, _) = _both(ONE_D, shard_loss=(2, 6))
    _same_recovery(t_rep, j_rep)
    assert (t_rep.shard_losses, t_rep.shards) == (2, 6)
    assert _rel(t, ref) <= 1e-5


def test_faulted_and_salvaged_folds_join_their_prefetch_workers(tmp_path):
    def prefetch_threads():
        return [t for t in threading.enumerate() if t.is_alive() and "prefetch" in t.name]

    assert not prefetch_threads()
    _fit(PORT, ONE_D, store=tmp_path, crash_at=3)
    assert not prefetch_threads()
    _fit(PORT, ONE_D, shard_loss=(2,))
    assert not prefetch_threads()


# -------------------------------------------------------------------- 2-D


@pytest.mark.parametrize("first,second", [("8", "4"), ("4", "8")], ids=["1x8-to-2x4", "2x4-to-1x8"])
def test_cross_mesh_durable_resume_parity(tmp_path, monkeypatch, first, second):
    ref = _reference(TWO_D)
    monkeypatch.setenv("KEYSTONE_PARTITION_MIN_WIDTH", "8")
    monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", first)
    _both(TWO_D, store=tmp_path, crash_at=5)
    monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", second)
    (t, t_rep, _), (_, j_rep, _) = _both(TWO_D, store=tmp_path)
    _same_recovery(t_rep, j_rep)
    assert t_rep.resumed_from_chunk == 4 and t_rep.model_shards == int(second)
    assert _rel(t, ref) <= 1e-6


def test_2d_checkpoint_resumes_single_device(tmp_path, monkeypatch):
    ref = _reference(TWO_D)
    monkeypatch.setenv("KEYSTONE_PARTITION_MIN_WIDTH", "8")
    monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", "4")
    _both(TWO_D, store=tmp_path, crash_at=5)
    (t, t_rep, _), (_, j_rep, _) = _both(TWO_D, store=tmp_path, one_device=True)
    _same_recovery(t_rep, j_rep)
    assert t_rep.resumed_from_chunk == 4 and t_rep.shards == 1
    assert _rel(t, ref) <= 1e-6


@pytest.fixture
def grid2d(monkeypatch):
    monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", "4")
    monkeypatch.setenv("KEYSTONE_PARTITION_MIN_WIDTH", "8")
    monkeypatch.setenv("KEYSTONE_STREAM_CKPT_CHUNKS", "0")


def test_model_axis_shard_loss_salvages_surviving_row_group(grid2d):
    """Flat shard 7 of the 2 × 4 layout is (data row 1, model column 3):
    the whole row group drops, its windows re-ingest, and the fold goes
    on row-only over 7 shards."""
    ref = _reference(TWO_D)
    (t, t_rep, t_kinds), (_, j_rep, _) = _both(TWO_D, shard_loss=(3,))
    _same_recovery(t_rep, j_rep)
    assert (t_rep.shard_losses, t_rep.shards, t_rep.model_shards) == (1, 7, 1)
    assert t_rep.reingested_chunks > 0
    assert _rel(t, ref) <= 1e-5
    assert {"shard_loss", "shard_resume"} <= t_kinds


def test_seed_bearing_block_loss_readds_seed_2d(grid2d, monkeypatch):
    monkeypatch.setenv("KEYSTONE_SHARD_LOSS_INDEX", "0")
    ref = _reference(TWO_D)
    (t, t_rep, _), (_, j_rep, _) = _both(TWO_D, shard_loss=(4,))
    _same_recovery(t_rep, j_rep)
    assert t_rep.shard_losses == 1
    assert _rel(t, ref) <= 1e-5


def test_1x8_loss_reingests_everything(grid2d, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PARTITION_MODEL_SHARDS", "8")
    ref = _reference(TWO_D)
    (t, t_rep, _), (_, j_rep, _) = _both(TWO_D, shard_loss=(3,))
    _same_recovery(t_rep, j_rep)
    assert t_rep.shard_losses == 1
    assert _rel(t, ref) <= 1e-5
