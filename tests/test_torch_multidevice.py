"""The multi-device tier's second part in the port, on the CPU, held
against the JAX package on the same numpy inputs (the port on N CPU
shards, the JAX package on the conftest's 8 virtual devices).

- hybrid meshes and ``mesh_without`` (``tests/parallel/test_mesh.py``),
  ``distributed_init``'s refusals, and a two-process ``gloo`` rehearsal
  of the cross-process Gram (``tests/parallel/test_multihost.py``);
- the estimators' mesh paths: KRR on 8 × 1 and on a 2 × 4 hybrid mesh
  (``tests/ops/test_kernel.py``), the PCA TSQR fit, the conv-block step;
- the tuner's shard-count axis, and the per-device memory payload.

Bounds, each beside the value measured on the CPU: KRR duals and
predictions ≤ 1e-5 (1.3e-6 / 2.1e-6 against one device); PCA components
≤ 1e-4 per column, the bound of the single-device parity test (the
eigenvectors of a float32 Gram; 8 shards against 1 read ≤ 2e-6); the
conv-block predictions ≤ 1e-5 (1.1e-6 standardized).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.learning import kernel as jkernel
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.ops.learning.conv_block import ConvBlockLeastSquaresEstimator as JConvBlock
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.kernel import GaussianKernelGenerator, KernelRidgeRegression
from keystone_tpu_torch.parallel import collectives
from keystone_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    REPLICA_AXIS,
    Mesh,
    distributed_init,
    make_hybrid_mesh,
    make_mesh,
    mesh_without,
    row_axes,
    row_shard_count,
    use_mesh,
)
from keystone_tpu_torch.workflow.executor import PipelineEnv

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(autouse=True)
def _fresh():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


# ------------------------------------------------------------------ meshes


def test_hybrid_mesh_rows_span_replica_and_data():
    hmesh = make_hybrid_mesh(num_replicas=2, devices=[CPU] * 8)
    jhmesh = jmesh.make_hybrid_mesh(num_replicas=2, devices=jax.devices()[:8])
    assert hmesh.shape == dict(jhmesh.shape) == {REPLICA_AXIS: 2, DATA_AXIS: 4}
    assert row_axes(hmesh) == jmesh.row_axes(jhmesh) == (REPLICA_AXIS, DATA_AXIS)
    assert row_shard_count(hmesh) == jmesh.row_shard_count(jhmesh) == 8
    assert not hmesh.spans_processes and hmesh.global_shape == hmesh.shape


def test_hybrid_mesh_rejects_indivisible_replica_count():
    with pytest.raises(ValueError, match="do not divide"):
        make_hybrid_mesh(num_replicas=3, devices=[CPU] * 8)


def test_hybrid_mesh_defaults_to_one_replica_in_one_process():
    hmesh = make_hybrid_mesh(devices=[CPU] * 4)
    jhmesh = jmesh.make_hybrid_mesh(devices=jax.devices()[:4])
    assert hmesh.shape == dict(jhmesh.shape) == {REPLICA_AXIS: 1, DATA_AXIS: 4}


@pytest.mark.parametrize("lost", [0, 3, 7])
def test_mesh_without_drops_one_flat_shard_into_a_1d_mesh(lost):
    grid = make_mesh((2, 4), ("data", "model"), devices=[CPU] * 8)
    jgrid = jmesh.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
    shrunk, jshrunk = mesh_without(grid, lost), jmesh.mesh_without(jgrid, lost)
    assert shrunk.axis_names == tuple(jshrunk.axis_names) == (DATA_AXIS,)
    assert shrunk.size == jshrunk.devices.size == 7


def test_mesh_without_refuses_the_last_device():
    with pytest.raises(ValueError, match="below one device"):
        mesh_without(make_mesh(devices=[CPU]), 0)


# -------------------------------------------------------- distributed_init


@pytest.mark.parametrize(
    "env,missing",
    [
        ({"KEYSTONE_NUM_HOSTS": "4", "KEYSTONE_HOST_ID": "1"}, "KEYSTONE_COORDINATOR"),
        ({"KEYSTONE_COORDINATOR": "127.0.0.1:1", "KEYSTONE_HOST_ID": "1"}, "KEYSTONE_NUM_HOSTS"),
        ({"KEYSTONE_COORDINATOR": "127.0.0.1:1", "KEYSTONE_NUM_HOSTS": "2"}, "KEYSTONE_HOST_ID"),
    ],
)
def test_partial_manual_config_raises_naming_what_is_unset(monkeypatch, env, missing):
    for name in ("KEYSTONE_COORDINATOR", "KEYSTONE_NUM_HOSTS", "KEYSTONE_HOST_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=missing):
        distributed_init()
    with pytest.raises(ValueError, match=missing):
        jmesh.distributed_init()


def test_no_cluster_env_is_a_no_op(monkeypatch):
    for name in ("KEYSTONE_COORDINATOR", "KEYSTONE_NUM_HOSTS", "KEYSTONE_HOST_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed_init() is None
    assert not torch.distributed.is_initialized()


def test_nccl_with_two_ranks_on_one_card_raises_and_never_switches(monkeypatch):
    """NCCL refuses two ranks on one GPU: the request raises with that
    reason before any process group is joined, and so does the default on
    a shared card; nothing falls back to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in ("nccl", None):
        with pytest.raises(ValueError, match="Duplicate GPU"):
            distributed_init("127.0.0.1:1", 2, 0, backend=backend)
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_rehearsal_on_the_cpu():
    """Two processes join one gloo group, each holds 4 shards of its half
    of the known matrix, and the sharded Gram crosses the processes."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "keystone_tpu_torch.parallel.rehearsal",
             "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id", str(i),
             "--local-shards", "4", "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "4 local / 8 global shards" in out, out[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("REHEARSAL_OK")][0]
        fields = dict(kv.split("=") for kv in line.split()[1:])
        assert float(fields["rel_err"]) <= 1e-5 and fields["mode"] == "gloo"
        assert int(fields["process_all_gather"]) == 1


# --------------------------------------------------------------------- KRR


def _krr_problem(n=200, d=6, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, np.sin(x @ rng.normal(size=(d, k))).astype(np.float32)


@pytest.mark.parametrize("replicas", [1, 2], ids=["8x1", "2x4-hybrid"])
def test_krr_on_a_mesh_matches_the_jax_package_and_one_device(replicas):
    x, y = _krr_problem()
    xt, _ = _krr_problem(n=50, seed=1)

    def port_fit():
        est = KernelRidgeRegression(GaussianKernelGenerator(0.2, device=CPU), 0.1, 16, 2)
        model = est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
        return model, model.apply_arrays(torch.from_numpy(xt)).numpy()

    one, one_pred = port_fit()
    mesh = make_hybrid_mesh(replicas, [CPU] * 8) if replicas > 1 else make_mesh(devices=[CPU] * 8)
    before = collectives.calls["ring_permute"]
    with use_mesh(mesh):
        tm, tpred = port_fit()
    assert collectives.calls["ring_permute"] > before
    jm_mesh = jmesh.make_hybrid_mesh(replicas, jax.devices()[:8]) if replicas > 1 else jmesh.make_mesh()
    with jmesh.use_mesh(jm_mesh):
        jm = jkernel.KernelRidgeRegression(jkernel.GaussianKernelGenerator(0.2), 0.1, 16, 2).fit(
            JArrayDataset(x), JArrayDataset(y)
        )
        jpred = np.asarray(jm.apply_arrays(jnp.asarray(xt)))
    n = x.shape[0]
    assert tm.duals.shape[0] == np.asarray(jm.duals).shape[0]
    assert _rel(tm.duals[:n].numpy(), np.asarray(jm.duals)[:n]) <= TOL
    assert _rel(tpred, jpred) <= TOL
    assert _rel(tm.duals[:n].numpy(), one.duals[:n].numpy()) <= TOL
    assert _rel(tpred, one_pred) <= TOL
    assert (tm.duals[n:] == 0).all()


def test_krr_learns_xor_on_the_hybrid_replica_mesh():
    """tests/ops/test_kernel.py::test_krr_on_hybrid_replica_mesh: the
    two-level ring must visit every shard."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 3)).astype(np.float32)
    y = (x[:, :1] * x[:, 1:2] > 0).astype(np.float32) * 2 - 1
    with use_mesh(make_hybrid_mesh(num_replicas=2, devices=[CPU] * 8)):
        model = KernelRidgeRegression(GaussianKernelGenerator(1.0, device=CPU), 1e-4, 8, 12).fit(
            ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)
        )
        preds = model.apply_arrays(torch.from_numpy(x)).numpy()
    assert (np.sign(preds) == y).mean() > 0.95


def _process_spanning_mesh():
    """Rank 0's part of a 2-process (replica, data) mesh of 4 CPU shards,
    as ``make_hybrid_mesh`` builds it after ``distributed_init``."""
    devices = np.empty((1, 4), dtype=object)
    devices[0, :] = [CPU] * 4
    return Mesh(devices, (REPLICA_AXIS, DATA_AXIS), process_group=(0, 2))


@pytest.mark.parametrize("entry", ["krr_fit", "kernel_apply", "partitioner"])
def test_estimators_refuse_a_mesh_that_spans_processes(entry):
    """Only the collectives and the sharded linalg reductions take a
    process-spanning mesh (the rehearsal's gram); the estimators and the
    partitioner, which lay out the rows they are given, raise."""
    from keystone_tpu_torch.ops.learning.kernel import KernelBlockLinearMapper
    from keystone_tpu_torch.parallel.partitioner import Partitioner

    x, y = _krr_problem(n=32)
    model = KernelBlockLinearMapper(torch.from_numpy(x), torch.from_numpy(y), 0.2, num_train=32, block_size=16)
    calls = {
        "krr_fit": lambda: KernelRidgeRegression(GaussianKernelGenerator(0.2, device=CPU), 0.1, 16, 1).fit(
            ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU)),
        "kernel_apply": lambda: model.apply_arrays(torch.from_numpy(x)),
        "partitioner": lambda: Partitioner(),
    }
    with use_mesh(_process_spanning_mesh()), pytest.raises(ValueError, match="rehearsal's gram"):
        calls[entry]()


# --------------------------------------------------------------------- PCA


def test_pca_mesh_fit_matches_the_jax_package_and_one_device():
    rng = np.random.default_rng(9)
    z = rng.normal(size=(2000, 12)) * np.arange(1, 13)
    q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    x = (z @ q.T + rng.normal(size=12)).astype(np.float32)
    one = tpca.DistributedPCAEstimator(5).fit(ArrayDataset(x, device=CPU)).components.numpy()
    before = collectives.calls["all_gather"]
    with use_mesh(make_mesh(devices=[CPU] * 8)):
        got = tpca.DistributedPCAEstimator(5).fit(ArrayDataset(x, device=CPU)).components.numpy()
    assert collectives.calls["all_gather"] == before + 1  # the stacked R factors
    want = np.asarray(jpca.DistributedPCAEstimator(5).fit(JArrayDataset(x)).components)
    for col in range(5):
        assert _rel(got[:, col], want[:, col]) <= 1e-4
        assert _rel(got[:, col], one[:, col]) <= 1e-4


# -------------------------------------------------------------- conv block


@pytest.mark.parametrize("standardize", [True, False])
def test_conv_block_mesh_step_matches_the_jax_package(standardize):
    """12 filters in blocks of 4 on 45 images (not a multiple of 8: pad
    rows masked out of every sum)."""
    f = np.random.default_rng(0).normal(size=(10, 6 * 6 * 3)).astype(np.float32) * 0.1
    j = jcore.FusedConvFeaturizer(jcore.Convolver(f, 3, normalize_patches=True), jcore.SymmetricRectifier(alpha=0.25),
                                  jcore.Pooler(13, 14, None, "sum"), filter_block=4)
    t = tcore.FusedConvFeaturizer(tcore.Convolver(f, 3, normalize_patches=True, device=CPU),
                                  tcore.SymmetricRectifier(alpha=0.25),
                                  tcore.Pooler(13, 14, None, "sum"), filter_block=4)
    rng = np.random.default_rng(1)
    images = rng.random((45, 32, 32, 3)).astype(np.float32)
    y = rng.normal(size=(45, 3)).astype(np.float32)
    kw = dict(block_size=32, num_iter=2, reg=0.1, standardize=standardize, image_chunk=6)
    before = collectives.calls["allreduce_sum"]
    with use_mesh(make_mesh(devices=[CPU] * 8)):
        tm = ConvBlockLeastSquaresEstimator(t, device=CPU, **kw).fit(
            ArrayDataset(images, device=CPU), ArrayDataset(y, device=CPU)
        )
    assert collectives.calls["allreduce_sum"] > before
    tp = tm.apply_arrays(torch.from_numpy(images)).numpy()
    jm = JConvBlock(j, **kw).fit(JArrayDataset(images), JArrayDataset(y))
    jp = np.asarray(jm.apply_arrays(jnp.asarray(images)))
    assert _rel(tp, jp) <= TOL
    assert _rel(tm.linear.feature_mean.numpy(), np.asarray(jm.linear.feature_mean)) <= TOL


# -------------------------------------------------------------------- tune


def test_tuner_searches_the_shard_axis_under_an_8_shard_mesh(tmp_path, monkeypatch):
    """``stream`` searches shards [1, 8] on an 8-shard mesh (the JAX
    package on its 8 devices searches the same grid), records what ran,
    and the two stores hold the same keys."""
    from keystone_tpu.obs import store as jstore
    from keystone_tpu.workflow import tune as jtune
    from keystone_tpu_torch.obs import store as tstore
    from keystone_tpu_torch.workflow import tune as ttune

    kwargs = dict(rows=1024, dim=16, classes=2)
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "jax.jsonl"))
    jstore.set_store(None)
    jout = jtune.TASKS["stream"](jtune.Tuner(budget=8, seed=0, time_budget_s=1e9), jstore.get_store(), **kwargs)
    j_keys = sorted((k, s) for k, s, m in jstore.get_store().entries() if m.get("source") == "tune")
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "port.jsonl"))
    tstore.set_store(None)
    with use_mesh(make_mesh(devices=[CPU] * 8)):
        out = ttune.TASKS["stream"](ttune.Tuner(budget=8, seed=0, time_budget_s=1e9), tstore.get_store(),
                                    device="cpu", **kwargs)
    assert sorted({m.knobs["shards"] for m in out.measured}) == [1, 8]
    assert {m.knobs["shards"] for m in jout.measured} == {1, 8}
    for m in out.measured:
        assert m.extra["shards_actual"] == m.knobs["shards"]
    recorded = {k: m for k, _s, m in tstore.get_store().entries() if m.get("source") == "tune"}
    # Every candidate keeps its own entry, keyed by the chunk rows,
    # prefetch depth and shard count that ran; the JAX keys (chunk rows
    # alone) are their prefixes.
    assert len(recorded) == len(out.measured) == 8
    for k, r in recorded.items():
        assert k.endswith(f":cr{r['chunk_rows']}:p{r['prefetch_depth']}:s{r['shards']}")
    t_keys = sorted({(k.split(":p")[0], s) for k, s, m in tstore.get_store().entries() if m.get("source") == "tune"})
    assert t_keys == j_keys and j_keys
    # The store's best entry is the winner, with the winner's knobs.
    best = max(recorded.values(), key=lambda r: r["rows_per_s"])
    w = out.winner
    assert best["rows_per_s"] == w.objective
    assert (best["prefetch_depth"], best["shards"]) == (w.knobs["prefetch"], w.extra["shards_actual"])


def test_tuner_keeps_one_shard_on_a_one_shard_mesh(tmp_path, monkeypatch):
    from keystone_tpu_torch.obs import store as tstore
    from keystone_tpu_torch.workflow import tune as ttune

    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "port.jsonl"))
    tstore.set_store(None)
    out = ttune.TASKS["stream"](ttune.Tuner(budget=2, seed=0, time_budget_s=1e9), tstore.get_store(),
                                device="cpu", rows=1024, dim=16, classes=2)
    assert {m.knobs["shards"] for m in out.measured} == {1}


# ------------------------------------------------------------- device obs


def test_per_device_payload_collapses_cpu_shards_to_one_host_entry():
    from keystone_tpu_torch.obs import names as tnames
    from keystone_tpu_torch.obs.device import device_obs_payload, publish_per_device_memory

    mesh = make_hybrid_mesh(2, [CPU] * 8)
    snaps = publish_per_device_memory("multidevice", mesh)
    assert [s["device"] for s in snaps] == ["host"] and snaps[0]["source"] == "rss"
    payload = device_obs_payload(snaps, mesh)
    assert payload["devices"] is snaps
    assert payload["shards_per_device"] == {"cpu": 8}
    assert payload["mesh_shape"] == {REPLICA_AXIS: 2, DATA_AXIS: 4}
    gauge = tnames.metric(tnames.MEMORY_IN_USE_BYTES)
    assert gauge.value(source="rss", device="host") == snaps[0]["bytes_in_use"]


def test_cli_joins_the_process_group_first_under_keystone_distributed(monkeypatch):
    """``KEYSTONE_DISTRIBUTED`` makes the CLI call ``distributed_init``
    before the subcommand: a partial triple fails it there, naming what is
    unset, as ``cli.py`` of the JAX package does."""
    from keystone_tpu_torch import cli

    for name in ("KEYSTONE_COORDINATOR", "KEYSTONE_NUM_HOSTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KEYSTONE_DISTRIBUTED", "1")
    monkeypatch.setenv("KEYSTONE_HOST_ID", "0")
    with pytest.raises(ValueError, match="KEYSTONE_COORDINATOR"):
        cli.main(["check", "--lint"])
