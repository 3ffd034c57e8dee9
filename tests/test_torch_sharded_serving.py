"""Sharded bucketed serving in the port, on 8 CPU shards, mirroring
``tests/serving/test_sharded_serving.py`` on the JAX package's 8 virtual
devices: warmup attaches the row-sharding decision once
(``attach_serving_partition``), every batch whose rows divide the shards
is applied shard by shard, the answers equal the unsharded server's
(≤ 1e-5; 0.0 measured) and the JAX package's, one-shard meshes and
indivisible buckets serve unsharded, the first attach wins, and an
attach leaves the plan report alone. The decisions' fields equal the
JAX package's."""

from concurrent.futures import wait

import numpy as np
import pytest
import torch

from keystone_tpu.parallel import partitioner as jpart
from keystone_tpu.serving.config import ServingConfig as JServingConfig
from keystone_tpu.serving.server import PipelineServer as JPipelineServer
from keystone_tpu.serving.synthetic import synthetic_fitted_pipeline as j_synthetic
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import names as tnames
from keystone_tpu_torch.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch.parallel.partitioner import (
    attach_serving_partition,
    last_partition_report,
    partition_disabled,
    reset_partition_report,
)
from keystone_tpu_torch.serving.config import ServingConfig
from keystone_tpu_torch.serving.server import PipelineServer
from keystone_tpu_torch.serving.synthetic import synthetic_fitted_pipeline
from keystone_tpu_torch.workflow.executor import PipelineEnv

CPU = torch.device("cpu")
D = 12


@pytest.fixture(autouse=True)
def mesh8(monkeypatch):
    # The JAX server's warmup would turn on JAX's persistent compilation
    # cache for the whole process, and with it off go buffer donation on
    # the CPU for every later test in the same worker. The comparison
    # needs no cache.
    monkeypatch.setenv("KEYSTONE_COMPILATION_CACHE", "off")
    PipelineEnv.reset()
    with use_mesh(make_mesh(devices=[CPU] * 8)) as mesh:
        yield mesh
    PipelineEnv.reset()


def _payloads():
    rng = np.random.default_rng(1)
    return [rng.normal(size=(D,)).astype(np.float32) for _ in range(48)]


def _serve(model, payloads, shard: bool):
    srv = PipelineServer(model=model, config=ServingConfig(max_batch=8, max_wait_ms=1.0, queue_depth=256), device=CPU)
    if shard:
        warm = srv.warmup(payloads[0])
    else:
        with partition_disabled():
            warm = srv.warmup(payloads[0])
    srv.start()
    futures = srv.submit_many(payloads)
    wait(futures, timeout=60)
    rows = np.stack([np.asarray(f.result()) for f in futures])
    stats = srv.stats()
    srv.stop()
    return warm, rows, stats


def _jax_rows(payloads):
    srv = JPipelineServer(model=j_synthetic(d=D), config=JServingConfig(max_batch=8, max_wait_ms=1.0, queue_depth=256))
    warm = srv.warmup(payloads[0])
    srv.start()
    futures = srv.submit_many(payloads)
    wait(futures, timeout=60)
    rows = np.stack([np.asarray(f.result()) for f in futures])
    srv.stop()
    return warm, rows


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_warmup_attaches_the_decision_and_answers_equal_the_unsharded_server():
    payloads = _payloads()
    model = synthetic_fitted_pipeline(d=D, device=CPU)
    warm, rows, stats = _serve(model, payloads, shard=True)
    decision = warm["partition_decisions"]["default"]
    j_warm, j_rows = _jax_rows(payloads)
    j_decision = j_warm["partition_decisions"]["default"]
    assert decision == j_decision
    assert decision["eligible"] and decision["shards"] == 8
    assert model.compiled_apply().sharded_calls > 0
    assert stats["served"] == len(payloads) and stats.get("dropped", 0) == 0
    _, rows_ref, _ = _serve(synthetic_fitted_pipeline(d=D, device=CPU), payloads, shard=False)
    assert _rel(rows, rows_ref) <= 1e-5
    # The synthetic weights are the JAX package's for the same seed.
    assert _rel(rows, j_rows) <= 1e-5


def test_compiled_apply_applies_divisible_batches_shard_by_shard():
    model = synthetic_fitted_pipeline(d=D, device=CPU)
    decision = attach_serving_partition(model, [1, 2, 4, 8])
    assert decision.eligible
    handle = model.compiled_apply()
    assert handle.partition is decision
    batch = np.random.default_rng(2).normal(size=(8, D)).astype(np.float32)
    gauge = tnames.metric(tnames.PARTITION_IMBALANCE)
    out = handle(ArrayDataset(batch, num_examples=6, device=CPU))
    assert handle.sharded_calls == 1
    assert gauge.value(kind="serve") == pytest.approx(0.25)
    handle.partition = None
    plain = handle(ArrayDataset(batch, num_examples=6, device=CPU))
    assert out.num_examples == plain.num_examples == 6
    assert _rel(out.data.numpy(), plain.data.numpy()) <= 1e-5
    # An indivisible batch applies unsharded under the decision too.
    handle.partition = decision
    handle(ArrayDataset(batch[:3], device=CPU))
    assert handle.sharded_calls == 1


def test_indivisible_buckets_serve_on_default_placement():
    model = synthetic_fitted_pipeline(d=D, device=CPU)
    decision = attach_serving_partition(model, [1, 2])
    j_decision = jpart.attach_serving_partition(j_synthetic(d=D), [1, 2])
    assert decision.to_json() == j_decision.to_json()
    assert not decision.eligible and decision.reason == "buckets-indivisible"
    assert model.compiled_apply().partition is None


def test_conflicting_reattach_keeps_first_installed_decision():
    model = synthetic_fitted_pipeline(d=D, device=CPU)
    first = attach_serving_partition(model, [1, 2, 4, 8])
    handle = model.compiled_apply()
    assert first.eligible and handle.partition is first
    assert attach_serving_partition(model, [1, 2]) is first
    assert handle.partition is first
    attach_serving_partition(model, [1, 2, 4, 8])
    assert handle.partition.shards == first.shards


def test_decisions_are_counted_not_attaches():
    model = synthetic_fitted_pipeline(d=D, device=CPU)
    decisions = tnames.metric(tnames.PARTITION_DECISIONS)
    before = decisions.value(kind="serve", eligible="1")
    for _ in range(3):
        attach_serving_partition(model, [1, 2, 4, 8])
    assert decisions.value(kind="serve", eligible="1") - before == 1


def test_serving_attach_does_not_pollute_plan_report():
    reset_partition_report()
    attach_serving_partition(synthetic_fitted_pipeline(d=D, device=CPU), [1, 2, 4, 8])
    assert last_partition_report() == []


def test_single_device_mesh_serves_unsharded():
    with use_mesh(make_mesh(devices=[CPU])):
        model = synthetic_fitted_pipeline(d=D, device=CPU)
        decision = attach_serving_partition(model, [1, 2, 4, 8])
        assert not decision.eligible and decision.reason == "single-shard-mesh"
        assert model.compiled_apply().partition is None
