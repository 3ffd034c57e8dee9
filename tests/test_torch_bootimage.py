"""The port's serving boot images on the CPU: build and load with parity
at full and partial occupancy, KV307 refusals with the worker's classic
fallback, a parity digest that does not reproduce, and ``cache/``
hydration of kernel libraries (a stand-in file: there is no nvcc here).

The served answers of an image worker equal the synthetic pipeline's own
(≤ 1e-6; the same apply on the same host rows). Every wait carries its
own timeout.
"""

import json
import os
import shutil

import numpy as np
import pytest

from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs.flight import reset_flight_recorder
from keystone_tpu_torch.ops.cuda import _build
from keystone_tpu_torch.reliability.recovery import get_recovery_log, reset_recovery_log
from keystone_tpu_torch.serving.bootimage import (
    MANIFEST,
    BootImageRefused,
    build_boot_image,
    load_boot_image,
)
from keystone_tpu_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor
from keystone_tpu_torch.serving.synthetic import synthetic_fitted_pipeline
from keystone_tpu_torch.workflow.executor import PipelineEnv

SPEC = {"synthetic": {"d": 8}}
BUCKETS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("KEYSTONE_CUDA_BUILD_DIR", str(tmp_path / "cuda-build"))
    reset_recovery_log()
    reset_flight_recorder()
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()
    reset_flight_recorder()
    reset_recovery_log()


@pytest.fixture()
def image(tmp_path):
    path = str(tmp_path / "image")
    manifest = build_boot_image(SPEC, path, buckets=BUCKETS, device="cpu")
    return path, manifest


def _tampered(path, tmp_path, **fields):
    out = str(tmp_path / "tampered")
    shutil.copytree(path, out)
    with open(os.path.join(out, MANIFEST)) as f:
        manifest = json.load(f)
    manifest.update(fields)
    with open(os.path.join(out, MANIFEST), "w") as f:
        json.dump(manifest, f)
    return out


def test_build_and_load_hold_parity_at_full_and_partial_occupancy(image):
    path, manifest = image
    assert manifest["buckets"] == list(BUCKETS) and manifest["example"] == {"shape": [8], "dtype": "float32"}
    assert set(manifest["parity"]) == {str(b) for b in BUCKETS}
    assert all(set(d) == {"full", "partial"} for d in manifest["parity"].values())
    assert manifest["device_name"] == "cpu" and manifest["libraries"] == []
    assert manifest["kernel_sources"] == _build.sources_hash()
    loaded = load_boot_image(path, device="cpu")
    reference = synthetic_fitted_pipeline(d=8, device="cpu")
    x = np.random.default_rng(3).normal(size=(8, 8)).astype(np.float32)
    for n in (8, 5, 1):
        got = loaded.apply_batch(ArrayDataset(x, num_examples=n, device="cpu")).data[:n]
        want = reference.apply_batch(ArrayDataset(x, num_examples=n, device="cpu")).data[:n]
        assert np.array_equal(got.numpy(), want.numpy())
    assert [e.kind for e in get_recovery_log().events()] == ["bootimage_loaded"]


@pytest.mark.parametrize(
    "fields,field",
    [
        ({"torch_version": "0.0.0"}, "torch_version"),
        ({"device_name": "NVIDIA H100 80GB HBM3"}, "device_name"),
        ({"kernel_sources": "000000000000"}, "kernel_sources"),
        ({"weights_digest": "0" * 40}, "weights_digest"),
    ],
)
def test_stale_fingerprints_are_refused_by_kv307(image, tmp_path, fields, field):
    path, _ = image
    stale = _tampered(path, tmp_path, **fields)
    with pytest.raises(BootImageRefused, match="KV307") as info:
        load_boot_image(stale, device="cpu")
    assert [d.details["field"] for d in info.value.report.errors()] == [field]
    (event,) = get_recovery_log().events("bootimage_refused")
    assert event.detail["codes"] == ["KV307"] and event.detail["fields"] == [field]


def test_a_parity_digest_that_does_not_reproduce_is_refused(image, tmp_path):
    path, manifest = image
    parity = dict(manifest["parity"])
    parity["4"] = {"full": "0" * 40, "partial": parity["4"]["partial"]}
    with pytest.raises(BootImageRefused, match="parity"):
        load_boot_image(_tampered(path, tmp_path, parity=parity), device="cpu")
    assert get_recovery_log().events("bootimage_refused")[0].detail["buckets"] == ["4"]


def test_cache_hydration_places_matching_libraries_only(image, tmp_path):
    path, _ = image
    target = _build.library_path("solver_gemm")
    assert str(target).startswith(str(tmp_path / "cuda-build"))
    cache = os.path.join(path, "cache")
    with open(os.path.join(cache, target.name), "wb") as f:
        f.write(b"stand-in library")
    stale = f"libell_matmul-{'0' * 12}.so"
    with open(os.path.join(cache, stale), "wb") as f:
        f.write(b"built from other sources")
    load_boot_image(path, device="cpu")
    assert target.read_bytes() == b"stand-in library"
    assert sorted(os.listdir(target.parent)) == [target.name]
    (event,) = get_recovery_log().events("bootimage_loaded")
    assert event.detail["libraries_placed"] == [target.name]
    # A library already where _build looks is never overwritten.
    target.write_bytes(b"built here")
    load_boot_image(path, device="cpu")
    assert target.read_bytes() == b"built here"


def test_workers_boot_from_the_image_and_fall_back_on_a_refusal(image, tmp_path):
    """One worker on the image, one on a stale copy: the first reports
    ``loaded`` and builds no library, the second ``refused`` with the
    refusal in its ledger, and both answer with the pipeline's rows."""
    path, _ = image
    stale = _tampered(path, tmp_path, torch_version="0.0.0")
    rows = np.random.default_rng(1).normal(size=(6, 8)).astype(np.float32)
    want = synthetic_fitted_pipeline(d=8, device="cpu").apply_batch(ArrayDataset(rows, device="cpu")).data.numpy()
    ready = {}
    for tag, image_dir in (("loaded", path), ("refused", stale)):
        sup = WorkerSupervisor(
            SPEC,
            SupervisorConfig(workers=1, heartbeat_s=0.05, ready_timeout_s=60, boot_image=image_dir, device="cpu"),
        )
        sup.start()
        try:
            sup.wait_ready(timeout_s=60)
            got = np.asarray([f.result(timeout=30) for f in sup.submit_many([r.tolist() for r in rows])])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        finally:
            sup.stop()
        ready[tag] = sup.stats()["workers"]["0"]  # its ready line and its final stats line
    loaded, refused = ready["loaded"]["ready"], ready["refused"]["ready"]
    assert loaded["boot_image"] == "loaded" and "bootimage_loaded" in loaded["ledger_kinds"]
    assert refused["boot_image"] == "refused" and "bootimage_refused" in refused["ledger_kinds"]
    assert ready["loaded"]["stats"]["nvcc_builds"] == 0
