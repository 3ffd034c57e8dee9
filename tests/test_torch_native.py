"""The port's native host kernels (``keystone_tpu_torch/native``, built with
``g++`` at first use from the port's own copies of the C++ sources) and
their wrappers (``ops/images/external``, ``archive.native_decode_batch``,
``data/ingest.py``), held to the port's plain versions, to PIL and to the
JAX package's build of the same sources, on the CPU.

Bounds, each with the value read on the CPU (the JAX tests' own,
``tests/native/test_native_kernels.py``, where they exist):

- ``ks_dsift`` against the port's SIFT: ≥ 99.5% of entries within 1
  (read 100%, and 99.995% / 99.999% equal, at 48×40 and at 256×256 with
  ``scale_step`` 1);
- ``ks_fisher_encode`` against the port's ``FisherVector``: rtol and atol
  1e-3 (read 3.9e-7 absolute);
- ``ks_gmm_fit``: every planted centre within 0.5 of a component, weights
  summing to 1 ± 1e-4;
- ``ks_decode_jpeg_batch`` against PIL: mean absolute difference < 1.5
  at the source size, < 20 through the loader's resize, < 3 on the scaled
  decode of a smooth gradient;
- against the JAX package's build of the same sources: descriptors, GMM
  parameters, Fisher vectors, decoded images and the fixture tar equal
  (bit for bit).
"""

import ctypes
import io
import os
import tarfile

import numpy as np
import pytest
import torch

from keystone_tpu import native as jnative
from keystone_tpu.data import ingest as jingest
from keystone_tpu.data.loaders import archive as jarchive
from keystone_tpu.ops.images.external.fisher import NativeFisherVector as JNativeFisherVector
from keystone_tpu.ops.images.external.fisher import native_gmm_fit as jnative_gmm_fit
from keystone_tpu.ops.images.external.sift import NativeSIFTExtractor as JNativeSIFT
from keystone_tpu.ops.learning.gmm import GaussianMixtureModel as JGaussianMixtureModel
from keystone_tpu_torch import native
from keystone_tpu_torch.data import ingest
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.data.loaders import archive
from keystone_tpu_torch.ops.images.external import (
    NativeFisherVector,
    NativeGMMFisherVectorEstimator,
    NativeSIFTExtractor,
    native_gmm_fit,
)
from keystone_tpu_torch.ops.images.fisher import FisherVector
from keystone_tpu_torch.ops.images.sift import SIFTExtractor
from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
from keystone_tpu_torch.utils.image import load_image

PIL = pytest.importorskip("PIL")
from PIL import Image as PILImage  # noqa: E402

CPU = torch.device("cpu")
WITHIN_ONE = 0.995


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX package's build of the same sources (``make -C
    keystone_tpu/native`` where it is not built yet), for the equality
    checks."""
    assert jnative.load(auto_build=True) is not None


def _jpeg_bytes(arr, quality=95):
    buf = io.BytesIO()
    PILImage.fromarray(arr, "RGB").save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


# ------------------------------------------------------------------ build


def test_the_library_builds_from_the_ports_sources_into_its_build_directory():
    port_pkg = os.path.dirname(native.__file__)
    for name in ("kernels", "decode"):
        path = os.path.realpath(native.loaded_path(name))
        assert path.startswith(os.path.join(port_pkg, "build") + os.sep), path
        assert os.sep + os.path.join("keystone_tpu", "native") + os.sep not in path
        assert path == str(native.library_path(name))
    for src in ("dsift.cpp", "gmm.cpp", "decode.cpp"):
        assert (native.SOURCE_DIR / src).is_file()
    assert native.compile_flags()[:6] == ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-fopenmp")
    assert native.has_header("stddef.h") and not native.has_header("no_such_header_zz.h")
    assert native.has_openmp()


def test_a_compiler_without_openmp_raises_unless_a_serial_build_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "has_openmp", lambda: False)
    with pytest.raises(RuntimeError, match="KEYSTONE_NATIVE_OPENMP=off"):
        native.build("kernels")
    monkeypatch.setenv("KEYSTONE_NATIVE_OPENMP", "off")
    assert "-fopenmp" not in native.compile_flags()
    path = native.build("kernels")
    assert path.parent == tmp_path
    # The single-threaded build computes what the OpenMP build does.
    serial = native._configure("kernels", ctypes.CDLL(str(path)))
    imgs = np.random.default_rng(9).random((3, 40, 44), dtype=np.float32)
    total = serial.ks_dsift_descriptor_count(40, 44, 3, 4, 2, 1)
    out = np.zeros((3, total, 128), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    serial.ks_dsift(imgs.ctypes.data_as(fp), 3, 40, 44, 3, 4, 2, 1, out.ctypes.data_as(fp))
    monkeypatch.delenv("KEYSTONE_NATIVE_OPENMP")
    np.testing.assert_array_equal(out, NativeSIFTExtractor(scales=2)._extract(imgs))
    assert native.library_path("kernels") != path  # the flags name the library


def test_a_failed_build_raises_with_the_compilers_log(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ("-fno-such-option-zz",))
    monkeypatch.setenv("KEYSTONE_NATIVE_OPENMP", "off")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building the native kernels library"):
        native.build("kernels")
    assert "no-such-option" in (tmp_path / "kernels.log").read_text()
    assert not list(tmp_path.glob("*.so"))


def test_the_decode_build_names_a_missing_jpeg_header(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "has_header", lambda header: False)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.build("decode")
    with pytest.raises(ValueError, match="unknown native library"):
        native.load("other")


# ------------------------------------------------------------------- SIFT


@pytest.mark.parametrize("shape,kwargs", [
    ((2, 48, 40), dict(step_size=4, bin_size=4, scales=2, scale_step=1)),
    ((1, 256, 256), dict(scale_step=1)),
])
def test_native_sift_matches_the_ports_sift(shape, kwargs):
    rng = np.random.default_rng(0)
    imgs = rng.random(shape, dtype=np.float32)
    ref = SIFTExtractor(**kwargs).apply_arrays(torch.from_numpy(imgs)).numpy()
    out = NativeSIFTExtractor(**kwargs)._extract(imgs)
    assert out.shape == ref.shape
    assert (np.abs(out - ref) <= 1.0).mean() >= WITHIN_ONE
    np.testing.assert_array_equal(out, JNativeSIFT(**kwargs)._extract(imgs))


def test_native_sift_apply_batch_dataset():
    rng = np.random.default_rng(1)
    imgs = rng.random((3, 48, 48, 1), dtype=np.float32)
    ext = NativeSIFTExtractor(step_size=4, bin_size=4, scales=1)
    out = ext.apply_batch(ArrayDataset(imgs, device=CPU))
    assert out.data.shape[0] == 3 and out.data.shape[2] == 128 and out.device == CPU
    assert ext.grid_counts(48, 48) == SIFTExtractor(4, 4, 1).grid_counts(48, 48)
    np.testing.assert_array_equal(ext.apply(imgs[0]), out.data[0].numpy())


# -------------------------------------------------------------------- GMM


def test_native_gmm_recovers_clusters_as_the_jax_packages_build():
    rng = np.random.default_rng(2)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [-8.0, 8.0]], np.float32)
    x = np.concatenate(
        [c + 0.3 * rng.standard_normal((200, 2)).astype(np.float32) for c in centers]
    )
    gmm = native_gmm_fit(x, k=3, seed=0, device=CPU)
    means = gmm.means.numpy().T  # (k, d)
    for c in centers:
        assert np.min(np.linalg.norm(means - c, axis=1)) < 0.5
    np.testing.assert_allclose(gmm.weights.numpy().sum(), 1.0, atol=1e-4)
    want = jnative_gmm_fit(x, k=3, seed=0)
    np.testing.assert_array_equal(gmm.means.numpy(), np.asarray(want.means))
    np.testing.assert_array_equal(gmm.variances.numpy(), np.asarray(want.variances))
    np.testing.assert_array_equal(gmm.weights.numpy(), np.asarray(want.weights))
    with pytest.raises(ValueError, match="at least k"):
        native_gmm_fit(x[:2], k=3, device=CPU)


def test_native_fisher_matches_the_ports_fisher_vector():
    rng = np.random.default_rng(3)
    d, k = 6, 4
    params = dict(means=rng.standard_normal((d, k)).astype(np.float32),
                  variances=(0.5 + rng.random((d, k))).astype(np.float32),
                  weights=np.full(k, 1.0 / k, np.float32))
    gmm = GaussianMixtureModel(**params, device=CPU)
    x = rng.standard_normal((5, 30, d)).astype(np.float32)
    ref = FisherVector(gmm).apply_arrays(torch.from_numpy(x)).numpy()
    out = NativeFisherVector(gmm).apply_batch(ArrayDataset(x, device=CPU)).data.numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    want = np.stack([JNativeFisherVector(JGaussianMixtureModel(**params)).apply(m) for m in x])
    np.testing.assert_array_equal(out, want)


def test_native_gmm_fisher_estimator_pools_descriptors():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 50, 3)).astype(np.float32)
    enc = NativeGMMFisherVectorEstimator(k=2, seed=1).fit(ArrayDataset(x, device=CPU))
    assert enc.gmm.k == 2 and enc.gmm.means.device == CPU
    assert enc.apply(x[0]).shape == (3, 4)


# ------------------------------------------------------------------ decode


def test_native_jpeg_decode_matches_pil_and_the_jax_build():
    rng = np.random.default_rng(4)
    arrs = [rng.integers(0, 256, size=(32, 40, 3), dtype=np.uint8) for _ in range(3)]
    raw = [_jpeg_bytes(a) for a in arrs]
    out, ok = archive.native_decode_batch(raw + [b"not a jpeg"], resize=(32, 40))
    assert ok.tolist() == [True, True, True, False]
    assert not out[3].any()
    for i, b in enumerate(raw):
        ref = load_image(b)  # PIL path, BGR (X=rows, Y=cols, C)
        assert out[i].shape == ref.shape
        assert np.mean(np.abs(out[i] - ref)) < 1.5
    want, want_ok = jarchive.native_decode_batch(raw + [b"not a jpeg"], resize=(32, 40))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ok, want_ok)
    empty, empty_ok = archive.native_decode_batch([], resize=(8, 8))
    assert empty.shape == (0, 8, 8, 3) and empty_ok.shape == (0,)


def test_native_jpeg_resize_keeps_bgr_order():
    solid = np.full((64, 48, 3), 128, dtype=np.uint8)
    solid[:, :, 0] = 200  # R=200 G=128 B=128
    out, ok = archive.native_decode_batch([_jpeg_bytes(solid)], resize=(16, 16))
    assert ok[0]
    assert abs(float(out[0][..., 2].mean()) - 200.0) < 6.0
    assert abs(float(out[0][..., 0].mean()) - 128.0) < 6.0


def test_native_jpeg_scaled_decode_matches_pil_resize():
    x = np.linspace(0, 255, 320)
    arr = np.clip(np.add.outer(x, 2 * x) / 3, 0, 255).astype(np.uint8)
    arr = np.stack([arr, arr[::-1], arr.T], axis=-1)
    raw = _jpeg_bytes(arr)
    out, ok = archive.native_decode_batch([raw], resize=(64, 64))  # 320/64 → denominator 4
    assert ok[0]
    ref = PILImage.open(io.BytesIO(raw)).convert("RGB").resize((64, 64), PILImage.BILINEAR)
    ref_bgr = np.asarray(ref, np.float32)[..., ::-1]
    assert np.mean(np.abs(out[0] - ref_bgr)) < 3.0


def _tar(tmp_path, payloads):
    tar_path = tmp_path / "imgs.tar"
    with tarfile.open(tar_path, "w") as tar:
        for name, payload in payloads:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return str(tar_path)


def test_loader_native_path_matches_pil_and_the_jax_loaders_native_path(tmp_path):
    rng = np.random.default_rng(5)
    payloads = [(f"cls/img{i}.jpg", _jpeg_bytes(rng.integers(0, 256, size=(40, 40, 3), dtype=np.uint8)))
                for i in range(4)]
    png = io.BytesIO()
    PILImage.fromarray(rng.integers(0, 256, size=(30, 20, 3), dtype=np.uint8)).save(png, format="PNG")
    payloads.append(("cls/img4.png", png.getvalue()))  # libjpeg refuses it: decoded by PIL
    tar_path = _tar(tmp_path, payloads)
    kwargs = dict(label_fn=lambda name: 0, resize=(24, 24))
    ds_native = archive.load_image_archives(tar_path, use_native=True, **kwargs)
    ds_default = archive.load_image_archives(tar_path, **kwargs)
    ds_pil = archive.load_image_archives(tar_path, use_native=False, **kwargs)
    ds_jax = jarchive.load_image_archives(tar_path, use_native=True, **kwargs)
    assert len(ds_native) == len(ds_pil) == len(ds_jax) == 5
    for a, b, c, j in zip(ds_native.collect(), ds_pil.collect(), ds_default.collect(), ds_jax.collect()):
        assert a["filename"] == b["filename"] == c["filename"] == j["filename"]
        assert a["image"].shape == b["image"].shape == (24, 24, 3)
        assert a["image"].dtype == np.float32
        assert np.mean(np.abs(a["image"] - b["image"])) < 20.0
        np.testing.assert_array_equal(a["image"], c["image"])
        np.testing.assert_array_equal(a["image"], j["image"])
    with pytest.raises(ValueError, match="resize target"):
        archive.load_image_archives(tar_path, lambda name: 0, use_native=True)


# ------------------------------------------------------------------ ingest


def test_jpeg_tar_fixture_equals_the_jax_packages_and_measure_ingest_counts(tmp_path):
    got = ingest.build_jpeg_tar_fixture(str(tmp_path / "port.tar"), 20, size=64, seed=3)
    want = jingest.build_jpeg_tar_fixture(str(tmp_path / "jax.tar"), 20, size=64, seed=3)
    with open(got, "rb") as a, open(want, "rb") as b:
        ta, tb = tarfile.open(fileobj=a), tarfile.open(fileobj=b)
        assert [m.name for m in ta] == [m.name for m in tb]
        for m in ta:
            assert ta.extractfile(m).read() == tb.extractfile(m.name).read()
    assert ingest.build_jpeg_tar_fixture(got, 20, size=64, seed=3) == got  # cached
    with tarfile.open(got, "a") as tar:
        info = tarfile.TarInfo("synset0000/broken.JPEG")
        info.size = 9
        tar.addfile(info, io.BytesIO(b"not jpeg!"))
    out = ingest.measure_ingest(got, resize=(32, 32), batch=8)
    assert out["images"] == 20 and out["corrupt_skipped"] == 1
    assert out["images_per_sec_decode"] > 0
    shapes = []
    overlapped = ingest.measure_ingest(got, resize=(32, 32), batch=8,
                                       featurize=lambda imgs: shapes.append(imgs.shape))
    assert shapes[0] == (8, 32, 32, 3) and sum(s[0] for s in shapes) == 21
    assert overlapped["images_per_sec_overlapped"] > 0
