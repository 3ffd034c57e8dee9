"""Boot images: a worker's warm state, built once, loaded by every fresh
worker. Port of ``keystone_tpu/serving/bootimage.py``.

The JAX image bundles one ``jax.export`` executable per bucket and the
persistent XLA cache entries they hydrate from. A PyTorch worker has no
cross-process executable for a model whose products go through the
port's ctypes cuBLAS binding (``torch.export``, TorchScript and Inductor
cannot capture those calls), so the port's image carries what a fresh
worker would otherwise build or discover at boot:

- ``model.pkl`` — the fitted model, as the worker serves it (fused plan).
- ``cache/`` — the nvcc-built kernel libraries the model's apply used in
  the build's parity run (``libsolver_gemm-<hash>.so``): the port's
  compile cache.
  :func:`load_boot_image` places each where ``ops/cuda/_build.py`` looks,
  only when its hash is the one this checkout's sources give and the file
  is missing, so a worker booted from an image runs no ``nvcc``.
- ``manifest.json`` — the fingerprints KV307 compares (format, torch and
  CUDA versions, card name and compute capability, the kernel sources'
  hash, the weights digest), the buckets, the example request spec, and
  for each bucket the digest of the outputs of the build-time parity run
  at full and at partial occupancy.

Staleness is a refusal, never silent garbage: ``load_boot_image`` runs
:func:`~keystone_tpu_torch.workflow.verify.verify_boot_image` (KV307)
over the fingerprints, then warms every bucket on seeded inputs and
holds the outputs to the manifest's digests; any mismatch raises
:class:`BootImageRefused` and the worker falls back to the classic warm
path and says so in the recovery ledger. Build time carries the
complementary gate: the saved model is re-loaded and must reproduce the
in-memory model's digests before the manifest is written.

With an image a worker knows its request shape before the first request
(the manifest's example), so it warms every bucket before it reports
ready; a classic worker serving an artifact warms at its first request.

Layout of an image directory::

    manifest.json
    model.pkl
    cache/lib<name>-<hash>.so

Module import stays torch-free; torch loads inside build and load.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs import names as _names

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
WEIGHTS = "model.pkl"
CACHE_DIR = "cache"


class BootImageError(RuntimeError):
    """Build-side failure: the image could not be produced soundly."""


class BootImageRefused(RuntimeError):
    """Load-side refusal: KV307 fingerprint mismatch, a parity digest
    that does not reproduce, or a corrupt artifact. Carries the verify
    report when one was produced."""

    def __init__(self, message: str, report: Any = None):
        super().__init__(message)
        self.report = report


def environment_fingerprints(device: Any) -> Dict[str, Any]:
    """The loading/building process's side of the KV307 comparison."""
    import torch

    from ..ops.cuda import _build

    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        capability = list(torch.cuda.get_device_capability(device))
    else:
        name, capability = device.type, None
    return {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": name,
        "compute_capability": capability,
        "kernel_sources": _build.sources_hash(),
    }


def _digest(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fallback_apply(model: Any):
    """The classic apply path for ``model``, in
    :meth:`ModelEntry.batch_apply`'s resolution order."""
    compiled = getattr(model, "compiled_apply", None)
    if compiled is not None:
        return compiled()
    apply_batch = getattr(model, "apply_batch", None)
    if apply_batch is not None:
        return apply_batch
    batch_transform = getattr(model, "batch_transform", None)
    if batch_transform is not None:
        return lambda dataset: batch_transform([dataset])
    raise BootImageError(
        f"model ({type(model).__name__}) has no apply path (expected "
        "compiled_apply / apply_batch / batch_transform)"
    )


def _rows_digest(out: Any, n: int) -> str:
    """sha1 over the first ``n`` rows of every output leaf, on the host."""
    import numpy as np
    import torch

    from ..utils.tree import tree_leaves

    h = hashlib.sha1()
    for leaf in tree_leaves(getattr(out, "data", out)):
        host = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        rows = np.ascontiguousarray(host[:n])
        h.update(f"{rows.dtype.str}{rows.shape}".encode() + rows.tobytes())
    return h.hexdigest()


def _parity_digests(
    batch_apply: Any, example: Dict[str, Any], buckets: Sequence[int], device: Any
) -> Dict[str, Dict[str, str]]:
    """Run every bucket on seeded inputs at full occupancy and at one row
    short of it (the pad-row path), returning each output's digest. The
    run warms each bucket, as ``PipelineServer.warmup`` does."""
    import numpy as np
    import torch

    from ..data.dataset import ArrayDataset

    shape, dtype = tuple(example["shape"]), np.dtype(example["dtype"])
    out: Dict[str, Dict[str, str]] = {}
    for b in buckets:
        x = np.random.default_rng(b).standard_normal((b,) + shape).astype(dtype)
        out[str(b)] = {
            tag: _rows_digest(batch_apply(ArrayDataset(x, num_examples=n, device=device)), n)
            for tag, n in (("full", b), ("partial", max(1, b - 1)))
        }
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _save_model(model: Any, path: str) -> None:
    import torch

    # The checkpoint store's format (reliability/checkpoint.py says why).
    torch.save(model, path, pickle_protocol=5, _use_new_zipfile_serialization=False)


def _load_model(path: str, device: Any) -> Any:
    import torch

    return torch.load(path, map_location=device, weights_only=False)


class BootImageModel:
    """A served model loaded from a boot image: the fitted model's classic
    apply, with the image's manifest beside it. Exposes ``apply_batch``
    (not ``compiled_apply``) so :meth:`ModelEntry.batch_apply` routes
    here."""

    def __init__(self, manifest: Dict[str, Any], model: Any):
        self.manifest = manifest
        self.model = model
        self._apply = _fallback_apply(model)

    @property
    def buckets(self) -> Tuple[int, ...]:
        return tuple(int(b) for b in self.manifest["buckets"])

    def apply_batch(self, dataset: Any) -> Any:
        return self._apply(dataset)


def build_boot_image(
    spec: Dict[str, Any],
    out_dir: str,
    *,
    buckets: Optional[Sequence[int]] = None,
    model_name: str = "default",
    max_batch: int = 8,
    example: Any = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Build a boot image for the model ``spec`` names (the spec doors a
    worker accepts) into ``out_dir``, on ``device`` (default CUDA).
    ``example`` is one request payload; it is required when the spec
    implies no request shape (an artifact or checkpoint entry). Returns
    the manifest. Raises :class:`BootImageError` when the saved model
    does not reproduce the in-memory model's parity digests."""
    import numpy as np

    from ..device import resolve_device
    from ..ops.cuda import _build
    from .config import default_bucket_sizes
    from .registry import ModelRegistry
    from .worker import _load_spec

    t0 = time.perf_counter()
    device = resolve_device(device)
    buckets = tuple(sorted({int(b) for b in (buckets or default_bucket_sizes(max_batch))}))
    registry = ModelRegistry()
    implied = _load_spec(registry, model_name, spec, device)
    example = implied if example is None else example
    if example is None:
        raise BootImageError(
            f"spec {sorted(spec)} implies no request shape; pass example= "
            "(one request payload) to fix the image's input spec"
        )
    example = np.asarray(example)
    example_spec = {"shape": list(example.shape), "dtype": str(example.dtype)}
    entry = registry.resolve(model_name)
    uses_before = dict(_build.use_counts)
    parity = _parity_digests(entry.batch_apply, example_spec, buckets, device)
    used = sorted(n for n, c in _build.use_counts.items() if c > uses_before.get(n, 0))

    os.makedirs(os.path.join(out_dir, CACHE_DIR), exist_ok=True)
    weights = os.path.join(out_dir, WEIGHTS)
    _save_model(entry.model, weights)
    # The build-time gate: the model a worker will load must answer
    # exactly as the one in memory, at every bucket and occupancy.
    reloaded = _parity_digests(
        _fallback_apply(_load_model(weights, device)), example_spec, buckets, device
    )
    if reloaded != parity:
        bad = sorted(b for b in parity if parity[b] != reloaded.get(b))
        raise BootImageError(
            f"parity gate failed at buckets {bad}: the saved model does not "
            "reproduce the in-memory model's outputs — image not written"
        )
    libraries: List[str] = []
    for name in used:
        path = _build.library_path(name)
        if path.exists():
            shutil.copy2(path, os.path.join(out_dir, CACHE_DIR, path.name))
            libraries.append(path.name)

    manifest: Dict[str, Any] = dict(environment_fingerprints(device))
    manifest.update(
        {
            "model_name": model_name,
            "model_version": entry.version,
            "source": entry.source,
            "created_at": time.time(),
            "buckets": list(buckets),
            "example": example_spec,
            "weights_digest": _digest(weights),
            "parity": parity,
            "libraries": libraries,
        }
    )
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    _names.metric(_names.BOOTIMAGE_BUILDS).inc()
    _names.metric(_names.BOOTIMAGE_BUILD_SECONDS).observe(time.perf_counter() - t0)
    return manifest


def _install_libraries(image_cache: str) -> List[str]:
    """Copy each bundled library where ``_build`` looks, when its name is
    the one this checkout's sources give and the file is missing. Returns
    the names placed."""
    from ..ops.cuda import _build

    if not os.path.isdir(image_cache):
        return []
    placed = []
    for filename in sorted(os.listdir(image_cache)):
        if not (filename.startswith("lib") and filename.endswith(".so") and "-" in filename):
            continue
        target = _build.library_path(filename[3:].rsplit("-", 1)[0])
        if target.name != filename or target.exists():
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        shutil.copy2(os.path.join(image_cache, filename), tmp)
        os.replace(tmp, target)
        placed.append(filename)
    return placed


def load_boot_image(image_dir: str, device: Any = None, verify: bool = True) -> BootImageModel:
    """Load a boot image onto ``device`` (default CUDA): KV307-verify the
    manifest fingerprints, place the bundled kernel libraries, load the
    model, and warm every bucket against the manifest's parity digests.
    Raises :class:`BootImageRefused` on any mismatch (``KEYSTONE_VERIFY=off``
    or ``verify=False`` skips the fingerprint gate, never the digests) or a
    corrupt artifact — callers fall back to the classic warm path."""
    from ..device import resolve_device
    from ..reliability.recovery import get_recovery_log
    from ..workflow.verify import verification_mode, verify_boot_image

    t0 = time.perf_counter()
    device = resolve_device(device)
    loads = _names.metric(_names.BOOTIMAGE_LOADS)

    def refuse(message: str, report: Any = None, **detail: Any) -> BootImageRefused:
        loads.inc(status="refused")
        get_recovery_log().record("bootimage_refused", image_dir, **detail)
        return BootImageRefused(message, report=report)

    try:
        with open(os.path.join(image_dir, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise refuse(f"unreadable boot image manifest: {exc}", codes=["unreadable"])
    weights = os.path.join(image_dir, WEIGHTS)
    current = environment_fingerprints(device)
    current["weights_digest"] = _digest(weights) if os.path.exists(weights) else None
    if verify and verification_mode() != "off":
        report = verify_boot_image(manifest, current)
        if not report.ok:
            raise refuse(
                "boot image refused (KV307): " + "; ".join(d.message for d in report.errors()),
                report=report,
                codes=[d.code for d in report.errors()],
                fields=[d.details.get("field") for d in report.errors()],
            )
    placed = _install_libraries(os.path.join(image_dir, CACHE_DIR))
    try:
        image = BootImageModel(manifest, _load_model(weights, device))
        parity = _parity_digests(image.apply_batch, manifest["example"], image.buckets, device)
    except Exception as exc:
        raise refuse(f"corrupt boot image artifact: {type(exc).__name__}: {exc}", codes=["corrupt"])
    if parity != manifest.get("parity"):
        bad = sorted(b for b in parity if parity[b] != manifest.get("parity", {}).get(b))
        raise refuse(f"boot image refused: parity digests differ at buckets {bad}", codes=["parity"], buckets=bad)
    loads.inc(status="loaded")
    _names.metric(_names.BOOTIMAGE_LOAD_SECONDS).observe(time.perf_counter() - t0)
    get_recovery_log().record(
        "bootimage_loaded",
        image_dir,
        buckets=manifest.get("buckets"),
        model_version=manifest.get("model_version"),
        libraries_placed=placed,
    )
    return image
