"""Tar-of-images ingestion shared by the image loaders.

Port of ``keystone_tpu/data/loaders/archive.py`` (reference:
loaders/ImageLoaderUtils.scala:23-96 ``getFilePathsRDD`` / ``loadFiles``),
a host-side copy: tar entries are read sequentially (tar has no index)
while JPEG decode + resize fans out, either over a thread pool through
PIL (which releases the interpreter lock while it decodes) or, with a
resize target, through the native libjpeg kernel
(``keystone_tpu_torch/native/src/decode.cpp``, OpenMP over images).
``_resize_image`` is the JAX package's PIL bilinear resize and the
native kernel is its copy, so each path's arrays are bit-equal to the
JAX loader's on the same path.

Loaders take an optional ``resize=(x, y)`` that produces uniform arrays
ready for ``ArrayDataset`` stacking; without it they return per-image
dict records in an ``ObjectDataset``.
"""

from __future__ import annotations

import glob
import itertools
import os
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ...reliability.faultinject import probe
from ...reliability.recovery import QuarantineCounts
from ...utils.image import load_image
from ..dataset import ObjectDataset, default_ingest_workers


def list_archives(data_path: str) -> List[str]:
    """All regular files under a directory, or the path itself if it is a
    file (reference: ImageLoaderUtils.scala:33-40 getFilePathsRDD)."""
    if os.path.isfile(data_path):
        return [data_path]
    if os.path.isdir(data_path):
        return sorted(
            p for p in glob.glob(os.path.join(data_path, "*")) if os.path.isfile(p)
        )
    raise FileNotFoundError(f"no archive(s) at {data_path}")


def _resize_image(arr: np.ndarray, resize: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize an (X, Y, C) float array to (resize[0], resize[1], C)."""
    from PIL import Image as PILImage

    x_dim, y_dim = resize
    if arr.shape[0] == x_dim and arr.shape[1] == y_dim:
        return arr
    chans = []
    for c in range(arr.shape[2]):
        pil = PILImage.fromarray(arr[..., c].astype(np.float32), mode="F")
        # PIL sizes are (width, height) = (second axis, first axis).
        chans.append(np.asarray(pil.resize((y_dim, x_dim), PILImage.BILINEAR)))
    return np.stack(chans, axis=-1).astype(np.float64)


def iter_tar_entries(
    archive_path: str, name_prefix: Optional[str] = None
) -> Iterator[Tuple[str, bytes]]:
    """Yield (entry_name, raw_bytes) for regular entries, optionally
    filtered by prefix (reference: ImageLoaderUtils.scala:70-90). Files
    that are not tar archives are skipped (a data directory may hold label
    files next to its shards)."""
    try:
        tar_cm = tarfile.open(archive_path, mode="r:*")
    except tarfile.ReadError:
        return
    with tar_cm as tar:
        for entry in tar:
            if not entry.isfile():
                continue
            if name_prefix is not None and not entry.name.startswith(name_prefix):
                continue
            fobj = tar.extractfile(entry)
            if fobj is None:
                continue
            yield entry.name, fobj.read()


def native_decode_batch(
    raw: List[bytes], resize: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch of JPEGs through the native libjpeg kernel
    (``ks_decode_jpeg_batch``) and resize each bilinearly to ``resize``:
    ``(images (n, X, Y, 3) float32 BGR, ok (n,) bool)``. An entry libjpeg
    cannot decode is left zero with ``ok`` False. Builds the decode
    library at first use; raises if it cannot be built."""
    import ctypes

    from ... import native

    lib = native.load("decode")
    n = len(raw)
    x_dim, y_dim = resize
    bufs = (ctypes.POINTER(ctypes.c_ubyte) * max(n, 1))()
    lens = (ctypes.c_longlong * max(n, 1))()
    keepalive = []
    for i, b in enumerate(raw):
        arr = np.frombuffer(b, dtype=np.uint8)
        keepalive.append(arr)
        bufs[i] = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        lens[i] = len(b)
    out = np.zeros((n, x_dim, y_dim, 3), dtype=np.float32)
    ok = np.zeros(n, dtype=np.uint8)
    if n:
        lib.ks_decode_jpeg_batch(
            bufs, lens, n, x_dim, y_dim,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
    return out, ok.astype(bool)


def load_image_archives(
    data_path: str,
    label_fn: Callable[[str], Any],
    name_prefix: Optional[str] = None,
    resize: Optional[Tuple[int, int]] = None,
    num_workers: Optional[int] = None,
    label_key: str = "label",
    use_native: Optional[bool] = None,
) -> ObjectDataset:
    """Stream every image out of the tar(s) at ``data_path`` into records
    ``{"image": (X, Y, C) float array, label_key: label_fn(entry_name),
    "filename": entry_name}``.

    Entries whose ``label_fn`` raises KeyError or whose bytes fail to
    decode are skipped and quarantined (reference:
    ImageLoaderUtils.scala:84-88), with the counts surfaced: the returned
    dataset carries a ``.quarantine`` dict and the totals land in the
    process recovery log.

    ``use_native``: ``True`` decodes and resizes through the native
    libjpeg kernel (it needs ``resize``), ``False`` through PIL on
    threads, ``None`` (the default) natively when ``resize`` is set and
    through PIL otherwise — the JAX package's choice with its native
    library built. The native path builds its library at first use and
    raises if it cannot (a machine without libjpeg's ``jpeglib.h``): pass
    ``use_native=False`` there. Entries libjpeg cannot decode (PNG, BMP,
    CMYK JPEG) go through the PIL path, as in the JAX package, so a
    dataset's contents do not depend on the path. ``num_workers=None``
    resolves through :func:`~keystone_tpu_torch.data.dataset.default_ingest_workers`
    (``KEYSTONE_INGEST_WORKERS``).
    """
    if use_native is None:
        use_native = resize is not None
    if use_native and resize is None:
        raise ValueError("native decode requires a resize target")
    if num_workers is None:
        num_workers = default_ingest_workers()
    quarantine = QuarantineCounts()

    def decode(item: Tuple[str, bytes]) -> Optional[Dict[str, Any]]:
        name, raw = item
        try:
            label = label_fn(name)
        except KeyError:
            quarantine.add("label_missing", name)
            return None
        img = load_image(raw)
        if img is None:
            quarantine.add("decode_failed", name)
            return None
        if resize is not None:
            img = _resize_image(img, resize)
        return {"image": img, label_key: label, "filename": name}

    records: List[Dict[str, Any]] = []
    archives = [p for p in list_archives(data_path) if tarfile.is_tarfile(p)]
    # Chunked submission keeps only ~2 decode-rounds of raw bytes in
    # flight — draining the raw generator into queued futures would pull
    # the whole tar into memory before the first decode finishes.
    chunk = max(1, 2 * num_workers)
    if use_native:
        for archive in archives:
            entries = iter_tar_entries(archive, name_prefix)
            while True:
                batch = list(itertools.islice(entries, chunk * 8))
                if not batch:
                    break
                probe("ingest.decode_batch")
                labeled = []
                for name, raw in batch:
                    try:
                        labeled.append((name, raw, label_fn(name)))
                    except KeyError:
                        quarantine.add("label_missing", name)
                if not labeled:
                    continue
                images, ok = native_decode_batch([r for _, r, _ in labeled], resize)
                for i, (name, raw, label) in enumerate(labeled):
                    if ok[i]:
                        records.append({"image": images[i], label_key: label, "filename": name})
                        continue
                    rec = decode((name, raw))
                    if rec is not None:
                        rec["image"] = rec["image"].astype(np.float32)
                        records.append(rec)
        return _finish(records, quarantine)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for archive in archives:
            entries = iter_tar_entries(archive, name_prefix)
            while True:
                batch = list(itertools.islice(entries, chunk))
                if not batch:
                    break
                probe("ingest.decode_batch")
                for rec in pool.map(decode, batch):
                    if rec is not None:
                        records.append(rec)
    return _finish(records, quarantine)


def _finish(records, quarantine: QuarantineCounts) -> ObjectDataset:
    quarantine.publish("load_image_archives")
    ds = ObjectDataset(records)
    ds.quarantine = quarantine.as_dict()
    return ds
