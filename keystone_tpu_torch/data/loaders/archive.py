"""Tar-of-images ingestion shared by the image loaders.

Port of ``keystone_tpu/data/loaders/archive.py`` (reference:
loaders/ImageLoaderUtils.scala:23-96 ``getFilePathsRDD`` / ``loadFiles``),
a host-side copy: tar entries are read sequentially (tar has no index)
while JPEG decode + resize fans out over a thread pool (PIL releases the
interpreter lock while it decodes). ``_resize_image`` is the JAX
package's PIL bilinear resize, so resized arrays are bit-equal to its
loader's.

Loaders take an optional ``resize=(x, y)`` that produces uniform arrays
ready for ``ArrayDataset`` stacking; without it they return per-image
dict records in an ``ObjectDataset``.

Left out for now: the native libjpeg decode (``use_native=True`` raises,
naming ROADMAP item 10d, which ports the native host kernels).
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

    ``use_native=None`` and ``False`` decode with PIL; ``True`` raises
    until ROADMAP item 10d ports the native decode. ``num_workers=None``
    resolves through :func:`~keystone_tpu_torch.data.dataset.default_ingest_workers`
    (``KEYSTONE_INGEST_WORKERS``).
    """
    if use_native:
        raise NotImplementedError(
            "native JPEG decode is not ported yet (ROADMAP item 10d); "
            "use_native=None or False decodes with PIL"
        )
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
