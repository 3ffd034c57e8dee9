"""Host-side size bucketing for native-resolution image featurization.

Port of ``keystone_tpu/data/buckets.py``, a host-side copy. The
reference featurizes every image at its own size (reference:
src/main/cpp/VLFeat.cxx:170-186 takes per-call w,h;
loaders/ImageLoaderUtils.scala:133-211 keeps original dimensions); a
global resize would change the computed descriptors. Images are grouped
by their size rounded up to a granularity, each is padded to its
bucket's shape, and the true (x, y) dims ride alongside: each bucket is
one static shape, so the masked extractors run one batched pass per
bucket instead of one per image; the granularity trades padding against
the number of passes.

Padding is edge-replicate by default: the SIFT smoothing uses
edge-replication boundaries, so replicate-padded pixels make the smoothed
field inside the native region equal a native-size run's (see
``SIFTExtractor.apply_arrays_masked``). Extractors that assume zero
boundaries re-mask internally from ``dims``.

Buckets hold host numpy arrays; ``to_dataset`` / ``to_bucketed_dataset``
place them on ``device`` (default CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from .dataset import ArrayDataset, BucketedDataset, ObjectDataset


@dataclass
class ImageBucket:
    """One static-shape group: ``images`` (N, Xb, Yb, C) padded,
    ``dims`` (N, 2) true (x, y) sizes, plus aligned labels/filenames."""

    images: np.ndarray
    dims: np.ndarray
    labels: Optional[np.ndarray]
    filenames: List[str]

    @property
    def bucket_shape(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def __len__(self) -> int:
        return self.images.shape[0]

    def to_dataset(self, device: DeviceLike = None) -> ArrayDataset:
        # float32 on the device, as the masked extractors read it.
        data: Dict[str, Any] = {"image": self.images.astype(np.float32), "dims": self.dims}
        if self.labels is not None:
            data["label"] = self.labels
        return ArrayDataset(data, device=device)


def _round_up(v: int, granularity: int) -> int:
    return ((v + granularity - 1) // granularity) * granularity


def _pad_image(img: np.ndarray, xb: int, yb: int, mode: str) -> np.ndarray:
    px, py = xb - img.shape[0], yb - img.shape[1]
    if px == 0 and py == 0:
        return img
    return np.pad(img, ((0, px), (0, py), (0, 0)), mode=mode)


def bucketize_images(
    records: Iterable[Dict[str, Any]],
    granularity: int = 32,
    pad_mode: str = "edge",
    label_key: str = "label",
    max_rows: Optional[int] = None,
) -> List[ImageBucket]:
    """Group ``{"image": (X, Y, C), label_key: …, "filename": …}`` records
    (the loaders' ObjectDataset items) into padded static-shape buckets.

    Images are never resized or cropped — only zero-cost padding that the
    masked extractors exclude — so descriptors computed per bucket equal
    the per-image native-size run (the reference's behaviour).

    ``max_rows`` caps a bucket's image count by splitting large size
    groups into several same-shape buckets: one bucket is one batched
    pass, so its working set (≈ rows × padded pixels × extractor
    blow-up) must fit on the card.
    """
    groups: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
    for rec in records:
        img = np.asarray(rec["image"])
        key = (_round_up(img.shape[0], granularity), _round_up(img.shape[1], granularity))
        groups.setdefault(key, []).append(rec)

    split_groups: List[Tuple[Tuple[int, int], List[Dict[str, Any]]]] = []
    for key, recs in sorted(groups.items()):
        if max_rows is None:
            split_groups.append((key, recs))
        else:
            for start in range(0, len(recs), max_rows):
                split_groups.append((key, recs[start : start + max_rows]))

    buckets = []
    for (xb, yb), recs in split_groups:
        images = np.stack(
            [_pad_image(np.asarray(r["image"]), xb, yb, pad_mode) for r in recs]
        )
        dims = np.asarray(
            [np.asarray(r["image"]).shape[:2] for r in recs], dtype=np.int32
        )
        labels = (
            np.asarray([r[label_key] for r in recs])
            if recs and label_key in recs[0]
            else None
        )
        buckets.append(
            ImageBucket(
                images=images,
                dims=dims,
                labels=labels,
                filenames=[r.get("filename", "") for r in recs],
            )
        )
    return buckets


def bucketize_dataset(
    dataset: ObjectDataset,
    granularity: int = 32,
    pad_mode: str = "edge",
    label_key: str = "label",
    max_rows: Optional[int] = None,
) -> List[ImageBucket]:
    """Bucketize a loader's ObjectDataset (e.g. ``load_imagenet(...,
    resize=None)``)."""
    return bucketize_images(
        dataset.collect(), granularity=granularity, pad_mode=pad_mode,
        label_key=label_key, max_rows=max_rows,
    )


def to_bucketed_dataset(buckets: List[ImageBucket], device: DeviceLike = None) -> BucketedDataset:
    """Wrap ImageBuckets as a workflow-executable BucketedDataset whose
    per-bucket data is ``{"image", "dims"[, "label"]}`` on ``device`` —
    the shape the masked extractors (``ops.images.native``) consume."""
    return BucketedDataset([b.to_dataset(device) for b in buckets])


def bucket_labels(buckets: List[ImageBucket]) -> np.ndarray:
    """Labels in ``BucketedDataset.concat()`` (bucket-major) order."""
    return np.concatenate([b.labels for b in buckets])
