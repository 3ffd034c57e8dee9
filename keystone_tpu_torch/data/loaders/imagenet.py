"""ImageNet tar-of-JPEG loader.

Port of ``keystone_tpu/data/loaders/imagenet.py`` (reference:
loaders/ImageNetLoader.scala:11-39), a host-side copy. Each tar file
holds JPEGs inside one directory per class; the directory name keys into
a space-separated ``className label`` map file.

Records are ``{"image": (X, Y, C) float BGR array, "label": int,
"filename": str}``; with ``resize`` set they stack into an
``ArrayDataset`` for whole-batch featurization on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..dataset import ObjectDataset
from .archive import load_image_archives

NUM_CLASSES = 1000


def read_label_map(labels_path: str) -> Dict[str, int]:
    """``className label`` lines → dict
    (reference: ImageNetLoader.scala:27-32)."""
    out: Dict[str, int] = {}
    with open(labels_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            out[parts[0]] = int(parts[1])
    return out


def load_imagenet(
    data_path: str,
    labels_path: str,
    resize: Optional[Tuple[int, int]] = None,
    num_workers: Optional[int] = None,  # None → KEYSTONE_INGEST_WORKERS default
    use_native: Optional[bool] = None,
) -> ObjectDataset:
    """Load every image under ``data_path`` (a tar file or a directory of
    tar files), labeling by the entry's leading directory name
    (reference: ImageNetLoader.scala:34-38). ``use_native``: see
    :func:`~keystone_tpu_torch.data.loaders.archive.load_image_archives`."""
    label_map = read_label_map(labels_path)

    def label_fn(entry_name: str) -> int:
        return label_map[entry_name.split("/")[0]]

    return load_image_archives(
        data_path, label_fn, resize=resize, num_workers=num_workers, use_native=use_native
    )
