"""VOC 2007 multi-label tar loader.

Port of ``keystone_tpu/data/loaders/voc.py`` (reference:
loaders/VOCLoader.scala:15-52), a host-side copy. Images live in a tar
under ``VOCdevkit/VOC2007/JPEGImages/``; labels come from a CSV whose
rows carry a 1-based class id in column 1 and a quoted filename in
column 4 (header skipped). One image can carry several labels, so
records are ``{"image": arr, "labels": [int, ...], "filename": str}``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..dataset import ObjectDataset
from .archive import load_image_archives

NUM_CLASSES = 20  # fixed by the VOC 2007 dataset
DEFAULT_NAME_PREFIX = "VOCdevkit/VOC2007/JPEGImages/"


def read_voc_labels(labels_path: str) -> Dict[str, List[int]]:
    """CSV (with header) → filename → sorted list of 0-based class ids
    (reference: VOCLoader.scala:34-46)."""
    out: Dict[str, List[int]] = {}
    with open(labels_path) as f:
        lines = f.read().splitlines()
    for line in lines[1:]:
        if not line.strip():
            continue
        parts = line.split(",")
        fname = parts[4].replace('"', "")
        label = int(parts[1]) - 1
        out.setdefault(fname, []).append(label)
    return {k: sorted(set(v)) for k, v in out.items()}


def load_voc(
    data_path: str,
    labels_path: str,
    name_prefix: str = DEFAULT_NAME_PREFIX,
    resize: Optional[Tuple[int, int]] = None,
    num_workers: Optional[int] = None,  # None → KEYSTONE_INGEST_WORKERS default
    use_native: Optional[bool] = None,
) -> ObjectDataset:
    """Load the VOC tar(s); entries are matched to labels by basename so
    the label CSV's bare filenames line up with tar paths under
    ``name_prefix`` (reference: VOCLoader.scala:30,50). ``use_native``:
    see :func:`~keystone_tpu_torch.data.loaders.archive.load_image_archives`."""
    label_map = read_voc_labels(labels_path)

    def label_fn(entry_name: str) -> List[int]:
        if entry_name in label_map:
            return label_map[entry_name]
        return label_map[entry_name.rsplit("/", 1)[-1]]

    return load_image_archives(
        data_path,
        label_fn,
        name_prefix=name_prefix,
        resize=resize,
        num_workers=num_workers,
        label_key="labels",
        use_native=use_native,
    )
