"""CIFAR-10 binary loader.

Port of ``keystone_tpu/data/loaders/cifar.py`` (reference:
loaders/CifarLoader.scala:41-88): fixed-size records of 1 label byte +
32·32·3 pixel bytes, channel-planar (R plane, G plane, B plane),
row-major within a plane, decoded with one numpy reshape into the
(N, X, Y, C) batch layout where ``img[x, y, c] = record[c·1024 + x·32 + y]``.
"""

from __future__ import annotations

import numpy as np

from ...device import DeviceLike
from ..dataset import ArrayDataset

CIFAR_DIM = 32
CIFAR_CHANNELS = 3
_RECORD = 1 + CIFAR_DIM * CIFAR_DIM * CIFAR_CHANNELS


def load_cifar(path: str, max_images: int | None = None, device: DeviceLike = None) -> ArrayDataset:
    """Parse a CIFAR-10 binary file into ``ArrayDataset({"image": (N,32,32,3)
    float32, "label": (N,) int32})`` on ``device`` (default CUDA)."""
    return decode_cifar_bytes(np.fromfile(path, dtype=np.uint8), max_images, device=device)


def decode_cifar_bytes(data, max_images: int | None = None, device: DeviceLike = None) -> ArrayDataset:
    """Decode CIFAR-10 records from ``bytes`` or a uint8 array."""
    raw = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) else np.asarray(data)
    n = len(raw) // _RECORD
    if max_images is not None:
        n = min(n, max_images)
    raw = raw[: n * _RECORD].reshape(n, _RECORD)
    labels = raw[:, 0].astype(np.int32)
    # (N, C, X, Y) planes -> (N, X, Y, C)
    pixels = raw[:, 1:].reshape(n, CIFAR_CHANNELS, CIFAR_DIM, CIFAR_DIM)
    images = pixels.transpose(0, 2, 3, 1).astype(np.float32)
    return ArrayDataset({"image": images, "label": labels}, device=device)
