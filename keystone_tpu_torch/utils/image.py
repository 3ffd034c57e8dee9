"""Image representation and host-side image helpers.

Port of ``keystone_tpu/utils/image.py`` (a copy: these are host numpy
functions there too). One convention:

- a single image is an array of shape ``(X, Y, C)`` indexed
  ``img[x, y, c]`` (the reference's ``Image.get(x, y, c)``);
- a batch is ``(N, X, Y, C)``;
- the *vectorized* form flattens with index ``c + x*C + y*C*X`` (c
  fastest, then x, then y; reference: utils/images/Image.scala:143-368).

Helpers mirror utils/images/ImageUtils.scala:9-421 (grayscale luminance
weights, separable conv2D, crop, flips), and ``load_image`` decodes with
PIL as the JAX package does (BGR channel order).
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class ImageMetadata:
    """Shape metadata (reference: utils/images/Image.scala ImageMetadata)."""

    x_dim: int
    y_dim: int
    num_channels: int

    @staticmethod
    def of(img: np.ndarray) -> "ImageMetadata":
        x, y, c = img.shape[-3], img.shape[-2], img.shape[-1]
        return ImageMetadata(x, y, c)


def vectorize(img: np.ndarray) -> np.ndarray:
    """Channel-major flatten: out[c + x*C + y*C*X] = img[x, y, c], for one
    image (X, Y, C) or a batch (N, X, Y, C)."""
    a = np.asarray(img)
    if a.ndim == 3:
        return np.ascontiguousarray(a.transpose(1, 0, 2)).reshape(-1)
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(a.shape[0], -1)


def unvectorize(vec: np.ndarray, meta: ImageMetadata) -> np.ndarray:
    """Inverse of :func:`vectorize`."""
    a = np.asarray(vec)
    shape = (meta.y_dim, meta.x_dim, meta.num_channels)
    if a.ndim == 1:
        return a.reshape(shape).transpose(1, 0, 2)
    return a.reshape((a.shape[0],) + shape).transpose(0, 2, 1, 3)


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """NTSC grayscale (reference: utils/images/ImageUtils.scala:73-103).

    For 3-channel images the reference assumes **BGR** channel order and
    computes 0.2989*R + 0.5870*G + 0.1140*B from channels (2, 1, 0); for
    other channel counts it takes sqrt(mean(channel²))."""
    img = np.asarray(img, dtype=np.float64)
    if img.shape[-1] == 3:
        gray = 0.2989 * img[..., 2] + 0.5870 * img[..., 1] + 0.1140 * img[..., 0]
    else:
        gray = np.sqrt(np.mean(img**2, axis=-1))
    return gray[..., None]


def crop(img: np.ndarray, start_x: int, start_y: int, end_x: int, end_y: int) -> np.ndarray:
    """Crop to [start_x, end_x) × [start_y, end_y)
    (reference: utils/images/ImageUtils.scala:147-180)."""
    x_dim, y_dim = img.shape[-3], img.shape[-2]
    if not (0 <= start_x <= end_x <= x_dim and 0 <= start_y <= end_y <= y_dim):
        raise ValueError("invalid crop bounds")
    return img[..., start_x:end_x, start_y:end_y, :]


def flip_horizontal(img: np.ndarray) -> np.ndarray:
    """Reverse the y (second spatial) axis (reference: ImageUtils.flipHorizontal)."""
    return img[..., :, ::-1, :]


def flip_image(img: np.ndarray) -> np.ndarray:
    """Reverse both spatial axes (reference: ImageUtils.flipImage, used for
    MATLAB-convn-compatible filter flipping in ``Convolver.create``)."""
    return img[..., ::-1, ::-1, :]


def split_channels(img: np.ndarray) -> Sequence[np.ndarray]:
    """One single-channel image per channel (reference: ImageUtils.splitChannels)."""
    return [img[..., c : c + 1] for c in range(img.shape[-1])]


def conv2d_separable(img: np.ndarray, x_filter: np.ndarray, y_filter: np.ndarray) -> np.ndarray:
    """'Same' separable 2-D convolution with zero padding
    (reference: utils/images/ImageUtils.scala:226-290): each channel is
    convolved with ``x_filter`` along x and ``y_filter`` along y (true
    convolution: filters flipped); the result has the input's shape."""
    from scipy.ndimage import convolve1d

    img = np.asarray(img, dtype=np.float64)
    out = convolve1d(img, np.asarray(x_filter, dtype=np.float64), axis=-3, mode="constant")
    return convolve1d(out, np.asarray(y_filter, dtype=np.float64), axis=-2, mode="constant")


def load_image(source, expected_channels: int = 3) -> Optional[np.ndarray]:
    """Decode an image file / byte stream into an (X, Y, C) float array.

    Replaces the reference's ImageIO-based loader
    (reference: utils/images/ImageUtils.scala loadImage +
    utils/images/ImageConversions.scala:5-80). Like the reference, returns
    channels in **BGR** order for color images so downstream grayscale /
    LCS semantics line up, and None on undecodable input.
    """
    from PIL import Image as PILImage

    try:
        if isinstance(source, (bytes, bytearray)):
            source = io.BytesIO(source)
        pil = PILImage.open(source)
        pil = pil.convert("RGB") if expected_channels == 3 else pil.convert("L")
        arr = np.asarray(pil, dtype=np.float64)  # (rows=height, cols=width, C) RGB
    except Exception:
        return None
    if arr.ndim == 2:
        arr = arr[..., None]
    if expected_channels == 3:
        arr = arr[..., ::-1]  # RGB -> BGR, matching the reference's loader
    # PIL gives (row, col); the framework's (x, y) spatial indexing matches
    # the reference's (row-ish, col-ish) — keep axis order as-is.
    return np.ascontiguousarray(arr)
