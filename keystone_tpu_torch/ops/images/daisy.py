"""DAISY dense descriptors (Tola, Lepetit, Fua; TPAMI 2010).

Port of ``keystone_tpu/ops/images/daisy.py`` (reference:
nodes/images/DaisyExtractor.scala:1-201). All H orientation maps of the
batch are blurred together; the Q blur levels are cascaded convolutions
(each level blurs the previous, giving the σ-progression), and every
(keypoint, ring-point) histogram read is one gather.

Each zero-padded separable convolution (anchored like the reference's
``ImageUtils.conv2D``: pad floor((k−1)/2) low) is two products with
banded matrices through the solver binding at IEEE fp32, so it reads
none of PyTorch's process-wide TF32 switches (see ``sift.py``).

Layout per descriptor (the reference's, DaisyExtractor.scala:155-185):
H center-histogram bins at [0, H), then ring histograms at
H + angle·Q·H + level·H + bin, each L2-normalized (zeroed when the norm is
below 1e-8). Output is (N, num_keypoints, H·(T·Q+1)).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ...workflow.pipeline import BatchTransformer
from ..cuda import gemm as _gemm
from .sift import band_matrix

FEATURE_THRESHOLD = 1e-8
CONV_THRESHOLD = 1e-6


def conv2d_same(x: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    """Zero-padded same-size separable correlation over (B, X, Y), x axis
    first, at IEEE fp32."""
    b, xd, yd = x.shape

    def band(kernel, n):
        kernel = np.asarray(kernel, dtype=np.float32)
        m = band_matrix(kernel, np.arange(n), n, -((len(kernel) - 1) // 2))
        return torch.from_numpy(m).to(x.device)

    along_x = _gemm.gemm(band(kx, xd), x.permute(1, 0, 2).reshape(xd, b * yd), "ieee_fp32")
    out = _gemm.gemm(along_x.view(xd * b, yd), band(ky, yd).T, "ieee_fp32")
    return out.view(xd, b, yd).permute(1, 0, 2)


class DaisyExtractor(BatchTransformer):
    """(N, X, Y) or (N, X, Y, 1) grayscale batch → DAISY descriptors."""

    def __init__(
        self,
        daisy_t: int = 8,
        daisy_q: int = 3,
        daisy_r: int = 7,
        daisy_h: int = 8,
        pixel_border: int = 16,
        stride: int = 4,
        patch_size: int = 24,
    ):
        self.daisy_t = daisy_t
        self.daisy_q = daisy_q
        self.daisy_r = daisy_r
        self.daisy_h = daisy_h
        self.pixel_border = pixel_border
        self.stride = stride
        self.patch_size = patch_size

        # σ² progression and incremental blur kernels
        # (reference: DaisyExtractor.scala:50-64).
        sigma_sq = [(daisy_r * q / (2.0 * daisy_q)) ** 2 for q in range(daisy_q + 1)]
        diffs = [b - a for a, b in zip(sigma_sq, sigma_sq[1:])]
        self._kernels: List[np.ndarray] = []
        for t in diffs:
            radius = int(
                math.ceil(
                    math.sqrt(-2 * t * math.log(CONV_THRESHOLD) - t * math.log(2 * math.pi * t))
                )
            )
            ns = np.arange(-radius, radius + 1, dtype=np.float64)
            self._kernels.append(
                (np.exp(-(ns**2) / (2 * t)) / math.sqrt(2 * math.pi * t)).astype(np.float32)
            )

    @property
    def feature_size(self) -> int:
        return self.daisy_h * (self.daisy_t * self.daisy_q + 1)

    def _ring_offsets(self, level: int) -> List[tuple]:
        """Rounded (dx, dy) ring-point offsets for one level
        (reference: getHist, DaisyExtractor.scala:84-92 — note the
        (angleCount−1) angle quirk, kept for parity)."""
        rad = self.daisy_r * (1 + level) / self.daisy_q
        out = []
        for angle in range(self.daisy_t):
            theta = 2 * math.pi * (angle - 1) / self.daisy_t
            out.append((int(round(rad * math.sin(theta))), int(round(rad * math.cos(theta)))))
        return out

    def apply_arrays(self, x):
        if x.ndim == 4:
            x = x[..., 0]
        x = x.to(torch.float32)
        n, xd, yd = x.shape
        h, q = self.daisy_h, self.daisy_q
        if self.pixel_border < self.daisy_r + 1:
            raise ValueError("pixel_border must exceed daisy_r so ring reads stay in bounds")

        # Gradients: smoothed central difference (scala filter1/filter2).
        ix = conv2d_same(x, np.array([1.0, 0.0, -1.0]), np.array([1.0, 2.0, 1.0]))
        iy = conv2d_same(x, np.array([1.0, 2.0, 1.0]), np.array([1.0, 0.0, -1.0]))

        # H rectified orientation maps, blurred through the Q-level cascade.
        angles = 2 * math.pi * np.arange(h) / h
        coss = torch.tensor(np.cos(angles), dtype=torch.float32, device=x.device)[None, :, None, None]
        sins = torch.tensor(np.sin(angles), dtype=torch.float32, device=x.device)[None, :, None, None]
        omaps = torch.clamp_min(coss * ix[:, None] + sins * iy[:, None], 0.0).reshape(n * h, xd, yd)
        layers = []
        prev = omaps
        for level in range(q):
            prev = conv2d_same(prev, self._kernels[level], self._kernels[level])
            layers.append(prev.reshape(n, h, xd, yd))

        kx = torch.arange(self.pixel_border, xd - self.pixel_border, self.stride, device=x.device)
        ky = torch.arange(self.pixel_border, yd - self.pixel_border, self.stride, device=x.device)

        def hist(layer, dx, dy):
            """(N, nkx, nky, H) histogram at keypoints + offset, L2 per
            histogram, small ones zeroed."""
            v = layer[:, :, kx + dx][:, :, :, ky + dy].permute(0, 2, 3, 1)
            norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            return torch.where(norm > FEATURE_THRESHOLD, v / torch.clamp_min(norm, 1e-30),
                               torch.zeros((), device=v.device))

        feat = torch.zeros((n, len(kx), len(ky), self.feature_size), dtype=torch.float32, device=x.device)
        feat[..., :h] = hist(layers[0], 0, 0)
        for level in range(q):
            for angle, (dx, dy) in enumerate(self._ring_offsets(level)):
                start = h + angle * q * h + level * h
                feat[..., start : start + h] = hist(layers[level], dx, dy)
        return feat.reshape(n, len(kx) * len(ky), self.feature_size)
