"""Histogram of Oriented Gradients (Felzenszwalb/Girshick 31-dim variant).

Port of ``keystone_tpu/ops/images/hog.py`` (reference:
nodes/images/HogExtractor.scala:1-296, a Scala port of voc-dpm
features.cc). The whole batch is a few tensor operations:

- per-pixel dominant-channel gradients by slicing + argmax,
- orientation snapping to 18 signed bins by one 9-way dot and argmax,
- the separable bilinear scatter into cells as two products with static
  (pixel → cell) interpolation matrices, through the solver binding at
  IEEE fp32 (they read no process-wide TF32 switch),
- block normalization and the 27+4+1 feature assembly, elementwise.

Feature layout per cell (the reference's): 18 contrast-sensitive,
9 contrast-insensitive, 4 texture-energy, 1 zero truncation feature.
"""

from __future__ import annotations

import numpy as np
import torch

from ...workflow.pipeline import BatchTransformer
from ..cuda import gemm as _gemm

EPSILON = 1e-4

# Unit vectors for the 9 unsigned orientations (HogExtractor.scala:39-60).
UU = np.array([1.0, 0.9397, 0.7660, 0.5, 0.1736, -0.1736, -0.5, -0.7660, -0.9397])
VV = np.array([0.0, 0.3420, 0.6428, 0.8660, 0.9848, 0.9848, 0.8660, 0.6428, 0.3420])


def _interp_matrix(num_pixels: int, num_cells: int, bin_size: int) -> np.ndarray:
    """Static (pixel → cell) bilinear weights for one axis
    (reference: HogExtractor.scala:133-158). Row p covers visible pixel
    p+1 (gradients skip the first/last pixel)."""
    m = np.zeros((num_pixels, num_cells), dtype=np.float32)
    for i in range(num_pixels):
        p = i + 1
        fp = (p + 0.5) / bin_size - 0.5
        ip = int(np.floor(fp))
        v0 = fp - ip
        if ip >= 0:
            m[i, ip] = 1.0 - v0
        if ip + 1 < num_cells:
            m[i, ip + 1] = v0
    return m


class HogExtractor(BatchTransformer):
    """(N, X, Y, C) → (N, num_cells, 32) HOG features; cells flattened
    x-major like the reference's row index y + x·numYCells."""

    def __init__(self, bin_size: int = 8):
        self.bin_size = bin_size

    def apply_arrays(self, x):
        x = x.to(torch.float32)
        n, xd, yd, _ = x.shape
        b = self.bin_size
        nxc = int(round(xd / b))
        nyc = int(round(yd / b))
        visx = min(nxc * b, xd)
        visy = min(nyc * b, yd)
        fx, fy = max(nxc - 2, 0), max(nyc - 2, 0)
        if fx == 0 or fy == 0:
            return torch.zeros((n, 0, 32), dtype=torch.float32, device=x.device)

        # Central-difference gradients at pixels [1, vis-1) in each axis.
        px, py = visx - 2, visy - 2
        dx = x[:, 2:visx, 1 : visy - 1, :] - x[:, : visx - 2, 1 : visy - 1, :]
        dy = x[:, 1 : visx - 1, 2:visy, :] - x[:, 1 : visx - 1, : visy - 2, :]
        mag2 = dx * dx + dy * dy
        # Dominant channel per pixel; ties go to the lowest channel index
        # (the reference iterates channels 2→0 with strict >).
        best_c = torch.argmax(mag2, dim=-1, keepdim=True)
        dx = torch.gather(dx, -1, best_c)[..., 0]
        dy = torch.gather(dy, -1, best_c)[..., 0]
        magnitude = torch.sqrt(torch.gather(mag2, -1, best_c)[..., 0])

        # Snap to 18 signed orientations (HogExtractor.scala:115-129).
        uu = torch.tensor(UU, dtype=torch.float32, device=x.device)
        vv = torch.tensor(VV, dtype=torch.float32, device=x.device)
        dots = dy[..., None] * uu + dx[..., None] * vv  # (N, px, py, 9)
        best_o = torch.argmax(torch.cat([dots, -dots], dim=-1), dim=-1)
        orients = torch.arange(18, device=x.device)
        mass = torch.where(orients == best_o[..., None], magnitude[..., None],
                           torch.zeros((), device=x.device))  # (N, px, py, 18)

        # Separable bilinear scatter into cells: two products, static mats.
        sx = torch.from_numpy(_interp_matrix(px, nxc, b)).to(x.device)
        sy = torch.from_numpy(_interp_matrix(py, nyc, b)).to(x.device)
        cells_x = _gemm.gemm(sx.T, mass.permute(1, 0, 2, 3).reshape(px, -1), "ieee_fp32")
        cells_x = cells_x.view(nxc, n, py, 18).permute(0, 1, 3, 2).reshape(-1, py)
        hist = _gemm.gemm(cells_x, sy, "ieee_fp32").view(nxc, n, 18, nyc).permute(1, 0, 3, 2)

        # Block energies over opposite-orientation sums (scala:168-195).
        folded = hist[..., :9] + hist[..., 9:]
        norm = torch.sum(folded * folded, dim=-1)  # (N, nxc, nyc)
        block = norm[:, :-1, :-1] + norm[:, 1:, :-1] + norm[:, :-1, 1:] + norm[:, 1:, 1:]
        inv = 1.0 / torch.sqrt(block + EPSILON)  # (N, nxc-1, nyc-1)

        h = hist[:, 1:-1, 1:-1, :]  # interior cells (N, fx, fy, 18)
        ns = torch.stack(
            [inv[:, 1:, 1:], inv[:, :-1, 1:], inv[:, 1:, :-1], inv[:, :-1, :-1]], dim=-1,
        )  # (N, fx, fy, 4): n1..n4

        hn = torch.clamp_max(h[..., None] * ns[..., None, :], 0.2)  # (N,fx,fy,18,4)
        contrast_sensitive = 0.5 * hn.sum(dim=-1)  # 18
        fsum = h[..., :9] + h[..., 9:]
        sn = torch.clamp_max(fsum[..., None] * ns[..., None, :], 0.2)
        contrast_insensitive = 0.5 * sn.sum(dim=-1)  # 9
        texture = 0.2357 * hn.sum(dim=-2)  # (N,fx,fy,4)
        trunc = torch.zeros_like(texture[..., :1])
        features = torch.cat([contrast_sensitive, contrast_insensitive, texture, trunc], dim=-1)
        return features.reshape(n, fx * fy, 32)
