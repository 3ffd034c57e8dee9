"""Local Color Statistics (LCS) grid descriptors.

Port of ``keystone_tpu/ops/images/lcs.py`` (reference:
nodes/images/LCSExtractor.scala:1-130; Clinchant et al., ImageEval 2007):
around every keypoint on a regular grid, a 4×4 neighbourhood of
sub-patches is described by the mean and standard deviation of each
colour channel — 4·4·3·2 = 96 dims.

The box means of x and x² are separable zero-padded mean filters,
anchored as the reference's conv2D (ImageUtils.scala:226-266): padding
floor((k−1)/2) low and the rest high, one image axis at a time. Each pass
is ``F.pad`` and ``avg_pool2d`` at stride 1 over the padded planes, not a
convolution: cuDNN's convolution reads PyTorch's process-wide
``cudnn.allow_tf32`` (True by default), and pooling reads no precision
switch. The keypoint and neighbour reads are one gather.

``stds = sqrt(max(E[x²] − m², 0))`` cancels where a patch is flat: two
fp32 evaluations of it (the card's, the CPU's, the JAX package's) agree
to an absolute floor, not a relative one (``tests/test_torch_imagenet.py``
states its measured value).

The extractor walks ``image_chunk`` images at a time, so the padded
planes of one chunk (not of the whole batch) are live beside the output.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...workflow.pipeline import BatchTransformer


def _box_mean_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """Per-plane zero-padded mean filter over (B, C, X, Y), same size,
    along X then along Y (pad floor((k−1)/2) low, the rest high)."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    out = F.avg_pool2d(F.pad(x, (0, 0, lo, hi)), (size, 1), stride=1)
    return F.avg_pool2d(F.pad(out, (lo, hi, 0, 0)), (1, size), stride=1)


class LCSExtractor(BatchTransformer):
    """(N, X, Y, C) image batch → (N, num_keypoints, 4·4·C·2) descriptors.

    Keypoints at [stride_start, dim − stride_start) step ``stride``;
    neighbours at offsets −2s+s/2−1 … s+s/2−1 step s for sub-patch size s
    (reference: LCSExtractor.scala:56-70).
    """

    #: Images per pass (module docstring).
    image_chunk = 256

    def __init__(self, stride: int = 4, stride_start: int = 16, sub_patch_size: int = 6):
        self.stride = stride
        self.stride_start = stride_start
        self.sub_patch_size = sub_patch_size

    def _neighbor_offsets(self) -> np.ndarray:
        s = self.sub_patch_size
        start = -2 * s + s // 2 - 1
        end = s + s // 2 - 1
        return np.arange(start, end + 1, s)

    def _grid(self, xd: int, yd: int):
        kx = np.arange(self.stride_start, xd - self.stride_start, self.stride)
        ky = np.arange(self.stride_start, yd - self.stride_start, self.stride)
        offs = self._neighbor_offsets()
        ax = kx[:, None] + offs[None, :]
        ay = ky[:, None] + offs[None, :]
        if (ax < 0).any() or (ax >= xd).any() or (ay < 0).any() or (ay >= yd).any():
            raise ValueError("LCS neighborhood exceeds image bounds; increase stride_start")
        return kx, ky, ax, ay

    def _describe(self, x: torch.Tensor, ax: np.ndarray, ay: np.ndarray) -> torch.Tensor:
        """(B, X, Y, C) float32 → (B, nkx·nky, C·4·4·2): per keypoint, per
        channel, the 4×4 grid of (mean, std) pairs."""
        b, _, _, c = x.shape
        planes = x.permute(0, 3, 1, 2)  # (B, C, X, Y)
        means = _box_mean_same(planes, self.sub_patch_size)
        sq = _box_mean_same(planes * planes, self.sub_patch_size)
        stds = torch.sqrt(torch.clamp_min(sq - means * means, 0.0))
        del sq
        ix = torch.as_tensor(ax.reshape(-1), device=x.device)
        iy = torch.as_tensor(ay.reshape(-1), device=x.device)
        nkx, nky, nb = ax.shape[0], ay.shape[0], ax.shape[1]
        pairs = torch.stack([means[:, :, ix][:, :, :, iy], stds[:, :, ix][:, :, :, iy]], dim=-1)
        # (B, C, nkx·4, nky·4, 2) → (B, nkx, nky, C, 4 (x), 4 (y), 2)
        pairs = pairs.view(b, c, nkx, nb, nky, nb, 2).permute(0, 2, 4, 1, 3, 5, 6)
        return pairs.reshape(b, nkx * nky, -1)

    def apply_arrays(self, x):
        x = x.to(torch.float32)
        n, xd, yd, _ = x.shape
        _, _, ax, ay = self._grid(xd, yd)
        return torch.cat([self._describe(x[s : s + self.image_chunk], ax, ay)
                          for s in range(0, n, self.image_chunk)])

    def apply_arrays_masked(self, x, dims):
        """Native-resolution LCS over a size-bucketed batch (see
        ``data.buckets``): ``x`` (N, Xb, Yb, C) padded, ``dims`` (N, 2)
        true sizes. Returns ``(descriptors, valid)`` with the padded
        keypoint grid and a per-image validity mask.

        The box filters are zero-boundary, so the padded region is
        re-zeroed from ``dims`` first: valid keypoints then read exactly
        what a native-size ``apply_arrays`` run reads (the reference's
        per-image behaviour, LCSExtractor.scala:56-70)."""
        x = x.to(torch.float32)
        n, xd, yd, _ = x.shape
        dims = torch.as_tensor(dims, device=x.device).to(torch.int64)
        rows = torch.arange(xd, device=x.device)[None, :, None, None]
        cols = torch.arange(yd, device=x.device)[None, None, :, None]
        inside = (rows < dims[:, 0, None, None, None]) & (cols < dims[:, 1, None, None, None])
        x = torch.where(inside, x, torch.zeros((), device=x.device))
        del inside
        kx = np.arange(self.stride_start, xd - self.stride_start, self.stride)
        ky = np.arange(self.stride_start, yd - self.stride_start, self.stride)
        if len(kx) == 0 or len(ky) == 0:
            raise ValueError("bucket too small for any LCS keypoint")
        kx, ky, ax, ay = self._grid(xd, yd)
        desc = torch.cat([self._describe(x[s : s + self.image_chunk], ax, ay)
                          for s in range(0, n, self.image_chunk)])
        # A keypoint exists at native size iff it lies in
        # [stride_start, native_dim − stride_start).
        kxt = torch.as_tensor(kx, device=x.device)
        kyt = torch.as_tensor(ky, device=x.device)
        valid = ((kxt[None, :, None] < (dims[:, 0] - self.stride_start)[:, None, None])
                 & (kyt[None, None, :] < (dims[:, 1] - self.stride_start)[:, None, None])
                 ).reshape(n, len(kx) * len(ky))
        return desc * valid[..., None], valid
