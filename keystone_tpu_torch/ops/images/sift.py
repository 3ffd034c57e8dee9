"""Dense multi-scale SIFT.

Port of ``keystone_tpu/ops/images/sift.py`` (reference: the native VLFeat
kernel ``getMultiScaleDSIFTs_f``, src/main/cpp/VLFeat.cxx:37-292, and
nodes/images/external/SIFTExtractor.scala:16-40). The algorithm and its
knobs are the JAX package's:

- per scale ``s``: bin size ``b = bin_size + 2s``, Gaussian smoothing with
  σ = b / 6 (magnif = 6, VLFeat.cxx:45,88) over an edge-replicated
  border, sampling step ``step + s·scale_step`` and bound offset
  ``(1 + 2·num_scales) − 3s`` (VLFeat.cxx:78,95);
- gradients by central differences, one-sided at the first and last
  row and column; 8 orientation planes with linear interpolation between
  the two nearest bins; bilinear spatial binning as a separable
  triangular convolution over a zero border (the flat-window dense-SIFT
  formulation);
- descriptors L2-normalized, clamped at 0.2, renormalized; zeroed where
  the first norm is below the contrast threshold 0.005; quantized
  ``min(floor(512·v), 255)`` (VLFeat.cxx:146,258-260);
- output (N, num_descriptors, 128) per image, scales concatenated along
  the descriptor axis, orientation fastest, then x-bin, then y-bin.

The extractor computes in float64 and returns the quantized values as
float32 (whole numbers 0–255, exact). Quantization is a step function:
in float32 about 7e-6 of the values (0.09% of the descriptors) came out
one step from the float64 value, and at VOC's widths (the PCA sample's
eigengaps near its 80th component are 1e-4 of the largest eigenvalue)
those steps turned the PCA subspace and, through EM, the mixture, far
more than their number. Given a ``binning_dtype`` (float32, or bfloat16
for a bf16 binning pass) it computes in float32, as the JAX package does.

Each separable convolution is two products with banded matrices (one
per image axis; the band holds the kernel) through the solver binding
(``ops/cuda/gemm.py``) at an explicit kind: fp64 (float64 planes), or
IEEE fp32 for the smoothing and IEEE fp32 or one bf16 pass
(``binning_dtype=torch.bfloat16``) for the binning. So neither pass
reads PyTorch's process-wide TF32 switches: a
cuDNN convolution would read ``torch.backends.cudnn.allow_tf32``, True by
default, and TF32 smoothing would put the descriptors off by more than
one step, as the JAX module measured for bf16 smoothing (97.5% of
entries within 1 against the 99.5% gate). The binning products are taken
only at the rows and columns the descriptor grid reads. Planes are held
x-major, (X, N, ·, Y), so each product is one 2-D GEMM with no transpose
of the planes.

The extractor walks ``image_chunk`` images at a time: one chunk's planes
at 256×256 (8 × 256 × 256 float64 per image) and their products stay near
6 GB on the card, where the whole batch would be 4.2 MB per image and
scale. Each chunk is one ``sift:extract`` span (``images``,
``descriptors``: the chunk's, every scale).

``apply_arrays_masked`` is the native-resolution path over a size bucket
(``data/buckets.py``): edge-replicate padding reproduces the smoother's
border, the gradient stencil turns one-sided at each image's true
border, and the orientation planes are zeroed outside it, so a valid
descriptor is a native-size run's (to the banded products' summation
order: ±1 quantization step at most, the reference's tolerance).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ...obs import spans as _spans
from ...workflow.pipeline import BatchTransformer
from ..cuda import gemm as _gemm

NUM_ORIENTATIONS = 8
NUM_SPATIAL_BINS = 4
DESCRIPTOR_SIZE = NUM_ORIENTATIONS * NUM_SPATIAL_BINS * NUM_SPATIAL_BINS  # 128
CONTRAST_THRESHOLD = 0.005
MAGNIF = 6.0


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(4.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def _triangular_kernel(bin_size: int) -> np.ndarray:
    """w(u) = 1 - |u|/b for |u| < b — bilinear spatial-bin interpolation as
    a convolution (the flat-window dense-SIFT trick)."""
    xs = np.arange(-(bin_size - 1), bin_size, dtype=np.float64)
    return np.maximum(0.0, 1.0 - np.abs(xs) / bin_size)


def band_matrix(kernel: np.ndarray, rows: np.ndarray, n_cols: int, shift: int,
                dtype=np.float32) -> np.ndarray:
    """(len(rows), n_cols) matrix M of ``dtype`` with ``M[i, rows[i] +
    shift + t] = kernel[t]``, entries past either edge left out: M @ v is
    the correlation ``Σ_t kernel[t]·v[rows[i] + shift + t]`` over a zero
    border."""
    m = np.zeros((len(rows), n_cols), dtype=dtype)
    for t, w in enumerate(np.asarray(kernel, dtype=dtype)):
        cols = np.asarray(rows) + shift + t
        ok = (cols >= 0) & (cols < n_cols)
        m[np.nonzero(ok)[0], cols[ok]] = w
    return m


def _band_on(kernel: np.ndarray, rows: np.ndarray, n_cols: int, shift: int, like: torch.Tensor) -> torch.Tensor:
    """:func:`band_matrix` on ``like``'s device, in its dtype."""
    dtype = np.float64 if like.dtype == torch.float64 else np.float32
    return _on(band_matrix(kernel, rows, n_cols, shift, dtype), like)


def _on(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m).to(like.device)


def _smooth(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian smoothing of an (N, X, Y) batch over an edge-replicated
    border (vl_imsmooth's continuity padding), x axis first: returns the
    smoothed batch x-major, (X, N, Y), in ``x``'s dtype."""
    kernel = _gaussian_kernel(sigma)
    pad = (len(kernel) - 1) // 2
    n, xd, yd = x.shape
    ix = torch.arange(-pad, xd + pad, device=x.device).clamp(0, xd - 1)
    iy = torch.arange(-pad, yd + pad, device=x.device).clamp(0, yd - 1)
    padded = x[:, ix][:, :, iy].permute(1, 0, 2).reshape(xd + 2 * pad, -1)
    mx = _band_on(kernel, np.arange(xd), xd + 2 * pad, 0, x)
    my = _band_on(kernel, np.arange(yd), yd + 2 * pad, 0, x)
    along_x = _gemm.gemm(mx, padded, "ieee_fp32").view(xd * n, yd + 2 * pad)
    return _gemm.gemm(along_x, my.T, "ieee_fp32").view(xd, n, yd)


def _gradients(sm: torch.Tensor, dims: Optional[torch.Tensor] = None):
    """Central differences inside, one-sided at the borders (vl_dsift's
    stencil), of an x-major (X, N, Y) batch: (gx, gy). With ``dims``
    (N, 2), the last row and column are each image's true ones."""
    gx = torch.empty_like(sm)
    gx[1:-1] = (sm[2:] - sm[:-2]) * 0.5
    gx[0] = sm[1] - sm[0]
    gx[-1] = sm[-1] - sm[-2]
    gy = torch.empty_like(sm)
    gy[:, :, 1:-1] = (sm[:, :, 2:] - sm[:, :, :-2]) * 0.5
    gy[:, :, 0] = sm[:, :, 1] - sm[:, :, 0]
    gy[:, :, -1] = sm[:, :, -1] - sm[:, :, -2]
    if dims is not None:
        xd, _, yd = sm.shape
        rows = torch.arange(xd, device=sm.device)[:, None, None]
        cols = torch.arange(yd, device=sm.device)[None, None, :]
        last_row = rows == (dims[:, 0] - 1)[None, :, None]
        last_col = cols == (dims[:, 1] - 1)[None, :, None]
        back_x = torch.zeros_like(sm)
        back_x[1:] = sm[1:] - sm[:-1]
        back_y = torch.zeros_like(sm)
        back_y[:, :, 1:] = sm[:, :, 1:] - sm[:, :, :-1]
        gx = torch.where(last_row, back_x, gx)
        gy = torch.where(last_col, back_y, gy)
    return gx, gy


def _orientation_planes(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude split over the two nearest of 8 orientation
    bins (a circular triangular weight): (X, N, Y) → (X, N, 8, Y)."""
    mag = torch.sqrt(gx * gx + gy * gy)
    theta = torch.remainder(torch.atan2(gy, gx), 2.0 * math.pi)
    t = (theta * (NUM_ORIENTATIONS / (2.0 * math.pi)))[:, :, None, :]  # [0, 8)
    orient = torch.arange(NUM_ORIENTATIONS, dtype=gx.dtype, device=gx.device)[:, None]
    dist = (t - orient).abs_()
    dist = torch.minimum(dist, NUM_ORIENTATIONS - dist)
    return (1.0 - dist).clamp_min_(0.0).mul_(mag[:, :, None, :])


class SIFTExtractor(BatchTransformer):
    """Dense SIFT at multiple scales
    (reference: nodes/images/external/SIFTExtractor.scala:16-40).

    Input: (N, X, Y) or (N, X, Y, 1) grayscale batch. Output:
    (N, num_descriptors, 128) quantized descriptors, scales concatenated
    along the descriptor axis as the reference concatenates per-scale
    descriptor blocks.

    ``binning_dtype``: ``None`` (the default: every step in float64),
    ``torch.float32`` (every step in IEEE fp32) or ``torch.bfloat16``
    (float32, with the spatial-binning products as one bf16 pass with
    fp32 accumulation).
    """

    #: Images per pass through the scales (module docstring: memory).
    image_chunk = 256

    def __init__(self, step_size: int = 3, bin_size: int = 4, scales: int = 4,
                 scale_step: int = 1, binning_dtype: Optional[torch.dtype] = None):
        if binning_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"binning_dtype must be None, float32 or bfloat16; got {binning_dtype}")
        self.step_size = step_size
        self.bin_size = bin_size
        self.scales = scales
        self.scale_step = scale_step
        self.binning_dtype = binning_dtype

    @property
    def descriptor_size(self) -> int:
        return DESCRIPTOR_SIZE

    def _geometry(self, s: int, x_dim: int, y_dim: int):
        b = self.bin_size + 2 * s
        step = self.step_size + s * self.scale_step
        off = max(0, (1 + 2 * self.scales) - 3 * s)
        span = (NUM_SPATIAL_BINS - 1) * b
        nx = (x_dim - 1 - off - span) // step + 1
        ny = (y_dim - 1 - off - span) // step + 1
        return b, step, off, nx, ny

    def grid_counts(self, x_dim: int, y_dim: int) -> List[int]:
        """Descriptors per scale for an x_dim × y_dim image."""
        counts = []
        for s in range(self.scales):
            _, _, _, nx, ny = self._geometry(s, x_dim, y_dim)
            counts.append(max(0, nx) * max(0, ny))
        return counts

    @property
    def _compute_dtype(self) -> torch.dtype:
        return torch.float64 if self.binning_dtype is None else torch.float32

    def apply_arrays(self, x):
        if x.ndim == 4:
            x = x[..., 0]
        x = x.to(self._compute_dtype)
        n, xd, yd = x.shape
        counts = self.grid_counts(xd, yd)
        if not any(counts):
            raise ValueError("image too small for any SIFT scale")
        out = torch.empty((n, sum(counts), DESCRIPTOR_SIZE), dtype=torch.float32, device=x.device)
        for start in range(0, n, self.image_chunk):
            chunk = x[start : start + self.image_chunk]
            with _spans.span("sift:extract", images=len(chunk), descriptors=len(chunk) * sum(counts)):
                offset = 0
                for s, count in enumerate(counts):
                    if count:
                        out[start : start + len(chunk), offset : offset + count] = self._one_scale(chunk, s)
                        offset += count
        return out

    def apply_arrays_masked(self, x, dims):
        """Native-resolution SIFT over a size-bucketed batch.

        ``x`` is (N, Xb, Yb[, 1]) *edge-replicate padded* (see
        ``data.buckets``), ``dims`` is (N, 2) true (x, y) sizes. Returns
        ``(descriptors, valid)``: descriptors on the padded grid, zero
        where invalid, and ``valid`` (N, n_desc) marking the grid
        positions that exist at each image's native size (reference:
        VLFeat.cxx:170-186 computes per image at its own size)."""
        if x.ndim == 4:
            x = x[..., 0]
        x = x.to(self._compute_dtype)
        dims = torch.as_tensor(dims, device=x.device).to(torch.int64)
        n, xd, yd = x.shape
        counts = self.grid_counts(xd, yd)
        if not any(counts):
            raise ValueError("bucket too small for any SIFT scale")
        out = torch.empty((n, sum(counts), DESCRIPTOR_SIZE), dtype=torch.float32, device=x.device)
        for start in range(0, n, self.image_chunk):
            chunk = x[start : start + self.image_chunk]
            with _spans.span("sift:extract", images=len(chunk), descriptors=len(chunk) * sum(counts)):
                offset = 0
                for s, count in enumerate(counts):
                    if count:
                        out[start : start + len(chunk), offset : offset + count] = self._one_scale(
                            chunk, s, dims[start : start + self.image_chunk])
                        offset += count
        valid = []
        for s, count in enumerate(counts):
            if count:
                b, step, off, nx, ny = self._geometry(s, xd, yd)
                span = (NUM_SPATIAL_BINS - 1) * b
                nx_nat = torch.clamp_min((dims[:, 0] - 1 - off - span) // step + 1, 0)
                ny_nat = torch.clamp_min((dims[:, 1] - 1 - off - span) // step + 1, 0)
                valid.append(((torch.arange(nx, device=x.device)[None, :, None] < nx_nat[:, None, None])
                              & (torch.arange(ny, device=x.device)[None, None, :] < ny_nat[:, None, None])
                              ).reshape(n, nx * ny))
        valid = torch.cat(valid, dim=1)
        return out.mul_(valid[..., None]), valid

    def _one_scale(self, x: torch.Tensor, s: int, dims: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, xd, yd = x.shape
        b, step, off, nx, ny = self._geometry(s, xd, yd)
        planes = _orientation_planes(*_gradients(_smooth(x, b / MAGNIF), dims))  # (X, N, 8, Y)
        if dims is not None:
            # Zero outside the native extent: the spatial binning then sees
            # the zero border a native-size run sees.
            rows = torch.arange(xd, device=x.device)[:, None, None, None]
            cols = torch.arange(yd, device=x.device)[None, None, None, :]
            inside = (rows < dims[:, 0, None, None]) & (cols < dims[:, 1, None, None])
            planes.mul_(inside)
            del inside

        # Spatial binning, taken only where the 4×4 bin centres of the
        # descriptor grid fall.
        bx = (off + np.arange(nx) * step)[:, None] + np.arange(NUM_SPATIAL_BINS) * b  # (nx, 4)
        by = (off + np.arange(ny) * step)[:, None] + np.arange(NUM_SPATIAL_BINS) * b  # (ny, 4)
        rx, ry = np.unique(bx), np.unique(by)
        kernel = _triangular_kernel(b)
        pad = (len(kernel) - 1) // 2
        kind = "bf16" if self.binning_dtype == torch.bfloat16 else "ieee_fp32"
        mx = _band_on(kernel, rx, xd, -pad, x)
        my = _band_on(kernel, ry, yd, -pad, x)
        along_x = _gemm.gemm(mx, planes.view(xd, -1), kind).view(-1, yd)
        del planes
        binned = _gemm.gemm(along_x, my.T, kind).view(len(rx), n, NUM_ORIENTATIONS, len(ry))
        del along_x

        gx = torch.as_tensor(np.searchsorted(rx, bx).reshape(-1), device=x.device)
        gy = torch.as_tensor(np.searchsorted(ry, by).reshape(-1), device=x.device)
        g = binned[gx][:, :, :, gy].view(nx, NUM_SPATIAL_BINS, n, NUM_ORIENTATIONS, ny, NUM_SPATIAL_BINS)
        # → (N, nx, ny, ybin, xbin, orientation): orientation fastest.
        raw = g.permute(2, 0, 4, 5, 1, 3).reshape(n, nx * ny, DESCRIPTOR_SIZE)
        del binned, g

        # Normalize → clamp 0.2 → renormalize; zero low-contrast descriptors;
        # quantize min(512·v, 255) (VLFeat.cxx:146,258-260).
        eps = 1e-10
        norm1 = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
        d = (raw / norm1.clamp_min(eps)).clamp_max_(0.2)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(eps)
        d = torch.where(norm1 > CONTRAST_THRESHOLD, d, torch.zeros((), device=d.device))
        return torch.floor(512.0 * d).clamp_max_(255.0)
