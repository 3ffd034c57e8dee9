"""Core image operators: convolution, pooling, rectification, patching.

Port of ``keystone_tpu/ops/images/core.py`` (reference: nodes/images/).
Images are (N, X, Y, C) tensors; every batched operator is a whole-batch
tensor function on the device the images lie on.

The convolution is a patch-matrix product, as the reference's
``Convolver`` computes it (im2col, then one GEMM; reference:
nodes/images/Convolver.scala:20-221): :func:`patch_matrix` lays each
s×s×C window out as one row, index ``c + x·C + y·C·s`` (the filter
layout of :func:`pack_filters`), and the rows times the packed filters go
through ``linalg.mm``, on the card the cuBLAS binding at the solver
mode's product kind. So the convolution's precision is pinned per call
and reads none of PyTorch's process-wide TF32 flags
(``torch.backends.cudnn.allow_tf32`` is True by default and would
change a cuDNN convolution). Per-patch normalization keeps the JAX
package's closed form over box statistics,

    out = (raw − m·Σf) / sd − μ_w·f,   var = (Σx² − d·m²) / (d − 1),

with the box sums taken over the same patch rows. Pooling is
``F.avg_pool2d(divisor_override=1)`` (a sum, no divide) or
``F.max_pool2d`` over the image padded with the pool's identity.

The host operators (``Windower``, ``RandomPatcher``,
``CenterCornerPatcher``, ``RandomImageTransformer``) are the JAX
package's numpy code with its seeds, so they emit the same patches.

The SIFT, LCS, Fisher-vector, DAISY, HOG and masked (native-resolution)
operators live in their own modules.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...obs import spans as _spans
from ...parallel import linalg
from ...utils import image as imutil
from ...workflow.pipeline import BatchTransformer, Transformer
from ..learning.zca import ZCAWhitener


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class GrayScaler(BatchTransformer):
    """NTSC grayscale (reference: nodes/images/GrayScaler.scala)."""

    def apply_arrays(self, x):
        if x.shape[-1] == 3:
            # Reference assumes BGR order (ImageUtils.scala:88-90).
            g = 0.2989 * x[..., 2] + 0.5870 * x[..., 1] + 0.1140 * x[..., 0]
        else:
            g = torch.sqrt(torch.mean(x**2, dim=-1))
        return g[..., None]


class PixelScaler(BatchTransformer):
    """[0,255] → [0,1] (reference: nodes/images/PixelScaler.scala)."""

    def apply_arrays(self, x):
        return x / 255.0


class ImageVectorizer(BatchTransformer):
    """Image → channel-major flat vector
    (reference: nodes/images/ImageVectorizer.scala)."""

    def apply_arrays(self, x):
        return x.transpose(1, 2).reshape(x.shape[0], -1)


class SymmetricRectifier(BatchTransformer):
    """Channel-doubling rectifier [max(v, x−α), max(v, −x−α)]
    (reference: nodes/images/SymmetricRectifier.scala)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def apply_arrays(self, x):
        pos = (x - self.alpha).clamp_min_(self.max_val)
        neg = (-x - self.alpha).clamp_min_(self.max_val)
        return torch.cat([pos, neg], dim=-1)


def pack_filters(filter_images) -> np.ndarray:
    """(F, s, s, C) filter images → (F, s·s·C) rows with layout
    index = c + x·C + y·C·s (reference: Convolver.scala packFilters:98-125)."""
    f = _host(filter_images)
    return np.ascontiguousarray(f.transpose(0, 2, 1, 3)).reshape(f.shape[0], -1)


def patch_matrix(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, X, Y, C) images → (N, rx, ry, s·s·C) valid s×s windows, row
    index ``c + x·C + y·C·s`` (:func:`pack_filters`' layout), rx = X−s+1."""
    n, _, _, c = x.shape
    win = x.unfold(1, size, 1).unfold(2, size, 1)  # (N, rx, ry, C, s_x, s_y)
    rx, ry = win.shape[1], win.shape[2]
    return win.permute(0, 1, 2, 5, 4, 3).reshape(n, rx, ry, size * size * c)


def _box_stats(p: torch.Tensor, var_constant: float):
    """Patch mean and sqrt(sample variance + v) maps (N, rx, ry, 1) from
    the patch rows, by the JAX package's formula."""
    d = float(p.shape[-1])
    m = p.sum(dim=-1, keepdim=True) / d
    var = torch.clamp_min(p.square().sum(dim=-1, keepdim=True) - d * m * m, 0.0) / (d - 1.0)
    return m, torch.sqrt(var + var_constant)


def _conv_normalize_(raw, m, sd, fsums, offset):
    """``raw ← (raw − m·Σf)/sd − μ_w·f`` in place (each term when given)."""
    if m is not None:
        raw.addcmul_(m, fsums, value=-1.0).div_(sd)
    if offset is not None:
        raw.sub_(offset)
    return raw


class Convolver(BatchTransformer):
    """Valid convolution of a filter bank over images, with optional
    per-patch normalization and ZCA whitening (reference:
    nodes/images/Convolver.scala:128-204): for each output location, the
    s×s×C patch, optionally normalized (minus its mean, over
    sqrt(sample variance + v)), minus the whitener means, dotted with each
    (pre-whitened) filter.

    ``filters`` is the packed (F, s·s·C) matrix, already whitened when
    ``whitener`` is given; :meth:`create` goes from raw filter images.
    Holds its filters on ``device`` (default CUDA)."""

    def __init__(
        self,
        filters,
        img_channels: int,
        whitener: Optional[ZCAWhitener] = None,
        normalize_patches: bool = True,
        var_constant: float = 10.0,
        device: DeviceLike = None,
    ):
        filters = _host(filters).astype(np.float32)
        self.num_filters, patch_dim = filters.shape
        self.img_channels = img_channels
        self.conv_size = int(math.isqrt(patch_dim // img_channels))
        if self.conv_size**2 * img_channels != patch_dim:
            raise ValueError("filters must be square")
        self.normalize_patches = normalize_patches
        self.var_constant = float(var_constant)
        device = resolve_device(device)
        # (s·s·C, F): the patch rows' right-hand operand.
        self.kernel = torch.as_tensor(np.ascontiguousarray(filters.T), device=device)
        self.filter_sums = torch.as_tensor(filters.sum(axis=1), device=device)  # (F,)
        if whitener is not None:
            means = _host(whitener.means).astype(np.float32)
            self.offset = torch.as_tensor(means @ filters.T, device=device)  # μ_w · f
        else:
            self.offset = None

    @staticmethod
    def create(
        filter_images,
        whitener: Optional[ZCAWhitener] = None,
        normalize_patches: bool = True,
        var_constant: float = 10.0,
        flip_filters: bool = False,
        device: DeviceLike = None,
    ) -> "Convolver":
        """From raw (F, s, s, C) filter images; whitens the packed filters
        with W·Wᵀ like the reference (Convolver.scala:74-80)."""
        filter_images = _host(filter_images)
        if flip_filters:
            filter_images = imutil.flip_image(filter_images)
        packed = pack_filters(filter_images)
        if whitener is not None:
            w = _host(whitener.whitener)
            packed = (packed - _host(whitener.means)) @ w @ w.T
        return Convolver(
            packed,
            img_channels=filter_images.shape[-1],
            whitener=whitener,
            normalize_patches=normalize_patches,
            var_constant=var_constant,
            device=device,
        )

    def apply_arrays(self, x):
        x = x.to(device=self.kernel.device, dtype=torch.float32)
        p = patch_matrix(x, self.conv_size)
        n, rx, ry, d = p.shape
        raw = linalg.mm(p.reshape(-1, d), self.kernel).reshape(n, rx, ry, self.num_filters)
        m, sd = _box_stats(p, self.var_constant) if self.normalize_patches else (None, None)
        del p
        return _conv_normalize_(raw, m, sd, self.filter_sums, self.offset)


class FusedConvFeaturizer(BatchTransformer):
    """Memory-bounded conv → symmetric-rectify → pool → vectorize.

    Computes exactly ``ImageVectorizer(pool(rect(conv(x))))`` one block of
    ``filter_block`` filters at a time, over ``image_chunk`` images at a
    time, so the (N, rx, ry, F) convolution output never materializes:
    one chunk's patch matrix and one (chunk, rx, ry, filter_block) panel
    are live (at 2,048 images and 512 filters, 645 MB and 3.1 GB). The
    channel layout matches the unfused ops: pooled positives for all F
    filters, then pooled negatives for all F; the vector is
    (N, py, px, [pos | neg])."""

    #: Images per chunk of :meth:`apply_arrays` (the memory bound above).
    image_chunk = 2048

    def __init__(
        self,
        convolver: Convolver,
        rectifier: SymmetricRectifier,
        pooler: "Pooler",
        filter_block: int = 512,
    ):
        self.conv = convolver
        self.rect = rectifier
        self.pool = pooler
        self.filter_block = filter_block
        self._packed: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def packed_filter_blocks(self, fb: Optional[int] = None):
        """Zero-padded (nb, s·s·C, fb) kernel blocks plus per-block filter
        sums and whitener offsets (nb, fb): the inputs shared by
        :meth:`apply_arrays` and the rematerializing solver
        (``ops/learning/conv_block.py``, which passes its own block
        width). Built once per width and kept on the filters' device."""
        conv = self.conv
        f = conv.num_filters
        fb = min(self.filter_block, f) if fb is None else fb
        if fb not in self._packed:
            nb = -(-f // fb)
            pad = nb * fb - f
            kernel = F.pad(conv.kernel, (0, pad))  # (d, f_pad)
            fsums = F.pad(conv.filter_sums, (0, pad))
            offset = conv.offset if conv.offset is not None else torch.zeros_like(conv.filter_sums)
            offset = F.pad(offset, (0, pad))
            d = kernel.shape[0]
            kblocks = kernel.reshape(d, nb, fb).permute(1, 0, 2).contiguous()
            self._packed[fb] = (kblocks, fsums.reshape(nb, fb), offset.reshape(nb, fb))
        return self._packed[fb]

    def patch_matrix(self, x: torch.Tensor) -> torch.Tensor:
        """The chunk's (N, rx, ry, s·s·C) patch rows (module :func:`patch_matrix`),
        in a ``conv:patches`` span."""
        with _spans.span("conv:patches", images=int(x.shape[0])):
            return patch_matrix(x.to(device=self.conv.kernel.device, dtype=torch.float32),
                                self.conv.conv_size)

    def norm_stats(self, p: torch.Tensor):
        """Patch mean / stddev maps (N, rx, ry, 1) for per-patch
        normalization from the patch rows ``p`` (None, None when
        disabled); filter-independent, computed once per image chunk, in
        a ``conv:stats`` span."""
        if not self.conv.normalize_patches:
            return None, None
        with _spans.span("conv:stats", images=int(p.shape[0])):
            return _box_stats(p, self.conv.var_constant)

    def block_pooled(self, p, kb, fs_b, off_b, m, sd):
        """conv → normalize → rectify → pool for ONE filter block of the
        patch rows ``p`` (N, rx, ry, d): the (N, px, py, 2·fb) pooled
        panel. The single source of the featurizer math for every
        consumer. The product is a ``conv:product`` span, the rest a
        ``conv:pool`` span."""
        n, rx, ry, d = p.shape
        fb = kb.shape[1]
        with _spans.span("conv:product", images=n, filters=fb):
            out = linalg.mm(p.reshape(-1, d), kb).reshape(n, rx, ry, fb)
        with _spans.span("conv:pool", images=n, filters=fb):
            out = _conv_normalize_(out, m, sd, fs_b, off_b)
            mv, alpha = self.rect.max_val, self.rect.alpha
            pos = self.pool.apply_arrays((out - alpha).clamp_min_(mv))
            neg = self.pool.apply_arrays(out.neg_().sub_(alpha).clamp_min_(mv))
            return torch.cat([pos, neg], dim=-1)

    def apply_arrays(self, x):
        f = self.conv.num_filters
        fb = min(self.filter_block, f)
        kblocks, fsum_blocks, offset_blocks = self.packed_filter_blocks()
        out = []
        for start in range(0, x.shape[0], self.image_chunk):
            p = self.patch_matrix(x[start : start + self.image_chunk])
            m, sd = self.norm_stats(p)
            panels = [
                self.block_pooled(p, kb, fs_b, off_b, m, sd)
                for kb, fs_b, off_b in zip(kblocks, fsum_blocks, offset_blocks)
            ]
            del p, m, sd
            # Blocks in global filter order, padded filters dropped.
            pp = torch.cat([q[..., :fb] for q in panels], dim=-1)[..., :f]
            pn = torch.cat([q[..., fb:] for q in panels], dim=-1)[..., :f]
            pooled = torch.cat([pp, pn], dim=-1)
            out.append(pooled.transpose(1, 2).reshape(pooled.shape[0], -1))
        return torch.cat(out)


class Pooler(BatchTransformer):
    """Strided pooling over square regions with a per-pixel function
    (reference: nodes/images/Pooler.scala:22-69).

    Pool centers start at ``pool_size/2`` and advance by ``stride``; each
    pool covers ``[center − pool_size/2, center + pool_size/2)`` (a window
    2·(pool_size//2) wide) clipped to the image, with out-of-image cells
    contributing the identity (0 for sum, −inf for max)."""

    _IDENTITY = {"sum": 0.0, "max": -math.inf}

    def __init__(
        self,
        stride: int,
        pool_size: int,
        pixel_function: Optional[Callable] = None,
        pool_function: str = "sum",
    ):
        self.stride = stride
        self.pool_size = pool_size
        self.pixel_function = pixel_function
        if pool_function not in self._IDENTITY:
            raise ValueError(f"pool_function must be one of {list(self._IDENTITY)}")
        self.pool_function = pool_function

    def output_shape(self, x_dim: int, y_dim: int) -> Tuple[int, int]:
        """(pools along x, pools along y) for an image of ``x_dim × y_dim``."""
        start = self.pool_size // 2
        return (max(0, -(-(x_dim - start) // self.stride)),
                max(0, -(-(y_dim - start) // self.stride)))

    def apply_arrays(self, x):
        x_dim, y_dim = x.shape[1], x.shape[2]
        window = 2 * (self.pool_size // 2)
        num_x, num_y = self.output_shape(x_dim, y_dim)
        if self.pixel_function is not None:
            x = self.pixel_function(x)
        # The last window reaches (num−1)·stride + window; pad to cover it.
        pad_x = max(0, (num_x - 1) * self.stride + window - x_dim)
        pad_y = max(0, (num_y - 1) * self.stride + window - y_dim)
        xt = x.permute(0, 3, 1, 2)  # NCHW view of the channels-last batch
        if pad_x or pad_y:
            xt = F.pad(xt, (0, pad_y, 0, pad_x), value=self._IDENTITY[self.pool_function])
        if self.pool_function == "sum":
            out = F.avg_pool2d(xt, window, self.stride, divisor_override=1)
        else:
            out = F.max_pool2d(xt, window, self.stride)
        return out[:, :, :num_x, :num_y].permute(0, 2, 3, 1)


class Cropper(BatchTransformer):
    """Fixed bounding-box crop (reference: nodes/images/Cropper.scala)."""

    def __init__(self, start_x: int, start_y: int, end_x: int, end_y: int):
        self.bounds = (start_x, start_y, end_x, end_y)

    def apply_arrays(self, x):
        sx, sy, ex, ey = self.bounds
        return x[:, sx:ex, sy:ey, :]


def _host_images(dataset: Dataset) -> Tuple[np.ndarray, Optional[torch.device]]:
    """The dataset's images as one host array, and the device an
    ``ArrayDataset`` held them on (None for a host dataset)."""
    if isinstance(dataset, ArrayDataset):
        return dataset.data[: dataset.num_examples].cpu().numpy(), dataset.device
    return np.stack([_host(i) for i in dataset.collect()]), None


class RandomImageTransformer(Transformer):
    """Apply ``transform`` to each image with probability ``chance``
    (reference: nodes/images/RandomImageTransformer.scala); coins from
    ``np.random.default_rng(seed)``, as the JAX package draws them."""

    def __init__(self, chance: float, transform: Callable, seed: int = 12334):
        self.chance = chance
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def apply(self, img):
        if self._rng.random() < self.chance:
            return self.transform(img)
        return img

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, ArrayDataset):
            x, device = _host_images(dataset)
            flip = self._rng.random(x.shape[0]) < self.chance
            out = np.where(
                flip.reshape((-1,) + (1,) * (x.ndim - 1)), np.asarray(self.transform(x)), x
            )
            return ArrayDataset(out, device=device)
        return dataset.map(self.apply)


def _flatmap_images(dataset: Dataset, per_image: Callable[[np.ndarray], np.ndarray]) -> ArrayDataset:
    """Host-side flatMap: each image yields a (k, px, py, C) stack; the
    stacks concatenate along the example axis on the input dataset's
    device (the default device for a host dataset)."""
    imgs, device = _host_images(dataset)
    return ArrayDataset(np.concatenate([per_image(img) for img in imgs], axis=0), device=device)


class Windower(Transformer):
    """All windows of size w on a stride grid, x-major
    (reference: nodes/images/Windower.scala:13-56). One image of (X, Y, C)
    yields ((X−w)/s+1)·((Y−w)/s+1) windows; a batch concatenates them."""

    def __init__(self, stride: int, window_size: int):
        self.stride = stride
        self.window_size = window_size

    def _windows(self, img: np.ndarray) -> np.ndarray:
        w, s = self.window_size, self.stride
        xs = range(0, img.shape[0] - w + 1, s)
        ys = range(0, img.shape[1] - w + 1, s)
        return np.stack([img[x : x + w, y : y + w, :] for x in xs for y in ys])

    def apply(self, img):
        return self._windows(_host(img))

    def apply_batch(self, dataset: Dataset) -> Dataset:
        return _flatmap_images(dataset, self._windows)


class RandomPatcher(Transformer):
    """``num_patches`` uniformly random patches per image
    (reference: nodes/images/RandomPatcher.scala:16-47)."""

    def __init__(self, num_patches: int, patch_size_x: int, patch_size_y: int, seed: int = 12334):
        self.num_patches = num_patches
        self.patch_size_x = patch_size_x
        self.patch_size_y = patch_size_y
        self._rng = np.random.default_rng(seed)

    def _patches(self, img: np.ndarray) -> np.ndarray:
        px, py = self.patch_size_x, self.patch_size_y
        out = []
        for _ in range(self.num_patches):
            sx = self._rng.integers(0, img.shape[0] - px + 1)
            sy = self._rng.integers(0, img.shape[1] - py + 1)
            out.append(img[sx : sx + px, sy : sy + py, :])
        return np.stack(out)

    def apply(self, img):
        return self._patches(_host(img))

    def apply_batch(self, dataset: Dataset) -> Dataset:
        return _flatmap_images(dataset, self._patches)


class CenterCornerPatcher(Transformer):
    """Four corner patches + center patch, optionally with horizontal flips
    (reference: nodes/images/CenterCornerPatcher.scala:18-48)."""

    def __init__(self, patch_size_x: int, patch_size_y: int, horizontal_flips: bool = False):
        self.patch_size_x = patch_size_x
        self.patch_size_y = patch_size_y
        self.horizontal_flips = horizontal_flips

    def _patches(self, img: np.ndarray) -> np.ndarray:
        px, py = self.patch_size_x, self.patch_size_y
        x_dim, y_dim = img.shape[0], img.shape[1]
        starts = [
            (0, 0),
            (x_dim - px, 0),
            (0, y_dim - py),
            (x_dim - px, y_dim - py),
            ((x_dim - px) // 2, (y_dim - py) // 2),
        ]
        out = []
        for sx, sy in starts:
            patch = img[sx : sx + px, sy : sy + py, :]
            out.append(patch)
            if self.horizontal_flips:
                out.append(imutil.flip_horizontal(patch))
        return np.stack(out)

    def apply(self, img):
        return self._patches(_host(img))

    def apply_batch(self, dataset: Dataset) -> Dataset:
        return _flatmap_images(dataset, self._patches)


# ------------------------------------------------------- labeled-image glue


class LabelExtractor(Transformer):
    """{"image", "label"} dict → label
    (reference: nodes/images/LabeledImageExtractors.scala)."""

    def apply(self, datum):
        return datum["label"]

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, ArrayDataset):
            return ArrayDataset(dataset.data["label"], dataset.num_examples)
        return dataset.map(self.apply)


class ImageExtractor(Transformer):
    """{"image", "label"} dict → image."""

    def apply(self, datum):
        return datum["image"]

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, ArrayDataset):
            return ArrayDataset(dataset.data["image"], dataset.num_examples)
        return dataset.map(self.apply)


MultiLabelExtractor = LabelExtractor
MultiLabeledImageExtractor = ImageExtractor
