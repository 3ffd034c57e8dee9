"""Fused featurize-and-solve: BCD whose feature blocks are rematerialized
on the device instead of stored.

Port of ``keystone_tpu/ops/learning/conv_block.py``, on one device. The
reference's CIFAR RandomPatch caches the 80,000-wide featurized RDD and
streams feature blocks out of it into BCD (reference:
RandomPatchCifar.scala:59-77). Here each solver block's features are
*recomputed* from the raw images when the block update needs them: a
solver block is one filter block of the fused conv featurizer, so one
epoch convolves every filter once (the work of featurizing once), and
device residency is the raw images, one chunk's patch rows and conv
panel, one (n, block) feature panel and the (n, k) predictions. The
(50,000, 80,000) feature matrix of the reference configuration (16 GB)
never exists.

Each step featurizes one block of ``fb`` filters chunk by chunk
(``FusedConvFeaturizer.block_pooled``, the featurizer's own math), takes
the block's mean and standard deviation over the rows (the pipeline's
``StandardScaler``), and runs the block update of
``linalg.block_coordinate_descent_rematerialized`` (Gram, Cholesky,
residual), whose products go through ``linalg`` at the solver mode's
kind. With more than one pass each block's Cholesky factor is formed on
the first pass and kept for the later ones (``linalg._BlockFactors``);
the block's features are recomputed every pass. The solved model folds 1/σ into the weights and is permuted to the
featurizer's standard layout, so it applies to ordinary featurizer
output; padded filters are dropped.

Over a fit mesh with several row shards (``partitioner.fit_mesh``) the
step is the JAX package's ``shard_map`` body, shard by shard: each shard
featurizes its own rows of the block through the same product path, the
masked column sums (and sums of squares) are reduced over the row axes
into the block's mean and standard deviation, and the block update
reduces the Gram and right-hand side the same way
(``linalg._bcd_block_update``); pad rows are masked out. The JAX
package's step is compiled and cached per featurizer; here nothing
compiles, and only the packed filter blocks are cached on the device
(``FusedConvFeaturizer.packed_filter_blocks``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...data.dataset import Dataset
from ...device import DeviceLike, resolve_device
from ...obs import spans as _spans
from ...parallel import linalg
from ...parallel.collectives import allreduce_sum
from ...parallel.mesh import row_axes, row_shard_count
from ...parallel.partitioner import fit_mesh
from ...workflow.pipeline import BatchTransformer, LabelEstimator
from ..images.core import FusedConvFeaturizer
from .block import BlockLinearMapper, _as_array_dataset


class ConvBlockModel(BatchTransformer):
    """Featurize (fused conv) then apply the solved linear model — the
    fitted form of :class:`ConvBlockLeastSquaresEstimator`. Applies in
    chunks of ``image_chunk`` images, so the full (n, 8·numFilters)
    feature matrix never exists at predict time either."""

    def __init__(
        self,
        featurizer: FusedConvFeaturizer,
        linear: BlockLinearMapper,
        image_chunk: int = 2048,
    ):
        self.featurizer = featurizer
        self.linear = linear
        self.image_chunk = image_chunk

    @property
    def weights(self):
        return self.linear.weights

    def apply_arrays(self, images):
        return torch.cat([
            self.linear.apply_arrays(self.featurizer.apply_arrays(images[s : s + self.image_chunk]))
            for s in range(0, images.shape[0], self.image_chunk)
        ])


class ConvBlockLeastSquaresEstimator(LabelEstimator):
    """Least squares over fused-conv features with on-device block
    rematerialization (featurize → standardize → BCD as one machine), on
    ``device`` (default CUDA).

    Equivalent to ``FusedConvFeaturizer → StandardScaler →
    BlockLeastSquaresEstimator(block_size, num_iter, reg)`` (both apply a
    scale-aware λ floor when reg = 0; the block order here is
    filter-major rather than column-contiguous, the same fixed point).
    ``block_size`` must be a whole number of filters (divisible by the
    per-filter feature count pool_x·pool_y·2); None picks the largest
    such block ≤ 4,096 features."""

    def __init__(
        self,
        featurizer: FusedConvFeaturizer,
        block_size: Optional[int] = 4096,
        num_iter: int = 1,
        reg: float = 0.0,
        standardize: bool = True,
        image_chunk: int = 2048,
        device: DeviceLike = None,
    ):
        self.featurizer = featurizer
        self.block_size = block_size
        self.num_iter = num_iter
        self.reg = reg
        self.standardize = standardize
        self.image_chunk = image_chunk
        self.device = device

    @property
    def weight(self) -> int:
        return 3 * self.num_iter + 1

    # ------------------------------------------------------------ geometry

    def _geometry(self, image_shape):
        """(features_per_filter, filters_per_block, num_blocks, px, py)."""
        conv = self.featurizer.conv
        px, py = self.featurizer.pool.output_shape(
            image_shape[0] - conv.conv_size + 1, image_shape[1] - conv.conv_size + 1
        )
        fpf = px * py * 2  # pos+neg channels per filter, per pool cell
        bs = self.block_size
        if bs is None:
            bs = max(fpf, (4096 // fpf) * fpf)
        if bs % fpf != 0:
            raise ValueError(
                f"block_size={bs} not divisible by the per-filter feature count {fpf}"
            )
        fb = bs // fpf
        nb = -(-conv.num_filters // fb)
        return fpf, fb, nb, px, py

    def _standard_permutation(self, px: int, py: int, fb: int, nb: int) -> np.ndarray:
        """Map block-major solved rows to the standard featurizer layout.

        Block-major: for block b, ``ImageVectorizer`` over the pooled
        (N, px, py, 2·fb) panel → index (y, x, c_local) with channels
        [pos_b | neg_b]. Standard: (y, x, c_global) over 2·f_pad channels
        [pos all | neg all]. Returns ``perm`` with
        ``standard_index = perm[block_major_index]``."""
        f_pad = nb * fb
        b, y, x, c = np.meshgrid(
            np.arange(nb), np.arange(py), np.arange(px), np.arange(2 * fb), indexing="ij"
        )
        half, fi = np.divmod(c, fb)
        g = half * f_pad + b * fb + fi  # padded-global channel
        return (y * (px * 2 * f_pad) + x * (2 * f_pad) + g).reshape(-1).astype(np.int64)

    # ---------------------------------------------------------------- fit

    @property
    def weight(self) -> int:
        """Passes over its input (the reference's WeightedOperator): the
        auto-cache planner multiplies a node's recomputations by it."""
        return 3 * self.num_iter + 1

    def fit(self, data: Dataset, labels: Dataset) -> ConvBlockModel:
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        fz = self.featurizer
        n = features.num_examples
        images = features.data[:n].to(device=device, dtype=torch.float32)
        y = targets.data[:n].to(device=device, dtype=torch.float32)
        fpf, fb, nb, px, py = self._geometry(images.shape[1:3])
        f_pad = nb * fb
        bs = fpf * fb
        kblocks, fsum_blocks, offset_blocks = fz.packed_filter_blocks(fb)

        mu_b = y.sum(dim=0) / n
        yc = y - mu_b
        if self.reg > 0:
            reg = float(self.reg)
        elif self.standardize:
            # Standardized blocks have Gram diagonal ≈ n (unit variance):
            # floor λ relative to that scale so a rank-deficient block
            # stays Cholesky-finite.
            reg = max(1e-6 * n, 1e-6)
        else:
            probe = fz.apply_arrays(images[: min(n, 256)])
            probe = probe - probe.mean(dim=0, keepdim=True)
            reg = max(1e-6 * n * float(probe.square().mean()), 1e-6)

        mus, inv_sds = [None] * nb, [None] * nb
        mesh = fit_mesh(self)
        if row_shard_count(mesh) > 1:
            w = self._fit_sharded(mesh, images, yc, n, reg, (kblocks, fsum_blocks, offset_blocks), bs, mus, inv_sds)
        else:

            def block_fn(b: int, _offset: int, _rows: int) -> torch.Tensor:
                a_raw = self._featurize_block(images, kblocks[b], fsum_blocks[b], offset_blocks[b], bs, b)
                with _spans.span("conv:standardize", block=b):
                    mu = a_raw.sum(dim=0) / n
                    if self.standardize:
                        var = (a_raw.square().sum(dim=0) - n * mu**2) / max(n - 1.0, 1.0)
                        sd = torch.sqrt(torch.clamp_min(var, 0.0))
                        inv_sd = torch.where((sd < 1e-8) | ~torch.isfinite(sd), 1.0, 1.0 / sd)
                    else:
                        inv_sd = torch.ones_like(mu)
                    mus[b], inv_sds[b] = mu, inv_sd
                    return a_raw.sub_(mu).mul_(inv_sd)

            w = linalg.block_coordinate_descent_rematerialized(
                block_fn, yc, reg=reg, num_epochs=self.num_iter, block_size=bs, num_blocks=nb
            )

        # The standard-layout model: 1/σ folded into the weights, so it
        # applies to raw featurizer output.
        w_bm = w * torch.cat(inv_sds)[:, None]
        perm = torch.from_numpy(self._standard_permutation(px, py, fb, nb)).to(device)
        d_std = px * py * 2 * f_pad
        w_std = torch.zeros(d_std, w.shape[1], device=device).index_copy_(0, perm, w_bm)
        mu_std = torch.zeros(d_std, device=device).index_copy_(0, perm, torch.cat(mus))
        # Drop padded-filter channels (each (y, x) cell holds 2·f_pad).
        keep = torch.from_numpy(np.arange(d_std) % (2 * f_pad) % f_pad < fz.conv.num_filters).to(device)
        linear = BlockLinearMapper(w_std[keep], block_size=bs, intercept=mu_b,
                                   feature_mean=mu_std[keep])
        return ConvBlockModel(fz, linear, image_chunk=self.image_chunk)

    def _fit_sharded(self, mesh, images, yc, n, reg, packed, bs, mus, inv_sds):
        """The JAX package's sharded featurize → residual → block-update
        step over ``mesh``'s row shards (rows zero-padded to a shard
        multiple and masked out of every sum); fills ``mus`` /
        ``inv_sds`` and returns the block-major weights."""
        kblocks, fsum_blocks, offset_blocks = packed
        nb = len(kblocks)
        axes = row_axes(mesh)
        shards = row_shard_count(mesh)
        n_pad = -(-n // shards) * shards
        xs = linalg.prepare_row_sharded(images, mesh).shards
        ys = linalg.prepare_row_sharded(yc, mesh).shards
        mask = torch.zeros(n_pad, 1, device=images.device)
        mask[:n] = 1.0
        masks = linalg.prepare_row_sharded(mask, mesh).shards
        ps = [torch.zeros_like(t) for t in ys]
        w = torch.zeros(nb * bs, yc.shape[1], device=images.device)
        eye = torch.eye(bs, device=images.device)
        factors = linalg._BlockFactors(self.num_iter, nb, bs, torch.float32, images.device,
                                       workspace=n_pad * bs * 4)

        def step(b: int, epoch: int):
            a_raw = [self._featurize_block(x, kblocks[b], fsum_blocks[b], offset_blocks[b], bs, b) for x in xs]
            with _spans.span("conv:standardize", block=b):
                mu = allreduce_sum([(a * m).sum(dim=0) for a, m in zip(a_raw, masks)], mesh, axes)[0] / n
                if self.standardize:
                    s2 = allreduce_sum([(a * m).square().sum(dim=0) for a, m in zip(a_raw, masks)], mesh, axes)[0]
                    var = (s2 - n * mu**2) / max(n - 1.0, 1.0)
                    sd = torch.sqrt(torch.clamp_min(var, 0.0))
                    inv_sd = torch.where((sd < 1e-8) | ~torch.isfinite(sd), 1.0, 1.0 / sd)
                else:
                    inv_sd = torch.ones_like(mu)
                mus[b], inv_sds[b] = mu, inv_sd
                a_bs = [a.sub_(mu).mul_(inv_sd).mul_(m) for a, m in zip(a_raw, masks)]
            start = b * bs
            return linalg._bcd_block_update(
                a_bs, ys, ps, w[start : start + bs], reg, eye, mesh, block=b, pass_=epoch, factors=factors
            )

        for epoch in range(int(self.num_iter)):
            for b in range(nb):
                w[b * bs : (b + 1) * bs], ps = factors.run(lambda: step(b, epoch))
        return w

    def _featurize_block(self, images, kb, fs_b, off_b, bs: int, block: int) -> torch.Tensor:
        """The (n, bs) raw features of filter block ``block``, ``image_chunk``
        images at a time, in block-major layout (ImageVectorizer over
        the block's pooled (N, px, py, 2·fb) panel), in a ``conv:block``
        span."""
        fz = self.featurizer
        with _spans.span("conv:block", block=block):
            out = torch.empty(images.shape[0], bs, device=images.device)
            for s in range(0, images.shape[0], self.image_chunk):
                p = fz.patch_matrix(images[s : s + self.image_chunk])
                m, sd = fz.norm_stats(p)
                pooled = fz.block_pooled(p, kb, fs_b, off_b, m, sd)
                out[s : s + p.shape[0]] = pooled.transpose(1, 2).reshape(p.shape[0], bs)
            return out
