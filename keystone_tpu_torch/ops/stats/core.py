"""Statistical / elementwise vector operators.

Port of ``keystone_tpu/ops/stats/core.py``. Each one is a whole-batch
tensor function over (n, d) tensors on the device the data lies on:

- ``RandomSignNode``       (reference: nodes/stats/RandomSignNode.scala)
- ``PaddedFFT``            (reference: nodes/stats/PaddedFFT.scala:13-21), on ``torch.fft``
- ``LinearRectifier``      (reference: nodes/stats/LinearRectifier.scala)
- ``CosineRandomFeatures`` (reference: nodes/stats/CosineRandomFeatures.scala:19-75)
- ``NormalizeRows``, ``SignedHellingerMapper``, ``Clipper``
- ``StandardScaler``       (reference: nodes/stats/StandardScaler.scala:16-77)
- ``Sampler``              (reference: nodes/stats/Sampler.scala)
- ``ColumnSampler``        (descriptor rows sampled from per-item matrices)

Random parameters are drawn on the host with ``np.random.default_rng(seed)``
exactly as the JAX package draws them, then placed on ``device`` (default
CUDA), so both packages hold the same signs and weights, and sample the
same rows. ``ColumnSampler``'s masked draw is the JAX package's
``jax.random`` draw (threefry-2x32 under ``PRNGKey(seed)``) reproduced on
the data's device by :func:`~.jax_random.jax_uniform_mantissas`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...data.dataset import ArrayDataset, BucketedDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...obs import spans as _spans
from ...parallel import linalg
from ...utils.tree import tree_map
from ...workflow.pipeline import BatchTransformer, Estimator, Transformer
from .jax_random import jax_uniform_mantissas


def _as_array_dataset(data: Dataset) -> ArrayDataset:
    if isinstance(data, ArrayDataset):
        return data
    if isinstance(data, BucketedDataset):
        return data.concat()
    return data.to_arrays()


def _param(a, device: DeviceLike) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=resolve_device(device))


class RandomSignNode(BatchTransformer):
    """Multiply each feature by a fixed random ±1 sign."""

    def __init__(self, signs, device: DeviceLike = None):
        self.signs = _param(signs, device)

    @staticmethod
    def create(size: int, seed: int = 0, device: DeviceLike = None) -> "RandomSignNode":
        rng = np.random.default_rng(seed)
        return RandomSignNode(2.0 * rng.integers(0, 2, size=size) - 1.0, device=device)

    def apply_arrays(self, x):
        return x * self.signs


def next_power_of_two(n: int) -> int:
    return 1 << (n - 1).bit_length()


class PaddedFFT(BatchTransformer):
    """Zero-pad features to the next power of two; return the real parts of
    the first half of the Fourier transform (size p/2 output), in the
    input's dtype, on the input's device."""

    def apply_arrays(self, x):
        d = x.shape[-1]
        p = next_power_of_two(d)
        padded = torch.nn.functional.pad(x, (0, p - d))
        # rfft returns p//2+1 coefficients; the reference keeps [0, p/2).
        # ``.real`` is a strided view of the complex result: copy the kept
        # half out so the complex temporary is freed.
        return torch.fft.rfft(padded, dim=-1).real[..., : p // 2].to(x.dtype).contiguous()


class CosineRandomFeatures(BatchTransformer):
    """Rahimi-Recht random cosine features: cos(x·Wᵀ + b)
    (reference: nodes/stats/CosineRandomFeatures.scala:19-75)."""

    def __init__(self, w, b, device: DeviceLike = None):
        if np.shape(b)[0] != np.shape(w)[0]:
            raise ValueError("rows of W and size of b must match")
        with _spans.span("build:upload", bytes=4 * (int(np.size(w)) + int(np.size(b)))):
            self.w = _param(w, device)
            self.b = _param(b, device)

    @staticmethod
    def create(
        num_input_features: int,
        num_output_features: int,
        gamma: float,
        dist: str = "gaussian",
        seed: int = 0,
        device: DeviceLike = None,
    ) -> "CosineRandomFeatures":
        """W ~ gamma·dist, b ~ U[0, 2π), drawn as the JAX package draws them,
        on the host in a ``build:draw`` span (the copy to ``device`` is
        the constructor's ``build:upload``)."""
        with _spans.span("build:draw"):
            rng = np.random.default_rng(seed)
            if dist == "gaussian":
                w = rng.normal(size=(num_output_features, num_input_features))
            elif dist == "cauchy":
                w = rng.standard_cauchy(size=(num_output_features, num_input_features))
            else:
                raise ValueError(f"unknown distribution {dist!r}")
            b = rng.uniform(0.0, 2.0 * np.pi, size=num_output_features)
        # Scaled and uploaded while the unscaled draw is still alive: the
        # order of these large host frees decides how much of the heap the
        # next branch has to fault back in (freeing the draw before the
        # upload made TIMIT's 50-branch build ~0.9 s slower on the H100's
        # host).
        return CosineRandomFeatures(w * gamma, b, device=device)

    def apply_arrays(self, x):
        return torch.cos(linalg.mm(x, self.w.T) + self.b)


class LinearRectifier(BatchTransformer):
    """f(x) = max(max_val, x - alpha)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def apply_arrays(self, x):
        return torch.clamp_min(x - self.alpha, self.max_val)


class NormalizeRows(BatchTransformer):
    """Scale each row to unit L2 norm (zero rows stay zero)."""

    def apply_arrays(self, x):
        norms = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.where(norms == 0, torch.ones_like(norms), norms)


class SignedHellingerMapper(BatchTransformer):
    """x ↦ sign(x)·sqrt(|x|)."""

    def apply_arrays(self, x):
        return torch.sign(x) * torch.sqrt(torch.abs(x))


class Clipper(BatchTransformer):
    """Elementwise clip to [lo, hi]."""

    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def apply_arrays(self, x):
        return torch.clamp(x, self.lo, self.hi)


class StandardScalerModel(BatchTransformer):
    """Subtract column means; optionally divide by column stds."""

    def __init__(self, mean: torch.Tensor, std: Optional[torch.Tensor] = None):
        self.mean = mean
        self.std = std

    def apply_arrays(self, x):
        out = x - self.mean
        if self.std is not None:
            out = out / self.std
        return out


class StandardScaler(Estimator):
    """Fit column mean/std in one masked pass on the data's device.

    Degenerate stds (0, NaN, inf, <eps) become 1.0, matching the
    reference's guard (StandardScaler.scala:50-56). Uses the unbiased
    (n-1) variance like MLlib's summarizer.
    """

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        transformer keeps its input's shape and dtype."""
        from ...workflow.verify import elementwise_fit_spec

        return elementwise_fit_spec(in_specs, self.label)

    def fit(self, data: Dataset) -> StandardScalerModel:
        ds = data if isinstance(data, ArrayDataset) else data.to_arrays()
        x = ds.data
        n = ds.num_examples
        mask = ds.mask().to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        s1 = torch.sum(x * mask, dim=0)
        mean = s1 / n
        if not self.normalize_std_dev:
            return StandardScalerModel(mean, None)
        s2 = torch.sum((x * mask) ** 2, dim=0)
        var = (s2 - n * mean**2) / max(n - 1, 1)
        std = torch.sqrt(torch.clamp_min(var, 0.0))
        bad = torch.isnan(std) | torch.isinf(std) | (torch.abs(std) < self.eps)
        std = torch.where(bad, torch.ones_like(std), std)
        return StandardScalerModel(mean, std)


class Sampler(Transformer):
    """Random subsample of ``num_samples`` items, chosen on the host with
    ``np.random.default_rng(seed)`` as in the JAX package
    (reference: nodes/stats/Sampler.scala)."""

    def __init__(self, num_samples: int, seed: int = 42):
        self.num_samples = num_samples
        self.seed = seed

    def apply(self, datum):
        return datum

    def apply_batch(self, dataset: Dataset) -> Dataset:
        rng = np.random.default_rng(self.seed)
        n = len(dataset)
        take = min(self.num_samples, n)
        idx = np.sort(rng.choice(n, size=take, replace=False))
        if isinstance(dataset, ArrayDataset):
            data = tree_map(lambda a: a[torch.as_tensor(idx, device=a.device)], dataset.data)
            return ArrayDataset(data, num_examples=take)
        items = dataset.collect()
        return type(dataset)([items[i] for i in idx])


class ColumnSampler(Transformer):
    """Sample descriptor rows from per-item (n_i, d) descriptor matrices
    into one flat (num_samples_total, d) dataset (reference:
    nodes/stats/ColumnSampler, used by the ImageNet/VOC pipelines; the
    reference's matrices are (d, nᵢ) column-major, this framework's
    extractors emit descriptor rows).

    A uniform (N, c, d) batch picks the JAX package's rows: per item the
    first ``take`` positions of ``argsort`` of one ``rng.random((N, c))``
    draw from ``np.random.default_rng(seed)``. The draw is made in
    ``chunk_items``-row pieces in order, which yields the same numbers as
    the one (N, c) draw, and each piece is argsorted on the data's device.
    An ``ObjectDataset`` threads one generator through ``rng.choice`` per
    item, as the JAX package does. Each batch's draw is one
    ``sample:draw`` span (``items``, ``take``: rows kept per item)."""

    #: Items per host draw and device argsort of the uniform path.
    chunk_items = 256

    def __init__(self, num_samples_per_item: int, seed: int = 42):
        self.num_samples_per_item = num_samples_per_item
        self.seed = seed

    def _sample(self, datum, rng):
        n_desc = datum.shape[0]
        take = min(self.num_samples_per_item, n_desc)
        idx = rng.choice(n_desc, size=take, replace=False)
        if isinstance(datum, torch.Tensor):
            return datum[torch.as_tensor(idx, device=datum.device)]
        return np.asarray(datum)[idx]  # (take, d)

    def apply(self, datum):
        return self._sample(datum, np.random.default_rng(self.seed))

    def apply_batch(self, dataset: Dataset) -> ArrayDataset:
        with _spans.span("sample:draw", items=len(dataset), take=self.num_samples_per_item) as sp:
            return self._draw(dataset, sp)

    def _draw(self, dataset: Dataset, sp) -> ArrayDataset:
        if isinstance(dataset, BucketedDataset):
            # Masked descriptors per bucket, the small sample matrices
            # concatenated.
            return ArrayDataset(torch.cat([self._sample_bucket(b, i).data
                                           for i, b in enumerate(dataset.buckets)]))
        if isinstance(dataset, ArrayDataset) and isinstance(dataset.data, dict) \
                and "valid" in dataset.data:
            return self._sample_bucket(dataset, 0)
        if isinstance(dataset, ArrayDataset):
            x = dataset.data[: dataset.num_examples]
            n, c = x.shape[0], x.shape[1]
            take = min(self.num_samples_per_item, c)
            sp.set_attribute("take", take)
            rng = np.random.default_rng(self.seed)
            out = torch.empty((n * take,) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            for start in range(0, n, self.chunk_items):
                stop = min(start + self.chunk_items, n)
                keys = torch.from_numpy(rng.random((stop - start, c))).to(x.device)
                idx = torch.argsort(keys, dim=1, stable=True)[:, :take]
                rows = torch.arange(start, stop, device=x.device)[:, None]
                out[start * take : stop * take] = x[rows, idx].reshape((-1,) + tuple(x.shape[2:]))
            return ArrayDataset(out)
        # One rng threaded across items: re-seeding per item would sample
        # identical descriptor positions from every matrix. Tensor items
        # stay on their device; host arrays go where ArrayDataset puts them.
        rng = np.random.default_rng(self.seed)
        rows = [self._sample(item, rng) for item in dataset.collect()]
        if rows and isinstance(rows[0], torch.Tensor):
            return ArrayDataset(torch.cat(rows))
        return ArrayDataset(np.concatenate(rows, axis=0))

    def _sample_bucket(self, bucket: ArrayDataset, bucket_idx: int) -> ArrayDataset:
        """Uniform sample without replacement of a bucket's valid
        descriptors, the JAX package's draw: the valid slots with the
        ``take`` largest Gumbel keys of ``PRNGKey(seed + 7919·bucket)``
        (invalid slots −∞), in descending key order. The Gumbel transform
        is strictly increasing in the uniform draw, so the order is that of
        the draws' mantissas, ties to the lower slot (``lax.top_k``'s)."""
        n = bucket.num_examples
        desc = bucket.data["desc"][:n]
        valid = bucket.data["valid"][:n].reshape(-1).to(torch.bool)
        flat = desc.reshape(-1, desc.shape[-1])
        num_valid = int(valid.sum())  # one scalar read per bucket
        take = min(self.num_samples_per_item * n, num_valid)
        if take == 0:
            return ArrayDataset(torch.zeros((0, desc.shape[-1]), dtype=torch.float32, device=desc.device))
        keys = jax_uniform_mantissas(self.seed + 7919 * bucket_idx, valid.numel(), desc.device)
        keys = torch.where(valid, keys, torch.full_like(keys, -1))
        order = torch.sort(keys, descending=True, stable=True).indices[:take]
        return ArrayDataset(flat[order])
