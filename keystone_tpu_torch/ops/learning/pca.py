"""PCA family: local SVD, TSQR + eigh, randomized, and the cost-model
column wrapper.

Port of ``keystone_tpu/ops/learning/pca.py`` (reference:
nodes/learning/PCA.scala:51-247, nodes/learning/DistributedPCA.scala:20-74,
nodes/learning/ApproximatePCA.scala:22-85), on one device:

- columns are mean-centered before decomposition;
- the MATLAB sign convention is enforced: each component's
  largest-magnitude coefficient is positive
  (PCA.scala enforceMatlabPCASignConvention);
- ``PCATransformer`` projects vectors x ↦ xᵀ·P; ``BatchPCATransformer``
  projects per-item (nᵢ, d) descriptor matrices M·P, a uniform
  (N, c, d) batch as one (N·c, d) product.

``DistributedPCAEstimator`` is the JAX package's TSQR path: the sample
row-sharded over the fit mesh (``partitioner.fit_mesh``), the R factor
of the shards' stacked R factors (``linalg.tsqr_r(x, mesh=mesh)``) and
``eigh`` of the algebraically centered Gram RᵀR − n·μμᵀ, with no
centered copy; one row shard is the single-device QR.
``ApproximatePCAEstimator`` is Halko et al. alg. 4.4/5.1 with q power
iterations; its Gaussian test matrix Ω comes from a ``torch.Generator``
seeded with ``seed`` (the JAX package draws it with ``jax.random``, so
the two draw different Ω; ``omega=`` takes a given one). Products go
through ``linalg.mm`` at the solver mode's precision; the QR, SVD and
eigh are ``torch.linalg``'s. ``PCAEstimator`` and
``DistributedPCAEstimator`` decompose the sample in float64 (the
components they return are float32): a component's error is float32's
rounding times λ₁ over its eigengap, and VOC's 128-wide SIFT sample has
gaps near the 80th component of 1e-4·λ₁, where float32 turned components
by up to 4e-4.

Every estimator declares its fitted projection's spec (``out_spec``) for
the plan-time verifier. A column PCA fit (local or distributed, the two
that ``ColumnPCAEstimator`` runs) is one ``pca:fit`` span (``rows``: the
descriptors it decomposes).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...data.dataset import ArrayDataset, BucketedDataset, Dataset, _as_tensor
from ...device import DeviceLike, resolve_device
from ...obs import spans as _spans
from ...parallel import linalg
from ...parallel.partitioner import fit_mesh
from ...workflow.optimize import DataStats, Optimizable
from ...workflow.pipeline import BatchTransformer, Estimator, Transformer
from ..stats.core import _as_array_dataset
from .cost import DEFAULT_COST_WEIGHTS, CostModel


def enforce_sign_convention(components: torch.Tensor) -> torch.Tensor:
    """Largest-|coefficient| entry of each column made positive
    (reference: PCA.scala enforceMatlabPCASignConvention)."""
    col_max = torch.max(components, dim=0).values
    col_absmax = torch.max(torch.abs(components), dim=0).values
    signs = torch.where(col_max == col_absmax, 1.0, -1.0).to(components.dtype)
    return components * signs


def _components(components, device: DeviceLike) -> torch.Tensor:
    if isinstance(components, torch.Tensor):
        return components.to(torch.float32)
    return torch.tensor(np.asarray(components, dtype=np.float32), device=resolve_device(device))


class PCATransformer(BatchTransformer):
    """Project feature vectors onto the top components: (n,d) @ (d,k)."""

    def __init__(self, components, device: DeviceLike = None):  # (d, k)
        self.components = _components(components, device)

    def apply_arrays(self, x):
        return linalg.mm(x, self.components)


class BatchPCATransformer(Transformer):
    """Project per-item (nᵢ, d) descriptor matrices: M · P → (nᵢ, k)
    (reference: PCA.scala BatchPCATransformer — the reference holds
    descriptors as columns of (d, nᵢ) matrices; this framework's extractors
    emit descriptor rows, so the projection is a right-multiply)."""

    def __init__(self, components, device: DeviceLike = None):
        self.components = _components(components, device)

    def apply(self, mat):
        return linalg.mm(_as_tensor(mat, self.components.device).to(torch.float32), self.components)

    def apply_batch(self, dataset: Dataset) -> Dataset:
        if isinstance(dataset, BucketedDataset):
            return dataset.map_datasets(self.apply_batch)
        if isinstance(dataset, ArrayDataset):
            if isinstance(dataset.data, dict) and "valid" in dataset.data:
                # Masked descriptors: project, validity flows through
                # (zero rows stay zero under a right-multiply).
                desc = dataset.data["desc"]
                n, c, d = desc.shape
                out = linalg.mm(desc.reshape(n * c, d), self.components).reshape(n, c, -1)
                return ArrayDataset({"desc": out, "valid": dataset.data["valid"]},
                                    dataset.num_examples)
            x = dataset.data
            if x.ndim == 2:  # flat (n, d) descriptor rows
                return ArrayDataset(linalg.mm(x, self.components), dataset.num_examples)
            # uniform (n, c, d) stack: one (n·c, d) product
            n, c, d = x.shape
            out = linalg.mm(x.reshape(n * c, d), self.components)
            return ArrayDataset(out.reshape(n, c, -1), dataset.num_examples)
        return dataset.map(self.apply)


class PCAEstimator(Estimator, CostModel):
    """Local (single-computation) SVD PCA (reference: PCA.scala:163-247)."""

    def __init__(self, dims: int):
        self.dims = dims

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        projection replaces the last axis with ``dims``."""
        from ...workflow.verify import projection_fit_spec

        return projection_fit_spec(in_specs, self.label, dims=self.dims)

    def fit(self, data: Dataset) -> PCATransformer:
        ds = _as_array_dataset(data)
        x = ds.data[: ds.num_examples].to(torch.float64)
        return PCATransformer(compute_pca(x, self.dims))

    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS):
        flops = float(n) * d * d
        bytes_scanned = float(n) * d
        network = float(n) * d  # collect to one device
        return max(w.cpu * flops, w.mem * bytes_scanned) + w.network * network


def _pca_svd(x: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(x, dim=0)
    _, _, vt = torch.linalg.svd(x - mu, full_matrices=False)
    return enforce_sign_convention(vt.T)


def compute_pca(x: torch.Tensor, dims: int) -> torch.Tensor:
    return _pca_svd(x)[:, :dims]


class DistributedPCAEstimator(Estimator, CostModel):
    """TSQR-based PCA over the row-sharded sample (reference:
    DistributedPCA.scala:20-74, mlmatrix TSQR). Centering is algebraic: eigh(RᵀR − n·μμᵀ) gives
    the centered covariance eigenvectors without materializing A − μ."""

    def __init__(self, dims: int):
        self.dims = dims

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        projection replaces the last axis with ``dims``."""
        from ...workflow.verify import projection_fit_spec

        return projection_fit_spec(in_specs, self.label, dims=self.dims)

    def fit(self, data: Dataset) -> PCATransformer:
        ds = _as_array_dataset(data)
        mesh = fit_mesh(self)
        x = ds.data[: ds.num_examples].to(torch.float64)
        r = linalg.tsqr_r(x, mesh=mesh)
        sa = torch.sum(x, dim=0)
        components = _centered_eig_components(r, sa, float(ds.num_examples))
        return PCATransformer(components[:, : self.dims])

    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS):
        flops = float(n) * d * d / num_machines + d * d * d
        bytes_scanned = float(n) * d / num_machines
        network = float(d) * d * np.log2(max(num_machines, 2))
        return max(w.cpu * flops, w.mem * bytes_scanned) + w.network * network


def _centered_eig_components(r: torch.Tensor, sa: torch.Tensor, n: float) -> torch.Tensor:
    mu = sa / n
    cov = linalg.mm(r.T, r) - n * torch.outer(mu, mu)
    # eigh returns ascending eigenvalues; PCA wants descending.
    _, vecs = torch.linalg.eigh(cov)
    return enforce_sign_convention(torch.flip(vecs, dims=[1]))


class ApproximatePCAEstimator(Estimator, CostModel):
    """Randomized range-finder PCA (Halko/Martinsson/Tropp 2011, alg 4.4+5.1;
    reference: ApproximatePCA.scala:22-85)."""

    def __init__(self, dims: int, q: int = 10, p: int = 5, seed: int = 0):
        self.dims = dims
        self.q = q
        self.p = p
        self.seed = seed

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        projection replaces the last axis with ``dims``."""
        from ...workflow.verify import projection_fit_spec

        return projection_fit_spec(in_specs, self.label, dims=self.dims)

    def fit(self, data: Dataset) -> PCATransformer:
        ds = _as_array_dataset(data)
        x = ds.data[: ds.num_examples].to(torch.float32)
        comps = approximate_pca(x, self.dims + self.p, self.q, self.seed)
        return PCATransformer(comps[:, : self.dims])

    def cost(self, n, d, k, sparsity, num_machines, w=DEFAULT_COST_WEIGHTS):
        l = k + 5
        flops = float(n) * d * l * (1 + 10)
        bytes_scanned = float(n) * l
        network = float(n) * d
        return max(w.cpu * flops, w.mem * bytes_scanned) + w.network * network


def approximate_pca(x: torch.Tensor, l: int, q: int, seed: int = 0,
                    omega: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-``l`` components of ``x`` by the randomized range finder with
    ``q`` power iterations. Ω (d, l) is ``omega`` when given, else drawn
    N(0, 1) from a ``torch.Generator`` seeded with ``seed``."""
    mu = torch.mean(x, dim=0)
    a = x - mu
    d = a.shape[1]
    if omega is None:
        gen = torch.Generator().manual_seed(seed)
        omega = torch.randn((d, l), generator=gen, dtype=a.dtype)
    qmat, _ = torch.linalg.qr(linalg.mm(a, omega.to(device=a.device, dtype=a.dtype)))
    for _ in range(q):
        yh = linalg.mm(qmat.T, a)          # (l, d)
        qh, _ = torch.linalg.qr(yh.T)      # (d, l)
        qmat, _ = torch.linalg.qr(linalg.mm(a, qh))
    b = linalg.mm(qmat.T, a)               # (l, d)
    _, _, vt = torch.linalg.svd(b, full_matrices=False)
    return enforce_sign_convention(vt.T)


# ------------------------------------------------- optimizable column wrapper


class LocalColumnPCAEstimator(Estimator, CostModel):
    """PCA over the descriptors of per-item (nᵢ, d) matrices, local SVD
    (reference: PCA.scala:51-73)."""

    def __init__(self, dims: int):
        self.dims = dims
        self._inner = PCAEstimator(dims)

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        projection replaces the last axis with ``dims``."""
        from ...workflow.verify import projection_fit_spec

        return projection_fit_spec(in_specs, self.label, dims=self.dims)

    def fit(self, data: Dataset) -> BatchPCATransformer:
        vectors = _columns_to_vectors(data)
        with _spans.span("pca:fit", rows=vectors.num_examples):
            return BatchPCATransformer(self._inner.fit(vectors).components)

    def cost(self, *args, **kw):
        return self._inner.cost(*args, **kw)


class DistributedColumnPCAEstimator(Estimator, CostModel):
    """Descriptor PCA over per-item (nᵢ, d) matrices via TSQR
    (reference: PCA.scala:75-103)."""

    def __init__(self, dims: int):
        self.dims = dims
        self._inner = DistributedPCAEstimator(dims)

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        projection replaces the last axis with ``dims``."""
        from ...workflow.verify import projection_fit_spec

        return projection_fit_spec(in_specs, self.label, dims=self.dims)

    def fit(self, data: Dataset) -> BatchPCATransformer:
        vectors = _columns_to_vectors(data)
        with _spans.span("pca:fit", rows=vectors.num_examples):
            return BatchPCATransformer(self._inner.fit(vectors).components)

    def cost(self, *args, **kw):
        return self._inner.cost(*args, **kw)


class ColumnPCAEstimator(Estimator, Optimizable, CostModel):
    """Cost-model-driven choice between local and distributed column PCA
    (reference: PCA.scala:105-161 ColumnPCAEstimator). ``fit`` takes the
    distributed (TSQR + eigh) path, the reference's default.
    ``num_machines=None`` counts one device."""

    def __init__(self, dims: int, num_machines: Optional[int] = None,
                 weights=DEFAULT_COST_WEIGHTS):
        self.dims = dims
        self.num_machines = num_machines
        self.weights = weights
        self.local = LocalColumnPCAEstimator(dims)
        self.distributed = DistributedColumnPCAEstimator(dims)

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        projection replaces the last axis with ``dims``."""
        from ...workflow.verify import projection_fit_spec

        return projection_fit_spec(in_specs, self.label, dims=self.dims)

    def fit(self, data: Dataset):
        return self.distributed.fit(data)

    def optimize(self, samples: List[Dataset], stats: DataStats):
        items = samples[0].take(8)
        if not items:
            return self.distributed
        if isinstance(items[0], dict) and "valid" in items[0]:
            # Masked-descriptor items ({"desc": (n_pad, d), "valid": ...}):
            # the true per-item descriptor count is the valid total.
            cols = float(np.mean([np.asarray(m["valid"]).sum() for m in items]))
            d = int(np.asarray(items[0]["desc"]).shape[-1])
        elif np.asarray(items[0]).ndim == 1:
            # Plain feature vectors: one row per item.
            cols, d = 1.0, int(np.asarray(items[0]).shape[0])
        else:
            cols = float(np.mean([np.asarray(m).shape[0] for m in items]))
            d = int(np.asarray(items[0]).shape[1])
        n = int(cols * stats.n_total)
        machines = self.num_machines or 1
        lc = self.local.cost(n, d, self.dims, 1.0, machines, self.weights)
        dc = self.distributed.cost(n, d, self.dims, 1.0, machines, self.weights)
        return self.local if lc < dc else self.distributed


def _columns_to_vectors(data: Dataset) -> ArrayDataset:
    """Flatten per-item (nᵢ, d) descriptor matrices into one (Σnᵢ, d)
    vector dataset."""
    if isinstance(data, ArrayDataset):
        x = data.data
        if x.ndim == 2:
            return ArrayDataset(x, data.num_examples)
        n, c, d = x[: data.num_examples].shape
        return ArrayDataset(x[: data.num_examples].reshape(n * c, d))
    mats = [torch.as_tensor(np.asarray(m)) if not isinstance(m, torch.Tensor) else m
            for m in data.collect()]
    return ArrayDataset(torch.cat(mats))
