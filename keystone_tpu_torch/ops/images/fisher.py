"""Fisher Vector encoding from GMM posteriors.

Port of ``keystone_tpu/ops/images/fisher.py`` (reference:
nodes/images/FisherVector.scala:20-94,
nodes/images/external/FisherVector.scala:17-55,
src/main/cpp/EncEval.cxx:1-100 ``calcAndGetFVs``). The math (Sanchez et
al., IJCV 2013, as the reference implements it):

    s0 = mean_n q_nk                         (K,)
    s1 = Xᵀ q / n                            (D, K)
    s2 = (X∘X)ᵀ q / n                        (D, K)
    fv1 = (s1 − μ·diag(s0)) / (σ·diag(√w))
    fv2 = (s2 − 2μ∘s1 + (μ∘μ − σ²)·diag(s0)) / (σ²·diag(√(2w)))
    FV  = [fv1 | fv2]                        (D, 2K)

The statistics [s1 | s2]ᵀ = [X | X∘X]ᵀ q are one product per image, taken
as one strided batched call through the solver binding at IEEE fp32
(``gemm.gemm_batched``): ``torch.einsum`` / ``bmm`` would read PyTorch's
process-wide TF32 switch. The posteriors come from
:class:`~keystone_tpu_torch.ops.learning.gmm.GaussianMixtureModel`.

``FisherVector`` walks ``image_chunk`` images at a time, each chunk one
``fisher:encode`` span (``images``): at 24,030 descriptors and 256
Gaussians one image's posteriors are 24.6 MB, and the whole batch's
would not fit beside the descriptors.

Masked descriptor batches (``{"desc", "valid"}`` from the native-
resolution extractors, ``ops/images/native.py``) encode through
``apply_arrays_masked``: invalid rows contribute nothing and each image's
statistics divide by its true descriptor count, and the output is dense
(N, D, 2K) — the boundary where the raggedness ends.
"""

from __future__ import annotations

import torch

from ...data.dataset import ArrayDataset, BucketedDataset, Dataset
from ...obs import spans as _spans
from ...workflow.optimize import DataStats, Optimizable
from ...workflow.pipeline import BatchTransformer, Estimator
from ..cuda import gemm as _gemm
from ..learning.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator


class FisherVector(BatchTransformer):
    """Encode (N, n_desc, D) descriptor batches into (N, D, 2K) Fisher
    vectors (reference: FisherVector.scala:33-53)."""

    #: Images per posterior pass (module docstring).
    image_chunk = 64

    def __init__(self, gmm: GaussianMixtureModel):
        self.gmm = gmm

    def apply_arrays(self, x):
        return self._encode(x.to(torch.float32), None)

    def apply_arrays_masked(self, x, valid):
        """Fisher-encode ragged descriptor batches: ``x`` (N, n_pad, D)
        with per-image validity ``valid`` (N, n_pad). Equal to
        ``apply_arrays`` on each image's own valid descriptors (the
        reference encodes per-image descriptor sets of varying size,
        FisherVector.scala:33-53)."""
        return self._encode(x.to(torch.float32), torch.as_tensor(valid, device=x.device))

    def _encode(self, x: torch.Tensor, valid) -> torch.Tensor:
        n, n_desc, dim = x.shape
        k = self.gmm.k
        means = self.gmm.means                    # (D, K)
        variances = self.gmm.variances            # (D, K)
        weights = self.gmm.weights                # (K,)
        scale1 = torch.sqrt(variances) * torch.sqrt(weights)
        scale2 = variances * torch.sqrt(2.0 * weights)
        out = torch.empty((n, dim, 2 * k), dtype=torch.float32, device=x.device)
        for start in range(0, n, self.image_chunk):
            xc = x[start : start + self.image_chunk]
            b = xc.shape[0]
            with _spans.span("fisher:encode", images=b):
                q = self.gmm.apply_arrays(xc.reshape(-1, dim)).reshape(b, n_desc, k)
                if valid is None:
                    count = n_desc
                    s0 = torch.mean(q, dim=1)[:, None, :]                    # (B, 1, K)
                else:
                    m = valid[start : start + b].to(torch.float32)          # (B, n)
                    count = torch.clamp_min(m.sum(dim=1), 1.0)[:, None, None]
                    q = q * m[..., None]                                     # zero invalid rows
                    s0 = torch.sum(q, dim=1)[:, None, :] / count
                stats = _gemm.gemm_batched(
                    torch.cat([xc, xc * xc], dim=2).transpose(1, 2), q, "ieee_fp32"
                ) / count                                                    # (B, 2D, K)
                del q
                s1, s2 = stats[:, :dim], stats[:, dim:]
                out[start : start + b, :, :k] = (s1 - means * s0) / scale1
                out[start : start + b, :, k:] = (
                    s2 - 2.0 * means * s1 + (means * means - variances) * s0
                ) / scale2
        return out

    def apply_batch(self, dataset):
        """Masked-descriptor datasets (``{"desc", "valid"}``) encode
        through ``apply_arrays_masked`` and come out dense."""
        if isinstance(dataset, BucketedDataset):
            return dataset.map_datasets(self.apply_batch)
        if isinstance(dataset, ArrayDataset) and isinstance(dataset.data, dict) \
                and "valid" in dataset.data:
            n = dataset.num_examples
            out = self.apply_arrays_masked(dataset.data["desc"][:n], dataset.data["valid"][:n])
            return ArrayDataset(out, n)
        return super().apply_batch(dataset)


class GMMFisherVectorEstimator(Estimator, Optimizable):
    """Fit a diagonal GMM on all descriptors, return a FisherVector encoder
    (reference: FisherVector.scala:67-97 ScalaGMMFisherVectorEstimator +
    optimizable GMMFisherVectorEstimator). The reference's ``optimize()``
    swaps in the native enceval encoder when k ≥ 32; here, as in the JAX
    package, one implementation serves both, so ``optimize()`` returns
    ``self``."""

    def __init__(self, k: int, seed: int = 0):
        self.k = k
        self.seed = seed

    def fit(self, data: Dataset) -> FisherVector:
        arrays = data if isinstance(data, ArrayDataset) else data.to_arrays()
        x = arrays.data[: arrays.num_examples].to(torch.float32)
        if x.ndim == 3:  # (N, n_desc, D) → all descriptors pooled
            x = x.reshape(-1, x.shape[-1])
        gmm = GaussianMixtureModelEstimator(self.k, seed=self.seed).fit(ArrayDataset(x))
        return FisherVector(gmm)

    def optimize(self, samples, stats: DataStats):
        return self
