"""Carry fitted parameters and stream state from the JAX package into
the port.

The caller converts the JAX model's arrays to numpy (``np.asarray(m.weights)``
and so on), so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.images.core import (
    Convolver,
    FusedConvFeaturizer,
    GrayScaler,
    PixelScaler,
    Pooler,
    SymmetricRectifier,
)
from .ops.images.fisher import FisherVector
from .ops.images.lcs import LCSExtractor
from .ops.images.sift import SIFTExtractor
from .ops.learning.block import BlockLinearMapper
from .ops.learning.conv_block import ConvBlockModel
from .ops.learning.gmm import GaussianMixtureModel
from .ops.learning.kernel import KernelBlockLinearMapper
from .ops.learning.pca import BatchPCATransformer
from .ops.learning.zca import ZCAWhitener
from .ops.stats.core import (
    LinearRectifier,
    NormalizeRows,
    PaddedFFT,
    RandomSignNode,
    SignedHellingerMapper,
)
from .ops.util.labels import MaxClassifier, TopKClassifier
from .ops.util.vectors import FloatToDouble, MatrixVectorizer, VectorCombiner
from .pipelines.imagenet_streaming import FlagshipCodebooks
from .refit.state import StreamState
from .workflow.pipeline import FittedPipeline, Pipeline


def _tensor(a: Optional[np.ndarray], device: torch.device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def mapper_from_numpy(
    weights: np.ndarray,
    block_size: int,
    intercept: Optional[np.ndarray] = None,
    feature_mean: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> BlockLinearMapper:
    """The port's :class:`BlockLinearMapper` holding a JAX
    ``BlockLinearMapper``'s parameters, on ``device`` (default CUDA)."""
    device = resolve_device(device)
    return BlockLinearMapper(
        _tensor(weights, device),
        block_size=int(block_size),
        intercept=_tensor(intercept, device),
        feature_mean=_tensor(feature_mean, device),
    )


def mnist_pipeline_from_numpy(
    signs: Sequence[np.ndarray],
    weights: np.ndarray,
    block_size: int,
    intercept: Optional[np.ndarray] = None,
    feature_mean: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> FittedPipeline:
    """The port's fitted MNIST random-FFT pipeline holding a JAX-fitted
    one's parameters: one ``RandomSignNode.signs`` vector per branch and
    the ``BlockLinearMapper``'s weights, intercept and feature mean. The
    result is gather(sign → FFT → ReLU per branch) → combine → mapper →
    argmax, on ``device`` (default CUDA)."""
    branches = [
        RandomSignNode(s, device=device) >> PaddedFFT() >> LinearRectifier(0.0) for s in signs
    ]
    mapper = mapper_from_numpy(weights, block_size, intercept, feature_mean, device=device)
    return (Pipeline.gather(branches) >> VectorCombiner() >> mapper >> MaxClassifier()).fit()


def stream_state_from_numpy(
    kind: str,
    carry: Sequence[np.ndarray],
    num_examples: int,
    meta: Optional[Dict[str, Any]] = None,
) -> StreamState:
    """The port's :class:`~keystone_tpu_torch.refit.state.StreamState`
    holding a JAX envelope's host arrays (``state.carry`` converted with
    ``np.asarray``): a "gram" or "sketch" state captured by the JAX
    package then finishes, merges or seeds a fold in the port. The sketch
    map (variant, seed) rides ``meta``, and the row hash is the JAX
    package's bit for bit, so the port extends a JAX-captured sketch
    under the same map."""
    return StreamState(
        kind=kind,
        estimator="converted",
        num_examples=int(num_examples),
        carry=tuple(np.asarray(a, dtype=np.float32) for a in carry),
        meta=dict(meta or {}),
    )


def kernel_mapper_from_numpy(
    train: np.ndarray,
    duals: np.ndarray,
    gamma: float,
    num_train: int,
    block_size: int,
    device: DeviceLike = None,
) -> KernelBlockLinearMapper:
    """The port's :class:`KernelBlockLinearMapper` holding a JAX-fitted
    one's training rows and duals (pad rows included; their duals are
    zero), on ``device`` (default CUDA)."""
    device = resolve_device(device)
    return KernelBlockLinearMapper(
        _tensor(train, device), _tensor(duals, device), float(gamma),
        num_train=int(num_train), block_size=int(block_size),
    )


def zca_whitener_from_numpy(
    whitener: np.ndarray, means: np.ndarray, device: DeviceLike = None
) -> ZCAWhitener:
    """The port's :class:`ZCAWhitener` holding a JAX-fitted one's W (d, d)
    and means (d,), on ``device`` (default CUDA)."""
    device = resolve_device(device)
    return ZCAWhitener(_tensor(whitener, device), _tensor(means, device))


def conv_block_model_from_numpy(
    filters: np.ndarray,
    weights: np.ndarray,
    feature_mean: np.ndarray,
    intercept: np.ndarray,
    whitener_means: Optional[np.ndarray] = None,
    img_channels: int = 3,
    normalize_patches: bool = True,
    var_constant: float = 10.0,
    alpha: float = 0.25,
    max_val: float = 0.0,
    pool_stride: int = 13,
    pool_size: int = 14,
    pool_function: str = "sum",
    filter_block: int = 512,
    block_size: int = 4096,
    image_chunk: int = 2048,
    device: DeviceLike = None,
) -> ConvBlockModel:
    """The port's :class:`ConvBlockModel` holding a JAX-fitted one: the
    featurizer's packed (already whitened) filters (F, s·s·C), the
    whitener means its convolver subtracts (None without a whitener), and
    the standard-layout linear model's weights, feature mean and
    intercept; the other arguments are the featurizer's and the
    estimator's settings. Applying the model needs only the whitener's
    means, so its convolver holds a whitener of means alone. On
    ``device`` (default CUDA)."""
    device = resolve_device(device)
    whitener = None if whitener_means is None else ZCAWhitener(None, _tensor(whitener_means, device))
    featurizer = FusedConvFeaturizer(
        Convolver(filters, img_channels, whitener=whitener, normalize_patches=normalize_patches,
                  var_constant=var_constant, device=device),
        SymmetricRectifier(max_val=max_val, alpha=alpha),
        Pooler(pool_stride, pool_size, None, pool_function),
        filter_block=filter_block,
    )
    linear = mapper_from_numpy(weights, block_size, intercept, feature_mean, device=device)
    return ConvBlockModel(featurizer, linear, image_chunk=image_chunk)


def pca_from_numpy(components: np.ndarray, device: DeviceLike = None) -> BatchPCATransformer:
    """The port's :class:`BatchPCATransformer` holding a JAX-fitted PCA's
    (d, k) components, on ``device`` (default CUDA)."""
    return BatchPCATransformer(components, device=device)


def gmm_from_numpy(
    means: np.ndarray,
    variances: np.ndarray,
    weights: np.ndarray,
    weight_threshold: float = 1e-4,
    device: DeviceLike = None,
) -> GaussianMixtureModel:
    """The port's :class:`GaussianMixtureModel` holding a JAX-fitted one's
    (d, k) means and variances and (k,) weights, on ``device`` (default
    CUDA)."""
    return GaussianMixtureModel(means, variances, weights, weight_threshold, device=device)


def voc_pipeline_from_numpy(
    pca_components: np.ndarray,
    gmm_means: np.ndarray,
    gmm_variances: np.ndarray,
    gmm_weights: np.ndarray,
    weights: np.ndarray,
    block_size: int,
    intercept: Optional[np.ndarray] = None,
    feature_mean: Optional[np.ndarray] = None,
    scale_step: int = 0,
    device: DeviceLike = None,
) -> FittedPipeline:
    """The port's fitted VOC SIFT + Fisher-vector pipeline
    (``pipelines/voc.py``) holding a JAX-fitted one's parameters: the
    PCA's (d, k) components, the GMM's means, variances and weights, and
    the ``BlockLinearMapper``'s weights, intercept and feature mean. On
    ``device`` (default CUDA)."""
    chain = (
        PixelScaler().to_pipeline()
        >> GrayScaler()
        >> SIFTExtractor(scale_step=scale_step)
        >> pca_from_numpy(pca_components, device=device)
        >> FisherVector(gmm_from_numpy(gmm_means, gmm_variances, gmm_weights, device=device))
        >> FloatToDouble()
        >> MatrixVectorizer()
        >> NormalizeRows()
        >> SignedHellingerMapper()
        >> NormalizeRows()
        >> mapper_from_numpy(weights, block_size, intercept, feature_mean, device=device)
    )
    return chain.fit()


def _fisher_branch(prefix: Pipeline, branch: Dict[str, np.ndarray], device: DeviceLike) -> Pipeline:
    return (
        prefix
        >> pca_from_numpy(branch["pca_components"], device=device)
        >> FisherVector(gmm_from_numpy(branch["gmm_means"], branch["gmm_variances"],
                                       branch["gmm_weights"], device=device))
        >> FloatToDouble()
        >> MatrixVectorizer()
        >> NormalizeRows()
        >> SignedHellingerMapper()
        >> NormalizeRows()
    )


def imagenet_pipeline_from_numpy(
    sift_branch: Dict[str, np.ndarray],
    lcs_branch: Dict[str, np.ndarray],
    weights: np.ndarray,
    block_size: int,
    intercept: Optional[np.ndarray] = None,
    feature_mean: Optional[np.ndarray] = None,
    sift_scale_step: int = 1,
    lcs_stride: int = 4,
    lcs_border: int = 16,
    lcs_patch: int = 6,
    top_k: Optional[int] = 5,
    device: DeviceLike = None,
) -> FittedPipeline:
    """The port's fitted ImageNet SIFT + LCS + Fisher-vector pipeline
    (``pipelines/imagenet.py``, the fixed-size graph) holding a
    JAX-fitted flagship's parameters. Each branch is a dict of numpy
    arrays: ``pca_components`` (d, k), ``gmm_means`` / ``gmm_variances``
    (k, K) and ``gmm_weights`` (K,); ``weights``, ``intercept`` and
    ``feature_mean`` are the weighted solver's ``BlockLinearMapper``'s.
    ``top_k=None`` leaves out the ``TopKClassifier`` (the pipeline then
    returns the class scores). On ``device`` (default CUDA)."""
    sift = _fisher_branch(
        PixelScaler().to_pipeline() >> GrayScaler() >> SIFTExtractor(scale_step=sift_scale_step)
        >> SignedHellingerMapper(),
        sift_branch, device,
    )
    lcs = _fisher_branch(
        LCSExtractor(stride=lcs_stride, stride_start=lcs_border, sub_patch_size=lcs_patch).to_pipeline(),
        lcs_branch, device,
    )
    chain = (
        Pipeline.gather([sift, lcs])
        >> VectorCombiner()
        >> mapper_from_numpy(weights, block_size, intercept, feature_mean, device=device)
    )
    if top_k is not None:
        chain = chain >> TopKClassifier(top_k)
    return chain.fit()


def flagship_codebooks_from_numpy(
    sift_pca: np.ndarray,
    lcs_pca: np.ndarray,
    sift_gmm: Sequence[np.ndarray],
    lcs_gmm: Sequence[np.ndarray],
    device: DeviceLike = None,
) -> FlagshipCodebooks:
    """The streaming flagship's codebooks (``pipelines/imagenet_streaming.py``)
    from a JAX-fitted ``StreamingFlagship``'s: each branch's PCA
    components (desc_d, pca_d) and its GMM as ``_gmm_arrays`` lays it out,
    (means (D, K), variances (D, K), weights (K,)). On ``device`` (default
    CUDA); adopt them with ``StreamingFlagship.adopt_codebooks``."""
    device = resolve_device(device)

    def encoder(gmm) -> FisherVector:
        return FisherVector(GaussianMixtureModel(*gmm, device=device))

    return FlagshipCodebooks(sift_pca=_tensor(sift_pca, device), sift_fv=encoder(sift_gmm),
                             lcs_pca=_tensor(lcs_pca, device), lcs_fv=encoder(lcs_gmm))
