"""Carry fitted parameters from the JAX package into the port.

The caller converts the JAX model's arrays to numpy (``np.asarray(m.weights)``
and so on), so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.learning.block import BlockLinearMapper
from .ops.stats.core import LinearRectifier, PaddedFFT, RandomSignNode
from .ops.util.labels import MaxClassifier
from .ops.util.vectors import VectorCombiner
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
