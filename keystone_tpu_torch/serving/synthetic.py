"""Synthetic fitted pipelines for serving smoke tests and the
``serve --synthetic`` CLI path — a stand-in for a real featurize+solve
pipeline with tunable compute per request.

Port of ``keystone_tpu/serving/synthetic.py``. The JAX ``trace_log``
records each new shape XLA traces; here it records the first application
at each new input shape, which is what a warm bucket must not see again.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..workflow.pipeline import BatchTransformer, FittedPipeline


class SyntheticDense(BatchTransformer):
    """A depth-layer tanh MLP over float32 tensors."""

    def __init__(self, weights: List[torch.Tensor], trace_log: Optional[list] = None):
        self.weights = weights
        self.trace_log = trace_log
        self._seen_shapes: set = set()

    @property
    def label(self) -> str:
        return f"SyntheticDense[d={self.weights[0].shape[0]}x{len(self.weights)}]"

    def apply_arrays(self, x):
        if self.trace_log is not None:
            shape = tuple(x.shape)
            if shape not in self._seen_shapes:
                self._seen_shapes.add(shape)
                self.trace_log.append(shape)
        for w in self.weights[:-1]:
            x = torch.tanh(x @ w)
        return x @ self.weights[-1]


def synthetic_fitted_pipeline(
    d: int = 64,
    depth: int = 2,
    seed: int = 0,
    trace_log: Optional[list] = None,
    device: DeviceLike = None,
) -> FittedPipeline:
    """A transformer-only FittedPipeline: ``depth`` dense tanh layers of
    width ``d`` (float32) on ``device`` (default CUDA). The weights are
    the JAX package's for the same ``seed``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(d)
    weights = [
        torch.from_numpy((rng.standard_normal((d, d)) * scale).astype(np.float32)).to(device)
        for _ in range(max(1, depth))
    ]
    pipeline = SyntheticDense(weights, trace_log=trace_log).to_pipeline()
    return FittedPipeline(pipeline.graph, pipeline.source, pipeline.sink)


def synthetic_chain_pipeline(
    num_nodes: int = 4,
    d: int = 64,
    seed: int = 0,
    fused: bool = True,
    device: DeviceLike = None,
) -> FittedPipeline:
    """A transformer-only FittedPipeline that is a CHAIN of ``num_nodes``
    single-layer dense ops (each its own graph node), on ``device``
    (default CUDA) — the fusion smoke workload. With ``fused=True`` the
    chain collapses into one
    :class:`~keystone_tpu_torch.workflow.fusion.FusedTransformerOperator`;
    ``fused=False`` keeps one node per op. Both compute identical outputs
    for the same ``seed``, with the JAX package's weights."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(d)
    pipeline = None
    for _ in range(max(1, num_nodes)):
        w = (rng.standard_normal((d, d)) * scale).astype(np.float32)
        node = SyntheticDense([torch.from_numpy(w).to(device)])
        pipeline = node.to_pipeline() if pipeline is None else pipeline.then(node)
    fitted = FittedPipeline(pipeline.graph, pipeline.source, pipeline.sink)
    # fused=False returns the graph as built without touching the
    # process-wide fusion switch (a fusion_disabled() window here would
    # race concurrent fits in serving threads).
    return fitted.fused() if fused else fitted


def synthetic_requests(n: int, d: int = 64, seed: int = 1) -> List[Any]:
    """``n`` request payloads of shape (d,), deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(d).astype(np.float32) for _ in range(n)]
