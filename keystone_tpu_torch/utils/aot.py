"""Warm a serving model's apply path at every batch bucket ahead of
traffic.

Port of ``warm_buckets`` from ``keystone_tpu/utils/aot.py``. The JAX
package compiles one XLA executable per batch shape; on the card the
per-shape state is cuFFT's plan cache (``PaddedFFT`` builds one plan per
new batch shape) and the caching allocator's blocks. Warming every
bucket once builds them all before the first request. The port has no
persistent compilation cache, so nothing here outlives the process.
``warm_flagship`` waits for the fused streaming flagship
(``imagenet_streaming.py``, ROADMAP item 10d's remainder).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from ..data.dataset import ArrayDataset
from ..device import DeviceLike, resolve_device
from .tree import tree_map


def warm_buckets(
    batch_apply: Callable[[Any], Any],
    example: Any,
    bucket_sizes: Sequence[int],
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Drive ``batch_apply`` (dataset → dataset, e.g. a serving model's
    apply path) through every batch-size bucket on ``device`` (default
    CUDA) AHEAD of traffic.

    ``example`` is one request payload (array, tensor, or a tuple/list/
    dict of them); each bucket runs a zero batch of that shape stacked
    ``bucket`` high with ``num_examples=1`` — logical rows < physical
    rows, which also warms the pad-row masking a partial serving batch
    executes (a full-occupancy batch skips it). Each bucket ends in a
    device synchronize; returns per-bucket seconds as ``bucket_<n>_s``."""
    device = resolve_device(device)

    def zeros(bucket: int) -> Any:
        def leaf(a):
            if isinstance(a, torch.Tensor):
                return torch.zeros((bucket,) + tuple(a.shape), dtype=a.dtype)
            a = np.asarray(a)
            return np.zeros((bucket,) + a.shape, a.dtype)

        return tree_map(leaf, example)

    out: Dict[str, float] = {}
    for bucket in sorted(set(int(b) for b in bucket_sizes)):
        if bucket < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {bucket}")
        batch = zeros(bucket)
        t0 = time.perf_counter()
        batch_apply(ArrayDataset(batch, num_examples=1, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[f"bucket_{bucket}_s"] = round(time.perf_counter() - t0, 4)
    return out
