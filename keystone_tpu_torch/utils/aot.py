"""Warm a serving model's apply path at every batch bucket, and the
streaming flagship at its bucket and solver shapes, ahead of traffic.

Port of ``keystone_tpu/utils/aot.py``. The JAX package compiles one XLA
executable per shape; on the card the per-shape state is cuFFT's plan
cache (``PaddedFFT`` builds one plan per new batch shape), cuBLAS's
workspaces and the caching allocator's blocks. Warming every shape once
builds them all before the first request. The port has no persistent
compilation cache, so nothing here outlives the process.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Sequence, Tuple

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


def warm_flagship(
    config=None,
    bucket_shapes: Sequence[Tuple[int, int, int]] = ((64, 256, 256),),
    solver_shapes: Sequence[Tuple[int, int, int]] = (),
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Run the streaming flagship's fused encode once on a zero uint8
    bucket of each ``(rows, x, y)`` shape, with throwaway codebooks at the
    config's widths (a random PCA per branch, a unit GMM of vocab_size),
    and a zero-data mixture-weighted fit of each ``(n, d, num_classes)``
    shape, on ``device`` (default CUDA). Returns seconds per shape as
    ``encode_{rows}x{x}x{y}_s`` and ``solve_{n}x{d}x{c}_s``, each ending
    in a device synchronize. Nothing outlives the process: the port has
    no compilation cache."""
    from ..pipelines.imagenet import ImageNetSiftLcsFVConfig
    from ..convert import flagship_codebooks_from_numpy
    from ..pipelines.imagenet_streaming import StreamingFlagship
    from ..ops.learning.weighted import BlockWeightedLeastSquaresEstimator

    cfg = config or ImageNetSiftLcsFVConfig()
    fs = StreamingFlagship(cfg, device=device)
    device = fs.device
    rng = np.random.default_rng(0)

    def gmm():
        return (rng.normal(size=(cfg.desc_dim, cfg.vocab_size)).astype(np.float32),
                np.ones((cfg.desc_dim, cfg.vocab_size), np.float32),
                np.full((cfg.vocab_size,), 1.0 / cfg.vocab_size, np.float32))

    lcs_width = fs._lcs._neighbor_offsets().size ** 2 * 3 * 2
    fs.adopt_codebooks(flagship_codebooks_from_numpy(
        rng.normal(size=(fs._sift.descriptor_size, cfg.desc_dim)).astype(np.float32),
        rng.normal(size=(lcs_width, cfg.desc_dim)).astype(np.float32), gmm(), gmm(), device))

    def synced_seconds(fn) -> float:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    out: Dict[str, float] = {}
    for rows, x, y in bucket_shapes:
        images = torch.zeros((rows, x, y, 3), dtype=torch.uint8, device=device)
        dims = torch.tensor([[x, y]] * rows, dtype=torch.int32, device=device)
        out[f"encode_{rows}x{x}x{y}_s"] = synced_seconds(
            lambda: fs._encode_bucket(images, dims, fs.codebooks.sift_pca, fs.codebooks.lcs_pca))
        del images, dims
    for n, d, num_classes in solver_shapes:
        est = BlockWeightedLeastSquaresEstimator(cfg.solver_block_size, num_iter=1, reg=cfg.reg,
                                                 mixture_weight=cfg.mixture_weight)

        def solve():
            xs = torch.zeros((n, d), dtype=torch.float32, device=device)
            ys = torch.full((n, num_classes), -1.0, dtype=torch.float32, device=device)
            ys[torch.arange(n, device=device),
               torch.as_tensor(rng.integers(0, num_classes, n), device=device)] = 1.0
            est.fit(ArrayDataset(xs), ArrayDataset(ys))

        out[f"solve_{n}x{d}x{num_classes}_s"] = synced_seconds(solve)
    return out
