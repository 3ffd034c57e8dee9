"""CIFAR-10 random-patch through the port, as the ``random_patch_fused``
variant runs it (``keystone_tpu_torch/pipelines/cifar.py``):
``learn_random_patch_filters`` (sampled 6×6×3 patches, row-normalised,
ZCA-whitened; filters sampled from them) and then
``build_random_patch(solver="conv_block", with_classifier=False)``, whose
``ConvBlockLeastSquaresEstimator`` recomputes each 512-filter block of
the convolution → rectifier → sum-pool features when its BCD update
needs it, standardises the block and solves it; ``.fit()``.

The ``random_patch`` variant (features materialised, ``StandardScaler``,
``BlockLeastSquaresEstimator``) fails inside ``Pipeline.fit()`` on the
card: the plan-time verifier's meta twin of ``FusedConvFeaturizer``
shares the operator's empty cache of packed filter blocks and fills it
with ``meta`` tensors, which the fit then multiplies. ``PERF.md`` lists
it under Open questions.

Data (made on the card from the seed): 32×32×3 images of uniform integer
pixels 0–255 held as float32 (as ``load_cifar`` decodes CIFAR-10), labels
uniform over the 10 classes; the training images, then held-out images.
Serving requests carry one held-out image each, as a host array.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _images(n: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 256, (n, 32, 32, 3), generator=g, device=device, dtype=torch.int32).to(torch.float32)


def make_data(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    n, held = int(config["train_rows"]), int(config["check"]["heldout_rows"])
    g = torch.Generator(device=device).manual_seed(seed)
    images = _images(n + held, g, device)
    labels = torch.randint(0, int(config["num_classes"]), (n,), generator=g, device=device, dtype=torch.int32)
    return {"x": images[:n], "labels": labels, "x_heldout": images[n:]}


def make_serve_data(config: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    n, pool = int(traffic["fit_rows"]), int(traffic["request_pool"])
    g = torch.Generator(device=device).manual_seed(seed)
    images = _images(n + pool, g, device)
    labels = torch.randint(0, int(config["num_classes"]), (n,), generator=g, device=device, dtype=torch.int32)
    return {"x": images[:n], "labels": labels, "pool": images[n:].cpu().numpy()}


def _config(config: Dict[str, Any], seed: int):
    from keystone_tpu_torch.pipelines.cifar import RandomCifarConfig

    return RandomCifarConfig(
        num_filters=int(config["num_filters"]),
        whitening_epsilon=float(config["whitening_epsilon"]),
        patch_size=int(config["patch_size"]),
        patch_steps=int(config["patch_steps"]),
        pool_size=int(config["pool_size"]),
        pool_stride=int(config["pool_stride"]),
        alpha=float(config["alpha"]),
        reg=float(config["reg"]),
        seed=seed,
    )


def fit(config: Dict[str, Any], data: Dict[str, Any], device: torch.device, seed: int, build_clock):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.cifar import build_random_patch, learn_random_patch_filters

    rc = _config(config, seed)
    with build_clock():
        filters, whitener = learn_random_patch_filters(
            ArrayDataset(data["x"]), rc, whitener_size=int(config["whitener_size"]), device=device
        )
    train = ArrayDataset({"image": data["x"], "label": data["labels"]})
    pipeline = build_random_patch(
        train, rc, filters, whitener, solver=config["solver"], with_classifier=False, device=device
    )
    return pipeline.fit()


def apply(fitted, x: torch.Tensor) -> torch.Tensor:
    from keystone_tpu_torch.data.dataset import ArrayDataset

    return fitted.apply_batch(ArrayDataset(x)).data[: x.shape[0]]


def fit_inputs(data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inputs the reference fits on: the same tensors the program got."""
    return {"x": data["x"], "labels": data["labels"]}


def eval_sets(config: Dict[str, Any], data: Dict[str, Any], seed: int) -> Dict[str, torch.Tensor]:
    """Images whose scores are compared: a seeded sample of the training
    images and every held-out image."""
    n = data["x"].shape[0]
    take = min(int(config["check"]["train_rows"]), n)
    g = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=g)[:take].sort().values.to(data["x"].device)
    return {"train": data["x"][idx], "heldout": data["x_heldout"]}


def serve_model(config: Dict[str, Any], data: Dict[str, Any], device: torch.device, seed: int):
    """The model the server answers with: this configuration's fit on the
    serving mix's training images."""
    import contextlib

    from keystone_tpu_torch.workflow.executor import PipelineEnv

    fitted = fit(config, data, device, seed, contextlib.nullcontext)
    PipelineEnv.reset()
    return fitted


def request_payloads(data: Dict[str, Any]) -> np.ndarray:
    """One image per request, as a client sends it: a host array."""
    return data["pool"]
