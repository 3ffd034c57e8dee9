"""TIMIT through the port: ``CosineRandomFeatures`` branches gathered and
concatenated, then ``BlockLeastSquaresEstimator``.

The fit is ``keystone_tpu_torch.pipelines.timit.build_pipeline`` without
its closing ``MaxClassifier`` (which fits nothing), so the fitted
pipeline answers with the 147 class scores that the check compares:
``build_featurizer(...).then_label_estimator(BlockLeastSquaresEstimator(
...), data, ClassLabelIndicators(147)(labels))``, then ``.fit()``.

Data (made on the card from the seed): frames of 440 standard normals,
each labelled by the argmax of a hidden linear map to the 147 classes,
as ``pipelines/timit.py::synthetic_timit`` labels its frames; training
rows, then held-out rows.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def make_data(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    n, held = int(config["train_rows"]), int(config["check"]["heldout_rows"])
    d, k = int(config["input_dim"]), int(config["num_classes"])
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n + held, d, generator=g, device=device)
    hidden = torch.randn(d, k, generator=g, device=device, dtype=torch.float64)
    labels = (x.double() @ hidden).argmax(dim=1).to(torch.int32)
    return {"x": x[:n], "labels": labels[:n], "x_heldout": x[n:]}


def fit(config: Dict[str, Any], data: Dict[str, Any], device: torch.device, seed: int, build_clock):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.timit import TimitConfig, build_featurizer

    tc = TimitConfig(
        num_cosines=int(config["num_cosines"]),
        gamma=float(config["gamma"]),
        rf_type=config["rf_type"],
        reg=float(config["reg"]),
        num_epochs=int(config["num_epochs"]),
        num_cosine_features=int(config["num_cosine_features"]),
        seed=seed,
    )
    with build_clock():
        featurizer = build_featurizer(tc, int(config["input_dim"]), device=device)
    labels = ClassLabelIndicators(int(config["num_classes"]))(ArrayDataset(data["labels"]))
    pipeline = featurizer.then_label_estimator(
        BlockLeastSquaresEstimator(
            int(config["block_size"]), num_iter=tc.num_epochs, reg=tc.reg, device=device
        ),
        ArrayDataset(data["x"]),
        labels,
    )
    return pipeline.fit()


def apply(fitted, x: torch.Tensor) -> torch.Tensor:
    from keystone_tpu_torch.data.dataset import ArrayDataset

    return fitted.apply_batch(ArrayDataset(x)).data[: x.shape[0]]


def fit_inputs(data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inputs the reference fits on: the same tensors the program got."""
    return {"x": data["x"], "labels": data["labels"]}


def eval_sets(config: Dict[str, Any], data: Dict[str, Any], seed: int) -> Dict[str, torch.Tensor]:
    """Rows whose scores are compared: a seeded sample of training rows
    and every held-out row."""
    n = data["x"].shape[0]
    take = min(int(config["check"]["train_rows"]), n)
    g = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=g)[:take].sort().values.to(data["x"].device)
    return {"train": data["x"][idx], "heldout": data["x_heldout"]}
