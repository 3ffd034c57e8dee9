"""VOC 2007 SIFT + Fisher vectors through the port: the published
pipeline as ``keystone_tpu_torch.pipelines.voc.build_pipeline`` builds it
(PixelScaler → GrayScaler → dense SIFT; ColumnSampler → column PCA;
ColumnSampler → GMM Fisher vector; FloatToDouble → MatrixVectorizer →
NormalizeRows → SignedHellinger → NormalizeRows; one pass of block least
squares at λ 0.5), then ``.fit()``. The PCA and the mixture are learned
inside ``Pipeline.fit()``, so the fit has no build step of its own.

Each fit records what its mixture fit chose (the fitted model's
``fit_info``: the k-means++ seed rows of the GMM sample and the Lloyd and
EM iterations run) into ``data["anchors"]["program"]``; the plain
reference checks those seed rows and EM's stop against its own (its
docstring says why it needs them). A port whose mixture records no such
thing cannot be checked, and its first fit raises.

Data (made on the card from the seed): 256×256×3 images, each the sum of
its 1–3 classes' oriented gratings (20 classes: 10 angles 18° apart ×
periods 14 and 30 pixels; amplitude 60 shared out among its classes,
random phases) on a grey of 128, plus N(0, 12²) noise per channel,
clipped to 0–255 and truncated to whole pixel values; the ±1 indicators
of each image's classes. Training images, then held-out images.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

#: Images generated per step (bounds the float64 gratings panel).
IMAGE_CHUNK = 256


def _gratings(config: Dict[str, Any], device) -> torch.Tensor:
    """(2·classes, H·W) float64: each class's cos and sin grating."""
    h, w = (int(v) for v in config["image_shape"][:2])
    syn = config["synthetic"]
    rows = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    out = []
    angles = int(syn["angles"])
    for c in range(int(config["num_classes"])):
        angle, period = math.pi * (c % angles) / angles, float(syn["periods"][c // angles])
        arg = (2.0 * math.pi / period) * (cols * math.cos(angle) + rows * math.sin(angle))
        out.append(torch.stack([torch.cos(arg), torch.sin(arg)]).reshape(2, -1))
    return torch.cat(out)


def _images_and_labels(n: int, config: Dict[str, Any], g: torch.Generator, device):
    h, w, channels = (int(v) for v in config["image_shape"])
    k = int(config["num_classes"])
    syn = config["synthetic"]
    shares = torch.tensor(syn["label_shares"], dtype=torch.float64, device=device)
    counts = torch.multinomial(shares, n, replacement=True, generator=g) + 1
    keys = torch.rand(n, k, generator=g, device=device, dtype=torch.float64)
    rank = torch.argsort(torch.argsort(keys, dim=1), dim=1)
    member = rank < counts[:, None]
    phases = 2.0 * math.pi * torch.rand(n, k, generator=g, device=device, dtype=torch.float64)
    amp = member.to(torch.float64) * (float(syn["amplitude"]) / counts.to(torch.float64))[:, None]
    coef = torch.stack([amp * torch.cos(phases), -amp * torch.sin(phases)], dim=2).reshape(n, 2 * k)
    basis = _gratings(config, device)
    images = torch.empty(n, h, w, channels, dtype=torch.float32, device=device)
    for start in range(0, n, IMAGE_CHUNK):
        stop = min(start + IMAGE_CHUNK, n)
        grey = (float(syn["grey"]) + coef[start:stop] @ basis).reshape(stop - start, h, w, 1)
        noise = float(syn["noise_sd"]) * torch.randn(stop - start, h, w, channels, generator=g, device=device,
                                                    dtype=torch.float64)
        images[start:stop] = torch.floor(torch.clamp(grey + noise, 0.0, 255.0)).to(torch.float32)
    labels = torch.where(member, 1.0, -1.0).to(torch.float32)
    return images, labels


def make_data(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    n, held = int(config["train_rows"]), int(config["check"]["heldout_rows"])
    g = torch.Generator(device=device).manual_seed(seed)
    images, labels = _images_and_labels(n + held, config, g, device)
    return {"x": images[:n], "labels": labels[:n], "x_heldout": images[n:], "anchors": {}}


def _config(config: Dict[str, Any], seed: int):
    from keystone_tpu_torch.pipelines.voc import SIFTFisherConfig

    return SIFTFisherConfig(
        reg=float(config["reg"]),
        desc_dim=int(config["desc_dim"]),
        vocab_size=int(config["vocab_size"]),
        scale_step=int(config["scale_step"]),
        num_pca_samples=int(config["num_pca_samples"]),
        num_gmm_samples=int(config["num_gmm_samples"]),
        image_size=tuple(int(v) for v in config["image_shape"][:2]),
        solver_block_size=int(config["block_size"]),
        seed=seed,
    )


def mixture_fit_info(fitted) -> Optional[Dict[str, Any]]:
    """The fitted pipeline's mixture ``fit_info`` (seed rows, Lloyd and EM
    iterations), or None."""
    for op in fitted.graph.operators.values():
        info = getattr(getattr(op, "gmm", None), "fit_info", None)
        if info is not None:
            return info
    return None


def fit(config: Dict[str, Any], data: Dict[str, Any], device: torch.device, seed: int, build_clock):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.voc import build_pipeline

    pipeline = build_pipeline(_config(config, seed), ArrayDataset(data["x"]), ArrayDataset(data["labels"]),
                              device=device)
    fitted = pipeline.fit()
    info = mixture_fit_info(fitted)
    if info is None:
        raise RuntimeError("this port's mixture fit records no k-means++ seed rows (fit_info), "
                           "which the check of voc_sift_fisher needs")
    data["anchors"]["program"] = info
    return fitted


def apply(fitted, x: torch.Tensor) -> torch.Tensor:
    from keystone_tpu_torch.data.dataset import ArrayDataset

    return fitted.apply_batch(ArrayDataset(x)).data[: x.shape[0]]


def fit_inputs(data: Dict[str, Any]) -> Dict[str, Any]:
    """The inputs the reference fits on: the same tensors the program got,
    and the holder of the seed rows it checks (``anchors``)."""
    return {"x": data["x"], "labels": data["labels"], "anchors": data["anchors"]}


def eval_sets(config: Dict[str, Any], data: Dict[str, Any], seed: int) -> Dict[str, torch.Tensor]:
    """Images whose scores are compared: a seeded sample of the training
    images and every held-out image."""
    n = data["x"].shape[0]
    take = min(int(config["check"]["train_rows"]), n)
    g = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=g)[:take].sort().values.to(data["x"].device)
    return {"train": data["x"][idx], "heldout": data["x_heldout"]}
