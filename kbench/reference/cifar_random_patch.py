"""Plain reference of CIFAR-10 random-patch (KeystoneML's
``RandomPatchCifar.scala``), as the configuration runs it.

Plain torch and numpy; nothing of the port.

1. Filters (host, float64): a seeded subsample of the training images
   (enough that their windows hold twice ``whitener_size`` patches),
   every ``patch_size`` window at ``patch_steps`` in x-major order, each
   laid out as index ``c + C·x + C·s·y``; a seeded sample of
   ``whitener_size`` of them (sorted); each row normalised to
   (row − mean) / sqrt(sample variance + 10); the ZCA whitener of those
   rows, W = U·diag((λ + ε)^−½)·Uᵀ from the eigenpairs of their
   covariance; ``num_filters`` rows sampled again, whitened, scaled to
   unit norm and multiplied by Wᵀ. Each draw is
   ``np.random.default_rng(seed)`` afresh, as the published pipeline
   seeds its sampler.
2. Features: every valid window of an image, normalised as above
   (variance constant 10), minus the whitener's means, dotted with each
   filter; the symmetric rectifier max(0, ±v − α); sums over
   ``pool_size``-wide pools every ``pool_stride`` pixels.
3. Solve: the features in blocks of ``block_filters`` filters (all their
   pooled positive and negative channels), each standardised by its
   columns' mean and sample standard deviation over the training images
   (a deviation under 1e-8 taken as 1); ``num_epochs`` Gauss-Seidel
   passes of block least squares with λ = ``reg`` against the centred ±1
   indicators: per block, solve (A_bᵀA_b + λI) W_b = A_bᵀ(Y − P + A_b W_b)
   and move the predictions P. Blocks of whole filters are the order the
   configuration's solver visits them (its ``solver`` is ``conv_block``);
   one pass of BCD depends on that order.
4. Scores: Σ_b standardised features of block b · W_b + mean(Y).

``precision`` as in ``common.py``: the host filter learning stays in
float64 (the port learns it on the host in float64 as well).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from kbench.reference.common import dtype_of, mm

#: Images per chunk of the feature computation (bounds the (c, rx, ry,
#: block) convolution panel: 512 · 729 · 512 float64 values, 1.5 GB).
IMAGE_CHUNK = 512


def normalize_rows(mat: np.ndarray, alpha: float) -> np.ndarray:
    mean = mat.mean(axis=1, keepdims=True)
    var = ((mat - mean) ** 2).sum(axis=1, keepdims=True) / (mat.shape[1] - 1)
    return (mat - mean) / np.sqrt(var + alpha)


def learn_filters(images: torch.Tensor, config: Dict[str, Any], seed: int):
    """(filters (F, s·s·C), whitener W (s·s·C, s·s·C), whitener means)."""
    n, x_dim, y_dim, channels = images.shape
    s, step = int(config["patch_size"]), int(config["patch_steps"])
    size = int(config["whitener_size"])
    rx, ry = (x_dim - s) // step + 1, (y_dim - s) // step + 1
    want = max(1, min(n, (2 * size) // (rx * ry) + 1))
    if want < n:
        pick = np.random.default_rng(seed).choice(n, size=want, replace=False)
        host = images[torch.as_tensor(pick, device=images.device)].cpu().numpy().astype(np.float64)
    else:
        host = images.cpu().numpy().astype(np.float64)
    # (want, rx, ry, C, s_x, s_y) → rows laid out (s_y, s_x, C).
    win = np.lib.stride_tricks.sliding_window_view(host, (s, s), axis=(1, 2))[:, ::step, ::step]
    rows = win.transpose(0, 1, 2, 5, 4, 3).reshape(-1, s * s * channels)
    pick = np.sort(np.random.default_rng(seed).choice(rows.shape[0], size=min(size, rows.shape[0]), replace=False))
    base = normalize_rows(rows[pick], 10.0)
    mu = base.mean(axis=0)
    centred = base - mu
    cov = centred.T @ centred / (base.shape[0] - 1.0)
    evals, evecs = np.linalg.eigh(cov)
    whitener = (evecs * (evals + float(config["whitening_epsilon"])) ** -0.5) @ evecs.T
    take = np.random.default_rng(seed).choice(base.shape[0], size=min(int(config["num_filters"]), base.shape[0]),
                                              replace=False)
    unnorm = (base[take] - mu) @ whitener
    norms = np.sqrt((unnorm**2).sum(axis=1, keepdims=True))
    filters = (unnorm / (norms + 1e-10)) @ whitener.T
    return filters, whitener, mu


def _pools(extent: int, size: int, stride: int) -> List[tuple]:
    """[start, stop) of each pool along an axis of ``extent`` positions."""
    window = 2 * (size // 2)
    count = max(0, -(-(extent - size // 2) // stride))
    return [(i * stride, min(i * stride + window, extent)) for i in range(count)]


def block_features(images: torch.Tensor, filt: torch.Tensor, mu_w: torch.Tensor, config: Dict[str, Any],
                   precision: str) -> torch.Tensor:
    """(N, pools · 2·fb) raw pooled features of one block of filters
    ``filt`` (fb, s·s·C): per pool cell, the positive channels then the
    negative ones."""
    dtype = filt.dtype
    s = int(config["patch_size"])
    alpha = float(config["alpha"])
    n = images.shape[0]
    out = []
    for start in range(0, n, IMAGE_CHUNK):
        x = images[start : start + IMAGE_CHUNK].to(dtype)
        c = x.shape[0]
        win = x.unfold(1, s, 1).unfold(2, s, 1)  # (c, rx, ry, C, s_x, s_y)
        rx, ry = win.shape[1], win.shape[2]
        p = win.permute(0, 1, 2, 5, 4, 3).reshape(c, rx, ry, -1)
        d = p.shape[-1]
        m = p.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(p.square().sum(dim=-1, keepdim=True) - d * m * m, 0.0) / (d - 1.0)
        pn = (p - m) / torch.sqrt(var + 10.0) - mu_w
        conv = mm(pn.reshape(-1, d), filt.T, precision).reshape(c, rx, ry, -1)
        pos = (conv - alpha).clamp_min_(0.0)
        neg = (-conv - alpha).clamp_min_(0.0)
        cells = []
        for x0, x1 in _pools(rx, int(config["pool_size"]), int(config["pool_stride"])):
            for y0, y1 in _pools(ry, int(config["pool_size"]), int(config["pool_stride"])):
                cells.append(pos[:, x0:x1, y0:y1].sum(dim=(1, 2)))
                cells.append(neg[:, x0:x1, y0:y1].sum(dim=(1, 2)))
        out.append(torch.cat(cells, dim=1))
    return torch.cat(out)


def fit_and_score(config: Dict[str, Any], inputs: Dict[str, torch.Tensor], eval_sets: Dict[str, torch.Tensor],
                  seed: int, precision: str, device) -> Dict[str, torch.Tensor]:
    dtype = dtype_of(precision)
    images = inputs["x"].to(device)
    filters, _, mu = learn_filters(images, config, seed)
    filt = torch.as_tensor(filters, dtype=dtype, device=device)
    mu_w = torch.as_tensor(mu, dtype=dtype, device=device)
    n = images.shape[0]
    k = int(config["num_classes"])
    y = torch.full((n, k), -1.0, dtype=dtype, device=device)
    y[torch.arange(n, device=device), inputs["labels"].to(device).long()] = 1.0
    mu_y = y.mean(dim=0)
    y -= mu_y
    reg = float(config["reg"])
    fb = int(config["block_filters"])
    blocks = [(s, min(s + fb, filt.shape[0])) for s in range(0, filt.shape[0], fb)]
    epochs = int(config["num_epochs"])

    stats, weights, kept = [], [], []
    p = torch.zeros_like(y)
    for epoch in range(epochs):
        for b, (f0, f1) in enumerate(blocks):
            if epoch == 0:
                raw = block_features(images, filt[f0:f1], mu_w, config, precision)
                mean = raw.mean(dim=0)
                sd = torch.sqrt(torch.clamp_min(((raw - mean) ** 2).sum(dim=0) / max(n - 1.0, 1.0), 0.0))
                inv_sd = torch.where((sd < 1e-8) | ~torch.isfinite(sd), torch.ones_like(sd), 1.0 / sd)
                a_b = (raw - mean) * inv_sd
                del raw
                stats.append((mean, inv_sd))
                weights.append(torch.zeros(a_b.shape[1], k, dtype=dtype, device=device))
                if epochs > 1:
                    kept.append(a_b)
            else:
                a_b = kept[b]
            w_b = weights[b]
            gram = mm(a_b.T, a_b, precision)
            gram.diagonal().add_(reg)
            r = y - p + mm(a_b, w_b, precision)
            w_new = torch.cholesky_solve(mm(a_b.T, r, precision), torch.linalg.cholesky(gram))
            p += mm(a_b, w_new - w_b, precision)
            weights[b] = w_new
            del a_b, gram, r
    del kept

    out = {}
    for name, rows in eval_sets.items():
        rows = rows.to(device)
        scores = mu_y.expand(rows.shape[0], k).clone()
        for (f0, f1), (mean, inv_sd), w_b in zip(blocks, stats, weights):
            feats = (block_features(rows, filt[f0:f1], mu_w, config, precision) - mean) * inv_sd
            scores += mm(feats, w_b, precision)
        out[name] = scores.to("cpu", torch.float64)
    return out
