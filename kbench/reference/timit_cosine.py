"""Plain reference of the TIMIT pipeline: random cosine features, then
block coordinate descent least squares (KeystoneML's
``TimitPipeline.scala`` with ``BlockLeastSquaresEstimator``).

Plain torch and numpy; nothing of the port. It draws the random
features itself (per branch i, ``np.random.default_rng(seed + i)``: W
normal (or Cauchy) times γ, b uniform on [0, 2π)), centres the features
and the ±1 class indicators, takes λ at the estimator's floor when the
configuration's ``reg`` is 0 (1e-6 · n · the mean square of the centred
features), and runs ``num_epochs`` Gauss-Seidel passes over the
``block_size``-wide feature blocks in order: per block, solve
(A_bᵀA_b + λI) W_b = A_bᵀ(Y − P + A_b W_b) and move the predictions P.
Each block's Gram is formed once and reused on later passes (it does not
change). Scores are (x − μ_A)·W + μ_Y.

``precision``: ``"fp64"`` (the reference), ``"fp32"`` (float32 with IEEE
products), ``"tf32"`` (float32 with TF32 products: the control).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from kbench.reference.common import dtype_of, mm


def draw_branches(config: Dict[str, Any], seed: int, dtype, device):
    """Per branch (W (F, d) · γ, b (F,)) as the published node draws them."""
    f, d, gamma = int(config["num_cosine_features"]), int(config["input_dim"]), float(config["gamma"])
    out = []
    for i in range(int(config["num_cosines"])):
        rng = np.random.default_rng(seed + i)
        if config["rf_type"] == "gaussian":
            w = rng.normal(size=(f, d))
        else:
            w = rng.standard_cauchy(size=(f, d))
        b = rng.uniform(0.0, 2.0 * np.pi, size=f)
        out.append((torch.as_tensor(w * gamma, dtype=dtype, device=device),
                    torch.as_tensor(b, dtype=dtype, device=device)))
    return out


def featurize_into(out: torch.Tensor, x: torch.Tensor, branches, precision: str) -> torch.Tensor:
    f = branches[0][0].shape[0]
    for i, (w, b) in enumerate(branches):
        out[:, i * f : (i + 1) * f] = torch.cos(mm(x, w.T, precision) + b)
    return out


def fit_and_score(config: Dict[str, Any], inputs: Dict[str, torch.Tensor], eval_sets: Dict[str, torch.Tensor],
                  seed: int, precision: str, device) -> Dict[str, torch.Tensor]:
    dtype = dtype_of(precision)
    branches = draw_branches(config, seed, dtype, device)
    x_in = inputs["x"].to(device=device, dtype=dtype)
    n = x_in.shape[0]
    k = int(config["num_classes"])
    width = int(config["num_cosines"]) * int(config["num_cosine_features"])
    a = featurize_into(torch.empty(n, width, dtype=dtype, device=device), x_in, branches, precision)
    mu_a = a.mean(dim=0)
    a -= mu_a
    y = torch.full((n, k), -1.0, dtype=dtype, device=device)
    y[torch.arange(n, device=device), inputs["labels"].to(device).long()] = 1.0
    mu_y = y.mean(dim=0)
    y -= mu_y

    reg = float(config["reg"])
    bs = int(config["block_size"])
    if reg <= 0:
        sq = sum(float(a[:, s : s + bs].square().sum()) for s in range(0, width, bs))
        reg = max(1e-6 * n * sq / (n * width), 1e-6)
    w = block_coordinate_descent(a, y, reg, int(config["num_epochs"]), bs, precision)
    del a

    out = {}
    for name, rows in eval_sets.items():
        feats = featurize_into(
            torch.empty(rows.shape[0], width, dtype=dtype, device=device),
            rows.to(device=device, dtype=dtype), branches, precision,
        )
        out[name] = (mm(feats - mu_a, w, precision) + mu_y).to("cpu", torch.float64)
    return out


def block_coordinate_descent(a: torch.Tensor, y: torch.Tensor, reg: float, epochs: int, bs: int,
                             precision: str) -> torch.Tensor:
    """Gauss-Seidel passes over contiguous ``bs``-wide column blocks of the
    centred ``a`` (the last block may be narrower)."""
    n, width = a.shape
    w = torch.zeros(width, y.shape[1], dtype=a.dtype, device=a.device)
    p = torch.zeros_like(y)
    factors = {}
    for _ in range(epochs):
        for s in range(0, width, bs):
            a_b = a[:, s : s + bs].contiguous()
            if s not in factors:
                gram = mm(a_b.T, a_b, precision)
                gram.diagonal().add_(reg)
                factors[s] = torch.linalg.cholesky(gram)
            w_b = w[s : s + bs]
            r = y - p + mm(a_b, w_b, precision)
            w_new = torch.cholesky_solve(mm(a_b.T, r, precision), factors[s])
            p += mm(a_b, w_new - w_b, precision)
            w[s : s + bs] = w_new
    return w
