"""Operations one VOC SIFT + Fisher-vector fit needs, from the
configuration's shapes: 2 FLOP per multiply-add of the published
algorithm (VLFeat's dense SIFT, KeystoneML's PCA, mixture and Fisher
encoder, the block solver), not of the port's banded products. A Gram AᵀA
is its symmetric half, n·(n+1)·k for n columns over k rows, as a SYRK
computes it.

- SIFT, per image and scale s (bin b = bin_size + 2s, X × Y pixels): the
  separable Gaussian smoothing, 2·X·Y·T multiply-adds for T = 2⌈4b/6⌉ + 1
  taps, and the flat window's separable triangular binning of the 8
  orientation planes over the whole plane, 2·8·X·Y·(2b − 1) (gradients,
  angles, normalisation and quantisation are not counted);
- PCA: the sample's Gram S·p·(p+1) (p = 128; the eigendecomposition is
  not counted) and the projection of every descriptor, 2·N·c·p·d;
- k-means++: k D² passes over the GMM sample, 2·G·d each (the first
  the half norms);
- Lloyd, per iteration 4·G·d·k (distances and the recentring product),
  and the initial moments after it, 6·G·d·k (assignment, first and
  second moments);
- EM at a fixed ``EM_ITERATIONS``, about the median a fit runs on the
  card (20–40 over the seeds measured; ``gmm_em_iters.fit`` reads the
  actual count, so ``fit_mfu`` follows a seed's count as well as its
  speed): 4·G·d·k per iteration for the E-step's two products and 4·G·d·k per
  update (one fewer than the iterations when the tolerance stops it) for
  the M-step's;
- Fisher statistics, per image: the posteriors' two products 4·c·d·k and
  [X | X∘X]ᵀq, 4·c·d·k;
- the block solver as ``counts/timit_cosine.py`` counts it: per block of
  b features the Gram N·b·(b+1) and factor b³/3 once, and per pass
  4·N·b·L + 2·b²·L for L classes.

N training images, c descriptors an image, S and G the PCA and GMM
samples (per image samples // N, so S = N·(samples // N)), d = desc_dim,
k = vocab_size.
"""

from __future__ import annotations

import math
from typing import Any, Dict

#: EM iterations counted a fit (module docstring).
EM_ITERATIONS = 30


def descriptors_per_image(config: Dict[str, Any]) -> int:
    x_dim, y_dim = (int(v) for v in config["image_shape"][:2])
    scales, step0 = int(config["sift_scales"]), int(config["sift_step"])
    total = 0
    for s in range(scales):
        b = int(config["sift_bin_size"]) + 2 * s
        step = step0 + s * int(config["scale_step"])
        off = max(0, 1 + 2 * scales - 3 * s)
        nx = max(0, (x_dim - 1 - off - 3 * b) // step + 1)
        ny = max(0, (y_dim - 1 - off - 3 * b) // step + 1)
        total += nx * ny
    return total


def sift_flops(config: Dict[str, Any]) -> float:
    """FLOP of SIFT on one image."""
    x_dim, y_dim = (int(v) for v in config["image_shape"][:2])
    flops = 0.0
    for s in range(int(config["sift_scales"])):
        b = int(config["sift_bin_size"]) + 2 * s
        taps = 2 * max(1, math.ceil(4.0 * b / 6.0)) + 1
        flops += 2.0 * (2 * x_dim * y_dim * taps) + 2.0 * (2 * 8 * x_dim * y_dim * (2 * b - 1))
    return flops


def fit_flops(config: Dict[str, Any]) -> float:
    n = int(config["train_rows"])
    c = descriptors_per_image(config)
    p = int(config["descriptor_size"])
    d, k = int(config["desc_dim"]), int(config["vocab_size"])
    pca_rows = n * min(max(1, int(config["num_pca_samples"]) // n), c)
    g = n * min(max(1, int(config["num_gmm_samples"]) // n), c)
    gmm = config["gmm"]
    em = EM_ITERATIONS
    updates = em if em >= int(gmm["max_iterations"]) else em - 1
    sift = n * sift_flops(config)
    pca = float(pca_rows) * p * (p + 1) + 2.0 * n * c * p * d
    seeding = k * 2.0 * g * d
    mixture = int(gmm["lloyd_iterations"]) * 4.0 * g * d * k + 6.0 * g * d * k + (em + updates) * 4.0 * g * d * k
    fisher = 8.0 * n * c * d * k
    width = 2 * d * k
    bs, classes, epochs = int(config["block_size"]), int(config["num_classes"]), int(config["num_epochs"])
    blocks = [min(bs, width - s) for s in range(0, width, bs)]
    solve = sum(float(n) * b * (b + 1) + b**3 / 3.0 + epochs * (4.0 * n * b * classes + 2.0 * b * b * classes)
                for b in blocks)
    return sift + pca + seeding + mixture + fisher + solve
