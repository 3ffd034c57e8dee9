"""Operations one CIFAR random-patch fit needs, from the configuration's
shapes (2 FLOP per multiply-add; a Gram AᵀA counted as its symmetric
half, n·(n+1)·k for n columns over k rows, as a SYRK computes it):

- filter learning: the whitener's covariance, a Gram S·p·(p+1) for S
  sampled patches of p = s·s·C values, and the filters' two products
  4·F·p² (the eigendecomposition of a p×p matrix is not counted);
- convolution: 2·N·rx·ry·p·F for N images, rx·ry valid windows, F
  filters (normalisation, rectifier and pooling are not counted);
- solve, per block of b features (whole filters): the Gram N·b·(b+1), its
  factor b³/3, and per pass 4·N·b·k for A_bᵀR and the update of the
  predictions plus 2·b²·k for the solves.
"""

from __future__ import annotations

from typing import Any, Dict


def fit_flops(config: Dict[str, Any]) -> float:
    n = int(config["train_rows"])
    s, step = int(config["patch_size"]), int(config["patch_steps"])
    x_dim, y_dim, channels = (int(v) for v in config["image_shape"])
    f = int(config["num_filters"])
    k = int(config["num_classes"])
    p = s * s * channels
    rx, ry = (x_dim - s) // step + 1, (y_dim - s) // step + 1
    size = int(config["pool_size"])
    cells = 1
    for extent in (rx, ry):
        cells *= max(0, -(-(extent - size // 2) // int(config["pool_stride"])))
    per_filter = 2 * cells
    fb = int(config["block_filters"])
    widths = [per_filter * min(fb, f - start) for start in range(0, f, fb)]
    epochs = int(config["num_epochs"])
    learning = float(int(config["whitener_size"])) * p * (p + 1) + 4.0 * f * p * p
    conv = 2.0 * n * rx * ry * p * f
    solve = sum(float(n) * b * (b + 1) + b**3 / 3.0 + epochs * (4.0 * n * b * k + 2.0 * b * b * k) for b in widths)
    return learning + conv + solve
