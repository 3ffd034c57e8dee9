"""Operations one TIMIT fit needs, from the configuration's shapes.

Counted as 2 FLOP per multiply-add of the products the published
algorithm needs (KeystoneML's block solver forms each block's Gram once
and reuses it on later passes, as the reference does), a Gram AᵀA as its
symmetric half, n·b·(b+1) for b columns over n rows, as a SYRK computes
it:

- features: 2·n·d·D (the (n, d)·(d, D) product; the cosine and the bias
  are not counted);
- Grams: n·b·(b+1) per block, once;
- per pass and block: 2·n·b·k for A_bᵀR and 2·n·b·k for the update of
  the predictions;
- factors: b³/3 per block, once; solves: 2·b²·k per pass and block.

n training rows, d inputs, D = branches · F features, b the block, k
classes. Centring, indicators and the scores after the fit are not part
of a fit.
"""

from __future__ import annotations

from typing import Any, Dict


def fit_flops(config: Dict[str, Any]) -> float:
    n = int(config["train_rows"])
    d = int(config["input_dim"])
    width = int(config["num_cosines"]) * int(config["num_cosine_features"])
    b = int(config["block_size"])
    k = int(config["num_classes"])
    epochs = int(config["num_epochs"])
    blocks = [min(b, width - s) for s in range(0, width, b)]
    features = 2.0 * n * d * width
    grams = sum(float(n) * w * (w + 1) for w in blocks)
    passes = epochs * sum(4.0 * n * w * k + 2.0 * w * w * k for w in blocks)
    factors = sum(w**3 / 3.0 for w in blocks)
    return features + grams + passes + factors
