"""Per-class mixture-weighted block least squares.

Port of ``keystone_tpu/ops/learning/weighted.py`` (reference:
nodes/learning/BlockWeightedLeastSquares.scala:36-372 and
nodes/learning/internal/ReWeightedLeastSquares.scala:18-142). The solver
fits, per class c, weights against a mixture of population and
class-conditional second moments controlled by ``mixture_weight`` (the
reference's ImageNet configuration uses 0.25):

    jointXTX_c = (1−w)·popCov + w·classCov_c + w(1−w)·δ_c δ_cᵀ
    jointXTR_c = (1−w)·popXTR[:,c] + w·classXTR_c − jointMean_c·meanMix_c
    ΔW_c       = (jointXTX_c + λI)⁻¹ (jointXTR_c − λ·W_old[:,c])

with δ_c = classMean_c − popMean, per-block Gauss-Seidel over feature
blocks, and intercept b_c = jlm_c − Σ_d jointMean[c,d]·W[d,c] where
jlm_c = 2w + 2(1−w)·n_c/n − 1 (BlockWeightedLeastSquares.scala:149,318).

Per block, as in the JAX package, the solve takes one of two paths:
with m the largest class, a Woodbury solve around one factored
S = (1−w)·popCov + λI when 2(m+3) < bs//3 (each class's system is S plus
a low-rank update), else a Cholesky factorization per class; the
Woodbury path then takes one residual-correction step against the
structured operator. The update differs from the JAX package's: there
the class covariance is winᵀwin/n − μμᵀ, a rank-m term less a rank-1
one (rank m+2 with δδᵀ), and the small system C⁻¹ + UᵀS⁻¹U is indefinite;
when a class's rows share a large common component its cancellation
leaves the solve far from the exact one, and one correction step does
not recover it (the streaming flagship's 1,000 classes of near-collinear
rows on an H100: 8.1e-4 from a float64 solve, ``chip_smoke.py``
``imagenet_streaming_ondevice``). Here the window rows are centred
first, so the update is U Uᵀ with U = [√(w/n)·(win − μ)ᵀ | √(w(1−w))·δ]
(rank m+1, every term positive) and I + UᵀS⁻¹U is factored by Cholesky:
the same system, solved to the dense path's accuracy (6.0e-6 there;
``tests/test_torch_imagenet.py`` holds both paths to float64 on planted
rows with a large shared component). The JAX package runs the classes
in a ``lax.scan``; here they run in groups of bounded memory
(``CLASS_GROUP_BYTES``), each group in one set of batched calls, with
no host synchronisation inside the class
loop: a class's row window is gathered from the class-sorted order on the
device, S is factored once per block on cuSOLVER, one triangular solve
pair serves every class of a group, and every product with a
contraction over the feature axis goes through the solver binding at the
mode's kind (``linalg.mm`` / ``gemm.gemm_batched``). At the flagship's
shape (bs = 4,096, 1,000 classes) a batched Cholesky of all classes
would hold 64 GB; the Woodbury group holds ~0.5 GB.

``solve_path`` ("auto", "dense", "woodbury") is the test seam for the
two paths; the fit records the path it took on its ``weighted:bcd`` span
and in ``estimator.last_solve_path``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ...data.dataset import Dataset
from ...obs import spans as _spans
from ...parallel import linalg
from ...workflow.pipeline import LabelEstimator
from ..cuda import gemm as _gemm
from .block import BlockLinearMapper, _as_array_dataset, _round_up

#: Bytes of per-class working set one class group may hold.
CLASS_GROUP_BYTES = 1 << 30



def joint_label_means(counts, n: int, mixture_weight: float) -> torch.Tensor:
    """jlm_c = 2·mw + 2(1−mw)·n_c/n − 1, with the absent-class fallback:
    an all −1 target column's least-squares-consistent constant is −1
    (2·mw−1 would let a phantom class outrank trained negatives in top-k).
    Shared by both weighted estimators
    (reference: BlockWeightedLeastSquares.scala:149,318,
    PerClassWeightedLeastSquares.scala:190-196 computeJointLabelMean)."""
    counts = torch.as_tensor(counts).to(torch.float32)
    mw = mixture_weight
    jlm = 2.0 * mw + 2.0 * (1.0 - mw) * counts / float(n) - 1.0
    return torch.where(counts > 0, jlm, torch.full_like(jlm, -1.0))


def weighted_intercept(jlm: torch.Tensor, joint_means: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """b_c = jlm_c − Σ_d jointMean[c, d]·W[d, c]
    (reference: BlockWeightedLeastSquares.scala:318,
    PerClassWeightedLeastSquares.scala:122 finalB)."""
    return jlm.to(torch.float32) - (joint_means * w.T).sum(dim=1)


def _batched_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[i] @ b[i] at the mode's kind: one batched binding call on a card,
    ``torch.matmul`` on the CPU."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    return _gemm.gemm_batched(a, b, linalg.precision())


class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    def __init__(self, block_size: int, num_iter: int, reg: float,
                 mixture_weight: float, solve_path: str = "auto"):
        self.block_size = block_size
        self.num_iter = num_iter
        self.reg = reg
        if not 0.0 <= mixture_weight <= 1.0:
            raise ValueError(f"mixture_weight must be in [0, 1], got {mixture_weight}")
        self.mixture_weight = mixture_weight
        if solve_path not in ("auto", "dense", "woodbury"):
            raise ValueError(f"solve_path must be auto, dense or woodbury; got {solve_path!r}")
        # Woodbury's C diagonal divides by mw and mw·(1−mw): at either
        # endpoint the rank-update system is singular, where the dense
        # path just loses its class/population term, so the endpoints
        # always take the dense path.
        if not 0.0 < mixture_weight < 1.0:
            if solve_path == "woodbury":
                raise ValueError(
                    "solve_path='woodbury' requires 0 < mixture_weight < 1 "
                    f"(got {mixture_weight}); use 'dense' or 'auto'"
                )
            solve_path = "dense"
        self.solve_path = solve_path
        self.last_solve_path: Optional[str] = None

    @property
    def weight(self) -> int:
        return 3 * self.num_iter + 1

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        features = _as_array_dataset(data, None)
        targets = _as_array_dataset(labels, None)
        x = features.data[: features.num_examples].to(torch.float32)
        y = targets.data[: targets.num_examples].to(device=x.device, dtype=torch.float32)
        n, d = x.shape
        num_classes = y.shape[1]

        class_idx = torch.argmax(y, dim=1)
        counts = torch.bincount(class_idx, minlength=num_classes)
        order = torch.argsort(class_idx, stable=True)
        offsets = torch.cumsum(counts, 0) - counts
        m = int(counts.max())

        bs = min(self.block_size, d)
        d_pad = _round_up(d, bs)
        if d_pad != d:
            x = torch.nn.functional.pad(x, (0, d_pad - d))
        use_woodbury = (2 * (m + 3) < bs // 3 if self.solve_path == "auto"
                        else self.solve_path == "woodbury")
        self.last_solve_path = "woodbury" if use_woodbury else "dense"
        with _spans.span("weighted:bcd", path=self.last_solve_path, classes=num_classes,
                         max_class_rows=m, block_size=bs, blocks=d_pad // bs):
            w, joint_means = _weighted_bcd(
                x, y, order, offsets, counts, self.reg, self.mixture_weight,
                d_pad // bs, bs, m, self.num_iter, use_woodbury,
            )
        jlm = joint_label_means(counts, n, self.mixture_weight)
        b = weighted_intercept(jlm, joint_means, w)
        return BlockLinearMapper(w, block_size=bs, intercept=b)


def _class_groups(num_classes: int, per_class_bytes: int) -> List[range]:
    size = max(1, min(num_classes, CLASS_GROUP_BYTES // max(per_class_bytes, 1)))
    return [range(s, min(s + size, num_classes)) for s in range(0, num_classes, size)]


def _weighted_bcd(x, y, order, offsets, counts, reg, mw, num_blocks, bs, m, num_iter,
                  use_woodbury):
    """(W (d_pad, C), joint means (C, d_pad)) of the mixture-weighted
    block coordinate descent; ``use_woodbury`` picks the per-class solve."""
    n, d_pad = x.shape
    num_classes = y.shape[1]
    device = x.device
    counts_f = counts.to(torch.float32)
    residual = y - joint_label_means(counts, n, mw)  # (n, C)
    eye = torch.eye(bs, dtype=torch.float32, device=device)
    # Row windows of each class in the class-sorted order: window slot i
    # of class c reads row order[offsets[c] + i] while i < n_c.
    slot = torch.arange(m, device=device)
    win_valid = slot[None, :] < counts[:, None]                          # (C, m)
    win_rows = order[torch.clamp(offsets[:, None] + slot[None, :], max=n - 1)]  # (C, m)
    present = (counts > 0).to(torch.float32)
    n_c_safe = torch.clamp_min(counts_f, 1.0)

    w = torch.zeros((d_pad, num_classes), dtype=torch.float32, device=device)
    joint_means_all = torch.zeros((num_classes, d_pad), dtype=torch.float32, device=device)
    per_class = (3 * bs * (m + 3) if use_woodbury else bs * (bs + 2 * m)) * 4
    groups = _class_groups(num_classes, per_class)
    for block in [b for _ in range(num_iter) for b in range(num_blocks)]:
        cols = slice(block * bs, (block + 1) * bs)
        block_x = x[:, cols]
        pop_mean = block_x.mean(dim=0)
        pop_cov = linalg.mm_t(block_x, block_x) / n - torch.outer(pop_mean, pop_mean)
        pop_xtr = linalg.mm_t(block_x, residual) / n  # (bs, C)
        res_mean = residual.mean(dim=0)                 # (C,)
        factor_s = (torch.linalg.cholesky((1 - mw) * pop_cov + reg * eye)
                    if use_woodbury else None)
        dws = torch.empty((num_classes, bs), dtype=torch.float32, device=device)
        for group in groups:
            c = torch.arange(group.start, group.stop, device=device)
            valid = win_valid[c].to(torch.float32)                      # (G, m)
            win = block_x[win_rows[c]] * valid[..., None]               # (G, m, bs)
            r_c = residual[win_rows[c], c[:, None]] * valid             # (G, m)
            nc = n_c_safe[c]
            class_mean = win.sum(dim=1) / nc[:, None]
            class_xtr = (win * r_c[..., None]).sum(dim=1) / nc[:, None]
            delta = class_mean - pop_mean
            joint_mean = mw * class_mean + (1 - mw) * pop_mean
            mean_mix = (1 - mw) * res_mean[c] + mw * r_c.sum(dim=1) / nc
            joint_xtr = ((1 - mw) * pop_xtr[:, c].T + mw * class_xtr
                         - joint_mean * mean_mix[:, None])
            rhs = joint_xtr - reg * w[cols, c].T                        # (G, bs)
            if use_woodbury:
                dw = _woodbury_group(win, valid, nc, class_mean, delta, rhs, pop_cov, factor_s,
                                     reg, mw)
            else:
                dw = _dense_group(win, nc, class_mean, delta, rhs, pop_cov, reg, mw, eye)
            dws[c] = dw * present[c][:, None]
            joint_means_all[c, cols] = joint_mean
            del win, r_c
        w[cols] += dws.T
        residual = residual - linalg.mm(block_x, dws.T)
    return w, joint_means_all


def _dense_group(win, nc, class_mean, delta, rhs, pop_cov, reg, mw, eye):
    """ΔW of one class group by a Cholesky factorization per class."""
    class_cov = (_batched_mm(win.transpose(1, 2), win) / nc[:, None, None]
                 - class_mean[:, :, None] * class_mean[:, None, :])
    joint_xtx = ((1 - mw) * pop_cov + mw * class_cov
                 + (mw * (1 - mw)) * delta[:, :, None] * delta[:, None, :])
    del class_cov
    joint_xtx += reg * eye
    factor = torch.linalg.cholesky(joint_xtx)
    del joint_xtx
    return torch.cholesky_solve(rhs[:, :, None], factor)[:, :, 0]


def _woodbury_group(win, valid, nc, class_mean, delta, rhs, pop_cov, factor_s, reg, mw):
    """ΔW of one class group by Woodbury around S = (1−mw)·popCov + λI:
    jointXTX_c = S + U_c U_cᵀ with U_c = [√(mw/n_c)·(win − μ_c)ᵀ |
    √(mw(1−mw))·δ_c] (the class covariance from centred window rows, so
    every term of the update is positive and the small system I + UᵀS⁻¹U
    is symmetric positive definite), then one residual-correction step
    against the structured operator (never materializing jointXTX)."""
    g, bs = rhs.shape
    centred = (win - class_mean[:, None, :]) * valid[..., None]
    u = torch.cat([
        centred.transpose(1, 2) * torch.sqrt(mw / nc)[:, None, None],
        delta[:, :, None] * (mw * (1 - mw)) ** 0.5,
    ], dim=2)                                                           # (G, bs, m+1)
    del centred
    k = u.shape[2]

    def s_solve(cols_by_class: torch.Tensor) -> torch.Tensor:
        """S⁻¹ applied to every (G, bs, j) column set: one solve pair."""
        j = cols_by_class.shape[2]
        flat = cols_by_class.permute(1, 0, 2).reshape(bs, g * j)
        return torch.cholesky_solve(flat, factor_s).reshape(bs, g, j).permute(1, 0, 2)

    z = s_solve(torch.cat([u, rhs[:, :, None]], dim=2))                 # (G, bs, k+1)
    zu, zr = z[:, :, :k], z[:, :, k]
    eye = torch.eye(k, dtype=torch.float32, device=rhs.device)
    small = torch.linalg.cholesky(eye + _batched_mm(u.transpose(1, 2), zu))

    def ut(v: torch.Tensor) -> torch.Tensor:  # (G, bs) → Uᵀv (G, k)
        return _batched_mm(u.transpose(1, 2), v[:, :, None])[:, :, 0]

    def wood_apply(sr: torch.Tensor, su_t_r: torch.Tensor) -> torch.Tensor:
        # (S + UUᵀ)⁻¹ r given sr = S⁻¹r and Uᵀ·S⁻¹r.
        t = torch.cholesky_solve(su_t_r[:, :, None], small)
        return sr - _batched_mm(zu, t)[:, :, 0]

    dw = wood_apply(zr, ut(zr))
    s_dw = (1 - mw) * linalg.mm(pop_cov, dw.T).T + reg * dw
    resid = rhs - s_dw - _batched_mm(u, ut(dw)[:, :, None])[:, :, 0]
    s_res = s_solve(resid[:, :, None])[:, :, 0]
    return dw + wood_apply(s_res, ut(s_res))


# --------------------------------------------- per-class re-weighted variant


class PerClassWeightedLeastSquaresEstimator(LabelEstimator):
    """Per-class example-weighted least squares.

    Port of the JAX package's estimator (reference:
    nodes/learning/PerClassWeightedLeastSquares.scala:31-223 +
    internal/ReWeightedLeastSquares.scala:18-142). Where
    :class:`BlockWeightedLeastSquaresEstimator` mixes per-class second
    moments, this variant solves one weighted problem per class c with
    scalar example weights

        b_i(c) = (1−mw)/n + 1[class_i = c]·mw/n_c

    features centred by the class's joint mean jfm_c = mw·classMean_c +
    (1−mw)·popMean, labels centred by jlm_c, via weighted BCD

        W_b = (X̃_bᵀ diag(b) X̃_b + λI) \\ X̃_bᵀ(b ∘ ỹ − r + b ∘ X̃_b W_b)

    The classes, passes and blocks run as host loops (the JAX package's
    ``lax.scan`` nest), every product through the binding at the mode's
    kind and each block system by Cholesky.
    """

    def __init__(self, block_size: int, num_iter: int, reg: float,
                 mixture_weight: float):
        self.block_size = block_size
        self.num_iter = num_iter
        self.reg = reg
        if not 0.0 <= mixture_weight <= 1.0:
            raise ValueError(f"mixture_weight must be in [0, 1], got {mixture_weight}")
        self.mixture_weight = mixture_weight

    @property
    def weight(self) -> int:
        return 3 * self.num_iter + 1

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        features = _as_array_dataset(data, None)
        targets = _as_array_dataset(labels, None)
        x = features.data[: features.num_examples].to(torch.float32)
        y = targets.data[: targets.num_examples].to(device=x.device, dtype=torch.float32)
        n, d = x.shape
        num_classes = y.shape[1]
        class_idx = torch.argmax(y, dim=1)
        counts = torch.bincount(class_idx, minlength=num_classes).to(torch.float32)
        onehot = torch.nn.functional.one_hot(class_idx, num_classes).to(torch.float32)
        bs = min(self.block_size, d)
        d_pad = _round_up(d, bs)
        if d_pad != d:
            x = torch.nn.functional.pad(x, (0, d_pad - d))
        w, jfm, jlm = _pcwls_fit(x, y, onehot, counts, self.reg, self.mixture_weight,
                                 d_pad // bs, bs, self.num_iter)
        return BlockLinearMapper(w, block_size=bs, intercept=weighted_intercept(jlm, jfm, w))


def _pcwls_fit(x, y, onehot, counts, reg, mw, num_blocks, bs, num_iter):
    n, d_pad = x.shape
    num_classes = y.shape[1]
    counts_safe = torch.clamp_min(counts, 1.0)
    present = (counts > 0).to(torch.float32)
    pop_mean = x.mean(dim=0)                                         # (d,)
    class_mean = linalg.mm_t(onehot, x) / counts_safe[:, None]       # (C, d)
    jfm = mw * class_mean + (1.0 - mw) * pop_mean[None, :]           # (C, d)
    jlm = joint_label_means(counts, n, mw)                           # (C,)
    eye = torch.eye(bs, dtype=torch.float32, device=x.device)
    w_cols = torch.zeros((d_pad, num_classes), dtype=torch.float32, device=x.device)
    blocks = [b for _ in range(num_iter) for b in range(num_blocks)]
    for c in range(num_classes):
        xc = x - jfm[c]
        yc = y[:, c] - jlm[c]
        b_wt = (1.0 - mw) / n + onehot[:, c] * (mw / counts_safe[c])  # (n,)
        by = b_wt * yc
        w_col = torch.zeros((d_pad, 1), dtype=torch.float32, device=x.device)
        resid = torch.zeros((n,), dtype=torch.float32, device=x.device)  # b ∘ (X̃·w)
        for block in blocks:
            cols = slice(block * bs, (block + 1) * bs)
            xb = xc[:, cols]
            w_b = w_col[cols]
            g = linalg.mm_t(xb, b_wt[:, None] * xb)
            pred_old = b_wt * linalg.mm(xb, w_b)[:, 0]
            rhs = linalg.mm_t(xb, (by - (resid - pred_old))[:, None])
            w_b_new = torch.cholesky_solve(rhs, torch.linalg.cholesky(g + reg * eye))
            resid = resid + b_wt * linalg.mm(xb, w_b_new - w_b)[:, 0]
            w_col[cols] = w_b_new
        w_cols[:, c] = w_col[:, 0] * present[c]
    return w_cols, jfm, jlm


__all__ = [
    "BlockWeightedLeastSquaresEstimator",
    "PerClassWeightedLeastSquaresEstimator",
    "joint_label_means",
    "weighted_intercept",
]
