"""Plain reference of the VOC 2007 SIFT + Fisher-vector pipeline
(KeystoneML's ``VOCSIFTFisher.scala`` with the flags of
``examples/images/voc_sift_fisher.sh``), as the configuration runs it.

Plain torch and numpy; nothing of the port. Every image is taken in
chunks of ``IMAGE_CHUNK``, so the reference fits on the card beside
nothing but its own 8-bit descriptors (one byte a value: SIFT's are
whole numbers 0–255).

1. Grey levels: pixels / 255, then 0.2989·B + 0.5870·G + 0.1140·R of
   channels stored (B, G, R) (KeystoneML's ``GrayScaler``).
2. Dense SIFT, VLFeat's ``vl_dsift`` with a flat window as KeystoneML's
   ``VLFeat.cxx`` calls it, per scale s of ``sift_scales``: bin size
   b = ``sift_bin_size`` + 2s; the image smoothed by a Gaussian of σ = b/6
   over taps ±⌈4σ⌉ (normalised) with the border replicated; gradients by
   central differences, one-sided on the first and last row and column;
   each gradient's magnitude split between the two nearest of 8
   orientation bins by its angle; each orientation plane weighed by the
   triangle 1 − |u|/b around every bin centre (a zero border), the 4 × 4
   centres of a descriptor b apart, descriptors every ``sift_step`` +
   s·``scale_step`` pixels from offset max(0, 1 + 2·scales − 3s); the
   128 values (orientation fastest, then x-bin, then y-bin) normalised,
   clamped at 0.2 and normalised again, zeroed where the first norm is at
   most 0.005, and quantised to min(⌊512·v⌋, 255). Descriptors are listed
   scale by scale, each scale's grid x-major.
3. ``ColumnSampler``: per image, the positions of the ``take`` smallest of
   one row of ``np.random.default_rng(seed).random((images, descriptors))``
   (ties to the lower position), ``take`` = samples // images. The PCA
   sample and the GMM sample are both seeded with the run's seed, so they
   hold the same positions.
4. PCA: the eigenvectors of the centred covariance of the sampled
   descriptors, largest first, ``desc_dim`` of them, each signed so its
   largest-magnitude entry is positive; a descriptor's projection is
   descriptor · components (no centring, as KeystoneML's
   ``BatchPCATransformer``).
5. The mixture (KeystoneML's ``GaussianMixtureModelEstimator``): k-means++
   seeding of the projected GMM sample (``np.random.default_rng(gmm.seed)``:
   the first row uniform, each next one a D² draw, D² = ½‖x‖² − x·c + ½‖c‖²
   kept as the least over the centres so far), ``gmm.lloyd_iterations``
   Lloyd iterations, the initial moments of the nearest-centre groups, the
   variance floor max(``small_variance_threshold`` · the sample's variance,
   ``absolute_variance_threshold``); EM while the mean log-likelihood
   improves by ``stop_tolerance`` · its magnitude (always on the first
   iteration) and every component keeps ``min_cluster_size`` of posterior
   mass, at most ``max_iterations``; posteriors at or below
   ``weight_threshold`` set to 0 and the rest renormalised.
6. Fisher vectors (enceval's ``calcAndGetFVs`` as KeystoneML calls it): per
   image, s0 = mean q, s1 = Xᵀq / n, s2 = (X∘X)ᵀq / n, fv1 = (s1 − μ·s0) /
   (σ·√w), fv2 = (s2 − 2μ∘s1 + (μ∘μ − σ²)·s0) / (σ²·√(2w)), laid out
   (desc_dim, [fv1 | fv2]) and read row by row.
7. Rows scaled to unit norm, x ↦ sign(x)·√|x|, unit norm again.
8. One Gauss-Seidel pass of block least squares over ``block_size``-wide
   column blocks in order, λ = ``reg``, on the centred features and the
   centred ±1 indicators (``timit_cosine.block_coordinate_descent``);
   scores (f − μ_f)·W + μ_Y.

Departures from the published algorithm:

- exact ``atan2`` and square roots where VLFeat takes fast approximations
  (the port's and the JAX package's choice);
- every image is 256×256 (the configuration's resize), not its own size;
- two choices of the mixture fit follow a given fit where this reference
  meets them within rounding. Each is discontinuous in the sample, and the
  program holds the sample in float32, so rounding alone can tip them and
  lead EM to another mixture. The given fit is the program's
  (``inputs["anchors"]["program"]``: its ``seed_rows`` and
  ``em_updates``), or, for a precision below float64 with no program
  given, the float64 reference's on the same inputs
  (``anchors["fp64"]``), so that the control differs from the reference
  by its precision, not by another mixture. Every number this reference
  computes is its own: it takes a given row or a given stop, never a
  given value.

  * k-means++: each D² draw takes the given row if it is the row this
    reference draws with the same uniform number, or if the number falls
    within ``SEED_CDF_SLACK`` of that row's share of the cumulative D²
    weights (one row's share is about 10⁻⁶ of the total at 10⁶ rows). The
    first row that is neither, and every later one, are this reference's
    own, so a program that seeds wrongly reads far from the reference.
  * EM's stop: where the relative gain of an iteration lies within
    ``EM_STOP_SLACK`` · ``stop_tolerance`` of the tolerance, the iteration
    goes on or stops as the given fit's did (the given fit updated its
    parameters at its first ``em_updates`` iterations). The gains of the
    program and of this reference differ by about 1% at VOC's sizes, and
    gains pass the tolerance slowly (one seed read 1.00005e-4 against
    1e-4), so without it the counts part on about one seed in four.

  EM starts from this reference's own Lloyd centres and nearest-centre
  moments. The iteration counts and what was followed
  (``seed_rows_followed``, ``seed_worst_miss``, ``seed_diverged_at``,
  ``em_near_ties``), and how far the given fit's start lies from this
  reference's (``init_gaps``, relative Frobenius norms of the means,
  variances and weights; read only, where the given fit records its
  start) are printed beside the program's (one line on standard output)
  and kept as ``anchors["report_<precision>"]``.

``precision`` as in ``common.py``: ``"fp64"`` (the reference),
``"fp32"``, or ``"tf32"`` (float32 with both operands of every product,
the convolutions' included, rounded to TF32). PyTorch's process-wide TF32
switches are held off while it runs.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import torch

from kbench.reference.common import dtype_of, mm, round_tf32
from kbench.reference.timit_cosine import block_coordinate_descent

#: Images per chunk of SIFT and of the Fisher encoding.
IMAGE_CHUNK = 32
NUM_ORIENTATIONS = 8
NUM_BINS = 4
MAGNIF = 6.0
CONTRAST_THRESHOLD = 0.005
TWO_PI = 2.0 * np.pi
#: Widest miss, as a share of the cumulative D² weights, at which a D²
#: draw takes the given row (module docstring). The program's misses read
#: up to 1.6e-7 at the cell's size.
SEED_CDF_SLACK = 1e-6
#: Share of the stop tolerance within which EM's stop follows the given
#: fit's (module docstring).
EM_STOP_SLACK = 0.05


@contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- SIFT


def _taps_along(x: torch.Tensor, dim: int, kernel: np.ndarray, starts: torch.Tensor, precision: str) -> torch.Tensor:
    """Σ_t kernel[t] · x[..., starts + t, ...] along ``dim`` (indices past
    either end read 0): a correlation sampled at ``starts``."""
    if precision == "tf32":
        x = round_tf32(x)
    size = x.shape[dim]
    out = None
    for t, w in enumerate(kernel):
        w = float(round_tf32(torch.tensor([w], dtype=torch.float32))[0]) if precision == "tf32" else float(w)
        idx = starts + t
        ok = (idx >= 0) & (idx < size)
        taken = x.index_select(dim, idx.clamp(0, size - 1))
        shape = [1] * x.ndim
        shape[dim] = len(idx)
        term = taken * (ok.to(x.dtype) * w).reshape(shape)
        out = term if out is None else out + term
    return out


def _smooth(g: torch.Tensor, sigma: float, precision: str) -> torch.Tensor:
    """Gaussian smoothing of (N, X, Y) over a replicated border."""
    radius = max(1, int(np.ceil(4.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-0.5 * (xs / sigma) ** 2)
    kernel /= kernel.sum()
    for dim in (1, 2):
        size = g.shape[dim]
        idx = torch.arange(-radius, size + radius, device=g.device).clamp(0, size - 1)
        padded = g.index_select(dim, idx)
        g = _taps_along(padded, dim, kernel, torch.arange(size, device=g.device), precision)
    return g


def _gradients(g: torch.Tensor):
    gx = torch.empty_like(g)
    gx[:, 1:-1] = 0.5 * (g[:, 2:] - g[:, :-2])
    gx[:, 0] = g[:, 1] - g[:, 0]
    gx[:, -1] = g[:, -1] - g[:, -2]
    gy = torch.empty_like(g)
    gy[:, :, 1:-1] = 0.5 * (g[:, :, 2:] - g[:, :, :-2])
    gy[:, :, 0] = g[:, :, 1] - g[:, :, 0]
    gy[:, :, -1] = g[:, :, -1] - g[:, :, -2]
    return gx, gy


def _geometry(config: Dict[str, Any], s: int, x_dim: int, y_dim: int):
    b = int(config["sift_bin_size"]) + 2 * s
    step = int(config["sift_step"]) + s * int(config["scale_step"])
    off = max(0, 1 + 2 * int(config["sift_scales"]) - 3 * s)
    span = (NUM_BINS - 1) * b
    nx = max(0, (x_dim - 1 - off - span) // step + 1)
    ny = max(0, (y_dim - 1 - off - span) // step + 1)
    return b, step, off, nx, ny


def descriptors_per_image(config: Dict[str, Any]) -> int:
    x_dim, y_dim = (int(v) for v in config["image_shape"][:2])
    return sum(nx * ny for _, _, _, nx, ny in
               (_geometry(config, s, x_dim, y_dim) for s in range(int(config["sift_scales"]))))


def sift(images: torch.Tensor, config: Dict[str, Any], precision: str) -> torch.Tensor:
    """(N, X, Y, 3) pixels → (N, descriptors, 128) quantised descriptors,
    uint8."""
    dtype = dtype_of(precision)
    x = images.to(dtype) / 255.0
    g = 0.2989 * x[..., 2] + 0.5870 * x[..., 1] + 0.1140 * x[..., 0]
    n, x_dim, y_dim = g.shape
    dev = g.device
    out = []
    for s in range(int(config["sift_scales"])):
        b, step, off, nx, ny = _geometry(config, s, x_dim, y_dim)
        if not nx * ny:
            continue
        gx, gy = _gradients(_smooth(g, b / MAGNIF, precision))
        mag = torch.sqrt(gx * gx + gy * gy)
        angle = torch.remainder(torch.atan2(gy, gx), TWO_PI) * (NUM_ORIENTATIONS / TWO_PI)
        lower = torch.floor(angle)
        frac = angle - lower
        lower = lower.long() % NUM_ORIENTATIONS
        planes = torch.zeros(n, NUM_ORIENTATIONS, x_dim, y_dim, dtype=dtype, device=dev)
        planes.scatter_add_(1, lower[:, None], ((1.0 - frac) * mag)[:, None])
        planes.scatter_add_(1, ((lower + 1) % NUM_ORIENTATIONS)[:, None], (frac * mag)[:, None])
        del gx, gy, mag, angle, lower, frac
        # Bin centres of every descriptor: (nx, 4) rows, (ny, 4) columns.
        cx = torch.as_tensor(off + np.arange(nx) * step, device=dev)[:, None] + torch.arange(NUM_BINS, device=dev) * b
        cy = torch.as_tensor(off + np.arange(ny) * step, device=dev)[:, None] + torch.arange(NUM_BINS, device=dev) * b
        tri = np.maximum(0.0, 1.0 - np.abs(np.arange(-(b - 1), b, dtype=np.float64)) / b)
        binned = _taps_along(planes, 2, tri, cx.reshape(-1) - (b - 1), precision)
        binned = _taps_along(binned, 3, tri, cy.reshape(-1) - (b - 1), precision)
        # (N, 8, nx·4, ny·4) → (N, nx, ny, ybin, xbin, orientation)
        raw = binned.reshape(n, NUM_ORIENTATIONS, nx, NUM_BINS, ny, NUM_BINS).permute(0, 2, 4, 5, 3, 1)
        raw = raw.reshape(n, nx * ny, NUM_ORIENTATIONS * NUM_BINS * NUM_BINS)
        del planes, binned
        norm1 = torch.sqrt((raw * raw).sum(dim=-1, keepdim=True))
        d = torch.clamp(raw / torch.clamp(norm1, min=1e-10), max=0.2)
        d = d / torch.clamp(torch.sqrt((d * d).sum(dim=-1, keepdim=True)), min=1e-10)
        d = torch.where(norm1 > CONTRAST_THRESHOLD, d, torch.zeros_like(d))
        out.append(torch.clamp(torch.floor(512.0 * d), max=255.0).to(torch.uint8))
    return torch.cat(out, dim=1)


def all_descriptors(images: torch.Tensor, config: Dict[str, Any], precision: str) -> torch.Tensor:
    n = images.shape[0]
    out = torch.empty(n, descriptors_per_image(config), 128, dtype=torch.uint8, device=images.device)
    for start in range(0, n, IMAGE_CHUNK):
        out[start : start + IMAGE_CHUNK] = sift(images[start : start + IMAGE_CHUNK], config, precision)
    return out


# ------------------------------------------------------------- sampling


def sample_positions(n: int, c: int, take: int, seed: int, device) -> torch.Tensor:
    """(n, take) positions: per image the ``take`` smallest of its row of
    ``default_rng(seed).random((n, c))``, ties to the lower position."""
    rng = np.random.default_rng(seed)
    out = torch.empty(n, take, dtype=torch.long, device=device)
    for start in range(0, n, 256):
        stop = min(start + 256, n)
        keys = torch.from_numpy(rng.random((stop - start, c))).to(device)
        out[start:stop] = torch.sort(keys, dim=1, stable=True).indices[:, :take]
    return out


def gather_rows(desc: torch.Tensor, positions: torch.Tensor, dtype) -> torch.Tensor:
    rows = torch.arange(desc.shape[0], device=desc.device)[:, None]
    return desc[rows, positions].reshape(-1, desc.shape[-1]).to(dtype)


# ------------------------------------------------------------------ PCA


def pca_components(x: torch.Tensor, dims: int, precision: str) -> torch.Tensor:
    centred = x - x.mean(dim=0)
    cov = mm(centred.T, centred, precision)
    _, vecs = torch.linalg.eigh(cov)
    comps = torch.flip(vecs, dims=[1])[:, :dims]
    pick = torch.argmax(comps.abs(), dim=0)
    signs = torch.sign(comps[pick, torch.arange(dims, device=comps.device)])
    return comps * torch.where(signs == 0, torch.ones_like(signs), signs)


# -------------------------------------------------------------- mixture


def _half_sq(x: torch.Tensor, centres: torch.Tensor, precision: str) -> torch.Tensor:
    return 0.5 * (x * x).sum(dim=1, keepdim=True) - mm(x, centres.T, precision) + 0.5 * (centres * centres).sum(dim=1)


def kmeanspp_rows(x: torch.Tensor, k: int, seed: int, precision: str, anchor: Optional[np.ndarray],
                  report: Dict[str, Any]) -> np.ndarray:
    """k-means++ seed rows of ``x``, following ``anchor``'s rows by the
    rule of the module docstring."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    half = 0.5 * (x * x).sum(dim=1)
    rows = np.zeros(k, dtype=np.int64)
    followed, worst = 0, 0.0

    def pick(j: int, own: int, cdf: Optional[np.ndarray] = None, u: float = 0.0) -> int:
        nonlocal anchor, followed, worst
        if anchor is None:
            return own
        want = int(anchor[j])
        if want == own:
            followed += 1
            return own
        if cdf is not None and 0 <= want < n:
            lo = float(cdf[want - 1]) if want > 0 else 0.0
            miss = max(0.0, lo - u, u - float(cdf[want]))
            if miss <= SEED_CDF_SLACK:
                followed += 1
                worst = max(worst, miss)
                return want
        report["seed_diverged_at"] = j
        anchor = None
        return own

    rows[0] = pick(0, int(rng.integers(n)))
    cur = None
    for j in range(k - 1):
        c = x[rows[j]]
        sq = half - mm(x, c[:, None], precision)[:, 0] + 0.5 * (c * c).sum()
        cur = sq if cur is None else torch.minimum(cur, sq)
        probs = torch.clamp(cur, min=0.0).to("cpu", torch.float64).numpy()
        if probs.sum() <= 0:
            rows[j + 1] = pick(j + 1, int(rng.integers(n)))
            continue
        cdf = np.cumsum(probs)
        cdf /= cdf[-1]
        u = float(rng.random())
        rows[j + 1] = pick(j + 1, int(np.searchsorted(cdf, u, side="right")), cdf, u)
    report.update(seed_rows_followed=followed, seed_worst_miss=worst)
    return rows


def lloyd(x: torch.Tensor, means: torch.Tensor, iterations: int, tol: float, precision: str):
    prev, i, improving = None, 0, True
    while i < iterations and improving:
        dists = _half_sq(x, means, precision)
        best = dists.min(dim=1)
        cost = float(best.values.mean())
        assign = torch.nn.functional.one_hot(best.indices, means.shape[0]).to(x.dtype)
        mass = assign.sum(dim=0)
        new = mm(assign.T, x, precision) / torch.clamp(mass, min=1.0)[:, None]
        means = torch.where(mass[:, None] > 0, new, means)
        improving = prev is None or prev - cost >= tol * abs(prev)
        prev, i = cost, i + 1
    return means, i


def _log_likelihood(x, xsq, means, variances, weights, precision):
    inv = 1.0 / variances
    mahal = mm(xsq, (0.5 * inv).T, precision) - mm(x, (means * inv).T, precision) + 0.5 * (means * means * inv).sum(dim=1)
    lognorm = -0.5 * x.shape[1] * np.log(TWO_PI) - 0.5 * torch.log(variances).sum(dim=1) + torch.log(weights)
    return lognorm - mahal


def _posteriors(llh: torch.Tensor, threshold: float) -> torch.Tensor:
    q = torch.softmax(llh, dim=1)
    q = torch.where(q > threshold, q, torch.zeros_like(q))
    return q / torch.clamp(q.sum(dim=1, keepdim=True), min=1e-30)


def fit_mixture(x: torch.Tensor, config: Dict[str, Any], precision: str, anchor: Optional[Dict[str, Any]],
                report: Dict[str, Any]):
    """(means (k, d), variances (k, d), weights (k,), seed rows), following
    ``anchor``'s seed rows and EM stop by the rules of the module
    docstring."""
    gmm = config["gmm"]
    k = int(config["vocab_size"])
    anchor = anchor or {}
    given_rows = anchor.get("seed_rows")
    rows = kmeanspp_rows(x, k, int(gmm["seed"]), precision, None if given_rows is None else np.asarray(given_rows),
                         report)
    means, report["lloyd_iterations"] = lloyd(x, x[torch.as_tensor(rows, device=x.device)],
                                              int(gmm["lloyd_iterations"]), 1e-3, precision)
    assign = torch.nn.functional.one_hot(_half_sq(x, means, precision).argmin(dim=1), k).to(x.dtype)
    mass = assign.sum(dim=0)
    safe = torch.clamp(mass, min=1.0)[:, None]
    means = mm(assign.T, x, precision) / safe
    xsq = x * x
    variances = mm(assign.T, xsq, precision) / safe - means * means
    weights = mass / x.shape[0]
    del assign
    floor = torch.clamp(float(gmm["small_variance_threshold"]) * x.var(dim=0, unbiased=False),
                        min=float(gmm["absolute_variance_threshold"]))
    variances = torch.maximum(variances, floor)
    given = [anchor.get(key) for key in ("init_means", "init_variances", "init_weights")]
    if all(g is not None for g in given):
        report["init_gaps"] = [float(np.linalg.norm(np.asarray(g, dtype=np.float64) - own) / np.linalg.norm(own))
                               for g, own in zip(given, (t.to("cpu", torch.float64).numpy()
                                                         for t in (means, variances, weights)))]
    tol, threshold = float(gmm["stop_tolerance"]), float(gmm["weight_threshold"])
    given_updates = anchor.get("em_updates")
    updates = 0
    prev, i, going = None, 0, True
    report["em_near_ties"] = []
    while i < int(gmm["max_iterations"]) and going:
        llh = _log_likelihood(x, xsq, means, variances, weights, precision)
        cost = float(torch.logsumexp(llh, dim=1).mean())
        improving = True
        if prev is not None:
            ratio = (cost - prev) / abs(prev)
            improving = ratio >= tol
            if given_updates is not None and abs(ratio - tol) < EM_STOP_SLACK * tol and improving != (i < given_updates):
                # A near-tie of the stop rule, decided as the given fit did.
                improving = not improving
                report["em_near_ties"].append([i, ratio])
        q = _posteriors(llh, threshold)
        del llh
        mass = q.sum(dim=0)
        going = improving and bool((mass >= float(gmm["min_cluster_size"])).all())
        if going:
            safe = torch.clamp(mass, min=1e-12)[:, None]
            means = mm(q.T, x, precision) / safe
            variances = torch.maximum(mm(q.T, xsq, precision) / safe - means * means, floor)
            weights = mass / x.shape[0]
            updates += 1
        del q
        prev, i = cost, i + 1
    report.update(em_iterations=i, em_updates=updates)
    return means, variances, weights, rows


# --------------------------------------------------------------- Fisher


def fisher_vectors(desc: torch.Tensor, comps: torch.Tensor, mixture, config: Dict[str, Any],
                   precision: str) -> torch.Tensor:
    """(N, descriptors, 128) uint8 → (N, desc_dim · 2k) features after the
    row normalisations."""
    means, variances, weights = (t.T if t.ndim == 2 else t for t in mixture[:3])  # (d, k)
    threshold = float(config["gmm"]["weight_threshold"])
    dtype = comps.dtype
    out = []
    for start in range(0, desc.shape[0], IMAGE_CHUNK):
        chunk = desc[start : start + IMAGE_CHUNK].to(dtype)
        b, count, _ = chunk.shape
        x = mm(chunk.reshape(-1, chunk.shape[-1]), comps, precision)
        q = _posteriors(_log_likelihood(x, x * x, means.T, variances.T, weights, precision), threshold)
        x, q = x.reshape(b, count, -1), q.reshape(b, count, -1)
        s0 = q.mean(dim=1)[:, None, :]
        s1 = mm(x.transpose(1, 2), q, precision) / count
        s2 = mm((x * x).transpose(1, 2), q, precision) / count
        fv1 = (s1 - means * s0) / (torch.sqrt(variances) * torch.sqrt(weights))
        fv2 = (s2 - 2.0 * means * s1 + (means * means - variances) * s0) / (variances * torch.sqrt(2.0 * weights))
        f = torch.cat([fv1, fv2], dim=2).reshape(b, -1)
        f = f / _safe_norm(f)
        f = torch.sign(f) * torch.sqrt(f.abs())
        out.append(f / _safe_norm(f))
    return torch.cat(out)


def _safe_norm(f: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt((f * f).sum(dim=1, keepdim=True))
    return torch.where(norms == 0, torch.ones_like(norms), norms)


# ---------------------------------------------------------------- whole


def _anchor(inputs: Dict[str, Any], precision: str) -> Optional[Dict[str, Any]]:
    """The fit whose seed rows and EM stop this one checks and follows: the
    program's, else (below float64) the float64 reference's on the same
    inputs."""
    anchors = inputs.get("anchors") or {}
    if anchors.get("program") is not None:
        return anchors["program"]
    if precision != "fp64":
        return anchors.get("fp64")
    return None


def fit_and_score(config: Dict[str, Any], inputs: Dict[str, Any], eval_sets: Dict[str, torch.Tensor],
                  seed: int, precision: str, device) -> Dict[str, torch.Tensor]:
    with _no_tf32():
        return _fit_and_score(config, inputs, eval_sets, seed, precision, device)


def _fit_and_score(config, inputs, eval_sets, seed, precision, device):
    dtype = dtype_of(precision)
    images = inputs["x"].to(device)
    n = images.shape[0]
    desc = all_descriptors(images, config, precision)
    c = desc.shape[1]
    take_pca = min(max(1, int(config["num_pca_samples"]) // n), c)
    take_gmm = min(max(1, int(config["num_gmm_samples"]) // n), c)
    positions = sample_positions(n, c, max(take_pca, take_gmm), seed, desc.device)
    comps = pca_components(gather_rows(desc, positions[:, :take_pca], dtype), int(config["desc_dim"]), precision)
    sample = mm(gather_rows(desc, positions[:, :take_gmm], dtype), comps, precision)
    del positions
    report: Dict[str, Any] = {}
    anchor = _anchor(inputs, precision)
    mixture = fit_mixture(sample, config, precision, anchor, report)
    del sample
    anchors = inputs.get("anchors")
    if isinstance(anchors, dict):
        anchors[f"report_{precision}"] = report
        if precision == "fp64" and anchors.get("program") is None:
            anchors["fp64"] = {"seed_rows": mixture[3], "em_iterations": report["em_iterations"],
                               "em_updates": report["em_updates"]}
    program = (anchors or {}).get("program") or {}
    print(f"voc_sift_fisher reference ({precision}): lloyd {report['lloyd_iterations']} em {report['em_iterations']} "
          f"(program: lloyd {program.get('lloyd_iterations')} em {program.get('em_iterations')}); seed rows "
          f"followed {report.get('seed_rows_followed', 0)} of {int(config['vocab_size'])} given"
          f"{'' if anchor else ' (none given)'}, widest miss {report.get('seed_worst_miss', 0.0)!r}"
          f", diverged at draw {report.get('seed_diverged_at')}; the given EM start apart (means, variances, "
          f"weights) {report.get('init_gaps')}; EM stop near-ties followed "
          f"{report['em_near_ties']}", flush=True)

    feats = fisher_vectors(desc, comps, mixture, config, precision)
    del desc
    k = int(config["num_classes"])
    y = inputs["labels"].to(device=device, dtype=dtype)
    mu_f, mu_y = feats.mean(dim=0), y.mean(dim=0)
    feats -= mu_f
    w = block_coordinate_descent(feats, y - mu_y, float(config["reg"]), int(config["num_epochs"]),
                                 int(config["block_size"]), precision)
    del feats
    out: Dict[str, torch.Tensor] = {}
    for name, rows in eval_sets.items():
        f = fisher_vectors(all_descriptors(rows.to(device), config, precision), comps, mixture, config, precision)
        out[name] = (mm(f - mu_f, w, precision) + mu_y).to("cpu", torch.float64)
    assert all(v.shape[1] == k for v in out.values())
    return out

