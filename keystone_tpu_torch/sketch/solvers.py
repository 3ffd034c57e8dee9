"""Sketch-based least-squares solvers and randomized Nyström KRR.

Port of ``keystone_tpu/sketch/solvers.py``. Two regimes share the
operators in :mod:`.core`:

- **Streamed** (:meth:`SketchedLeastSquaresEstimator.fit_stream`): pure
  one-pass sketch-and-solve. The fold accumulates the O(s·d) carry; the
  finish solves the SKETCHED ridge objective exactly — the stacked
  primal lstsq when s ≥ d, the s×s dual (push-through) solve
  ``Ãᵀ(ÃÃᵀ+λI)⁻¹`` when s < d, never a d×d one.
- **In-core** (:meth:`SketchedLeastSquaresEstimator.fit` /
  :func:`sketch_precond_lstsq`): sketch-and-PRECONDITION. The same
  sketch builds a preconditioner for block PCG on the full normal
  operator; ``KEYSTONE_SKETCH_REFINE`` passes drive the error to solver
  tolerance.

Devices and precision: every estimator takes ``device=`` (default
CUDA). Products run at IEEE fp32 (the binding on a card, the precision
the JAX package's plain ``@`` has on the CPU); contractions over the
example axis go through ``linalg._mm_t``'s 4,096-row partial sums, and
K = SA·SAᵀ over the feature axis through ``sketch_gram``'s 4,096-column
ones. QR,
LU, Cholesky, SVD and triangular solves are ``torch.linalg``'s (cuSOLVER
on a card). The primal finish solves its tall, full-rank stacked system
by QR; the minimum-norm ``lstsq`` rung is an SVD with the JAX package's
``rcond=None`` cutoff (ε·max(s, d)·σ_max), since ``torch.linalg.lstsq``
on a CUDA tensor assumes full rank.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..envknobs import env_int, env_str
from ..obs import names as _names
from ..obs import solver as solver_obs
from ..obs import spans as _spans
from ..parallel import linalg
from ..refit.state import SketchStreamStateMixin
from ..reliability import DegradationLadder, probe
from ..workflow.pipeline import LabelEstimator
from .core import (
    MASK_INDEX_EXACT_ROWS,
    VARIANTS,
    _mm32,
    index_mask,
    sketch_gram,
    sketch_state_bytes,
    sketch_stream_finish,
    sketch_stream_init,
    sketch_stream_step,
)


def default_sketch_size(d: int) -> int:
    """Sketch rows for a width-d fit when nothing pins one: ``min(4096,
    max(128, d))``. At s ≥ d the sketched ridge objective is a full-rank
    compression; only past d = 4,096 does the O(s·d) state force the
    accuracy/memory trade."""
    return int(min(4096, max(128, int(d))))


def sketch_min_width() -> int:
    """Ladder eligibility floor (``KEYSTONE_SKETCH_MIN_WIDTH``): below
    this featurized width the exact/Gram rungs are both affordable and
    more accurate, so the sketched rung prices itself out (inf)."""
    return env_int("KEYSTONE_SKETCH_MIN_WIDTH", 8192)


def _refine_iters_default() -> int:
    return env_int("KEYSTONE_SKETCH_REFINE", 16)


def _reg_floor(k_mat: torch.Tensor, s: int, reg: float) -> float:
    """λ for the s×s dual solve: the caller's ridge when set, else a
    floor relative to tr(K)/s so a rank-deficient sketch factors
    finitely instead of emitting NaNs."""
    if reg and reg > 0:
        return float(reg)
    return max(1e-6 * float(torch.trace(k_mat)) / max(s, 1), 1e-6)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares by SVD with the JAX package's
    ``rcond=None`` cutoff: singular values below ε·max(m, n)·σ_max are
    dropped, so a wide or rank-deficient ``a`` solves as
    ``jnp.linalg.lstsq`` solves it."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return _mm32(vt.T, s_inv[:, None] * _mm32(u.T, b))


class SketchedLeastSquaresEstimator(SketchStreamStateMixin, LabelEstimator):
    """Least squares from an O(s·d) row-space sketch, on ``device``
    (default CUDA).

    The very wide rung of the solver ladder (``least_squares.py``):
    state O(s·d) against the Gram family's O(d²). ``reg`` follows the
    exact rung's contract (> 0 ridge; 0/None the scale-aware floor);
    ``sketch_size``/``variant``/``seed`` default from the
    ``KEYSTONE_SKETCH_*`` knobs.
    """

    #: Chunked-fit protocol (workflow/streaming.py): the sketch carry
    #: accumulates per chunk exactly like a Gram does.
    supports_fit_stream = True

    #: 2-D partitioner protocol: SA and Σx block the feature axis
    #: (``sketch_stream_step``'s blocked protocol) on a (data, model) mesh.
    supports_model_axis = True

    def __init__(
        self,
        reg: Optional[float] = None,
        sketch_size: Optional[int] = None,
        variant: Optional[str] = None,
        seed: Optional[int] = None,
        refine_iters: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.reg = reg
        self.sketch_size = sketch_size
        self.variant = variant or env_str("KEYSTONE_SKETCH_VARIANT", "countsketch")
        if self.variant not in VARIANTS:
            raise ValueError(f"KEYSTONE_SKETCH_VARIANT={self.variant!r} (known: {VARIANTS})")
        self.seed = env_int("KEYSTONE_SKETCH_SEED", 0) if seed is None else int(seed)
        self.refine_iters = refine_iters
        self.device = device

    # ------------------------------------------------------- configuration
    def _resolve_sketch_size(self, d: int) -> int:
        """Priority: env knob > constructor > a measured winner
        (``_tuned_sketch_size``, set on a copy by the measured-knob rule
        of the JAX package) > width default."""
        s = env_int("KEYSTONE_SKETCH_SIZE", 0)
        if s > 0:
            return s
        if self.sketch_size:
            return int(self.sketch_size)
        tuned = getattr(self, "_tuned_sketch_size", 0)
        if tuned:
            return int(tuned)
        return default_sketch_size(d)

    @property
    def stream_state_meta(self):
        """Envelope meta for kind="sketch" states: what a resumed or
        merged fold must agree on for the additive carry algebra to be
        meaningful (sizes are structural — carried by the shapes)."""
        return {"sketch_variant": self.variant, "sketch_seed": int(self.seed)}

    # ------------------------------------------------------- streamed path
    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ..workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label)

    def fit_stream(self, stream, state=None):
        """One-pass sketch-and-solve over the chunk stream.

        ``state`` (kind="sketch") seeds the carry so the fold EXTENDS an
        earlier fit — resuming adopts the state's (variant, seed) so the
        combined sketch stays one coherent linear map of all rows."""
        from ..ops.learning.block import _stream_shapes
        from ..workflow.streaming import StreamingFallback

        n_rows = int(getattr(stream, "num_examples", 0))
        if n_rows > MASK_INDEX_EXACT_ROWS:
            raise StreamingFallback(
                f"sketch row indices exceed float32-exact range ({n_rows} > {MASK_INDEX_EXACT_ROWS})"
            )
        variant, seed = self.variant, self.seed
        if state is not None and state.meta.get("sketch_variant"):
            variant = state.meta["sketch_variant"]
            seed = int(state.meta.get("sketch_seed", seed))
            self.variant, self.seed = variant, seed
        shapes = {}

        def init(feat_spec, y_spec):
            d, k = _stream_shapes(feat_spec, y_spec)
            s = self._resolve_sketch_size(d)
            shapes.update(s=s, d=d, k=k)
            return self._seed_carry(state, s, d, k, stream.device)

        t0 = time.perf_counter()
        carry, info = stream.fold(init, sketch_stream_step(variant, seed))
        n = info["num_examples"] + (state.num_examples if state else 0)
        self._capture_state(carry, n, reg=self.reg, sketch_variant=variant, sketch_seed=int(seed))
        model = self._finish_from_stats(carry, n)
        self._observe(rows=n, wall_s=time.perf_counter() - t0, variant=variant, **shapes)
        return model

    def _finish_from_stats(self, carry, n: int):
        """Solve the sketched objective from the carry alone — shared by
        the streamed fit and ``finish_from_state``.

        Rung 1 is the stacked primal (s ≥ d) or the s×s dual (s < d);
        when it runs out of memory the ladder degrades to a minimum-norm
        lstsq on the sketched system (O(s·d·min(s, d)) workspace, no s²
        or (s + d)×d stack) — slower, never bigger."""
        from ..ops.learning.linear import LinearMapper

        sa_c, sy_c, mu_a, mu_b = sketch_stream_finish(carry, n)
        s, d = int(sa_c.shape[0]), int(sa_c.shape[1])

        def _primal():
            # s ≥ d: stacked ridge lstsq on [SAc; √λ·I], tall and full
            # rank, by QR. The dual form is unstable here: K = SAc·SAcᵀ
            # has rank ≤ d < s.
            lam = (
                float(self.reg) if self.reg and self.reg > 0
                else max(1e-6 * float(torch.sum(sa_c * sa_c)) / s, 1e-6)
            )
            stacked = torch.cat([sa_c, (lam ** 0.5) * _eye(d, sa_c)], dim=0)
            rhs = torch.cat([sy_c, sy_c.new_zeros(d, sy_c.shape[1])], dim=0)
            q, r = torch.linalg.qr(stacked)
            return torch.linalg.solve_triangular(r, _mm32(q.T, rhs), upper=True)

        def _dual():
            # s < d: the s×s dual is the point of the sketch — the d×d
            # primal never materializes; K is full-rank generically.
            k_mat = sketch_gram(sa_c)
            lam = _reg_floor(k_mat, s, self.reg or 0.0)
            duals = torch.linalg.solve(k_mat + lam * _eye(s, k_mat), sy_c)
            return _mm32(sa_c.T, duals)

        def _lstsq():
            return lstsq_min_norm(sa_c, sy_c)

        first = ("primal", _primal) if s >= d else ("dual", _dual)
        ladder = DegradationLadder([first, ("lstsq", _lstsq)], label="sketch.finish")
        attempts = iter(range(len(ladder.rungs)))

        def attempt(rung):
            name, fn = rung
            probe("sketch.finish")
            with solver_obs.rung_span("sketch_ls", name, next(attempts)):
                return fn()

        t0 = time.perf_counter()
        w = ladder.run(attempt)
        _names.metric(_names.SKETCH_FINISH_SECONDS).observe(time.perf_counter() - t0)
        model = LinearMapper(w, intercept=mu_b, feature_mean=mu_a)
        if ladder.reduced:
            model.degradation = dict(
                ladder.record, rung=ladder.record["rung"][0],
                first_rung=ladder.record["first_rung"][0],
            )
        return model

    # -------------------------------------------------------- in-core path
    def fit(self, data, labels):
        """Sketch-and-precondition on materialized data: the sketch
        builds a preconditioner and block PCG refines on the FULL
        operator, so accuracy is solver-grade while no d×d matrix ever
        exists."""
        from ..ops.learning.block import _as_array_dataset
        from ..ops.learning.linear import LinearMapper

        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        x = features.data[: features.num_examples].to(device=device, dtype=torch.float32)
        y = targets.data[: targets.num_examples].to(device=device, dtype=torch.float32)
        if y.ndim == 1:
            y = y[:, None]
        n, d = int(x.shape[0]), int(x.shape[1])
        mu_a = x.mean(dim=0)
        mu_b = y.mean(dim=0)
        xc, yc = x - mu_a, y - mu_b
        del x
        s = self._resolve_sketch_size(d)
        iters = self.refine_iters if self.refine_iters is not None else _refine_iters_default()
        t0 = time.perf_counter()
        w = sketch_precond_lstsq(
            xc, yc, reg=self.reg or 0.0, sketch_size=s,
            variant=self.variant, seed=self.seed, iters=iters,
        )
        self._observe(
            rows=n, wall_s=time.perf_counter() - t0, variant=self.variant,
            s=s, d=d, k=int(y.shape[1]), refine_iters=iters,
        )
        return LinearMapper(w, intercept=mu_b, feature_mean=mu_a)

    # --------------------------------------------------------- observation
    def _observe(self, rows, wall_s, variant, s, d, k, **extra):
        """Profile-store observation and the keystone_sketch_* metrics."""
        from ..ops.learning.block import _record_solver_observation

        _record_solver_observation(
            "sketch_ls", rows=rows, d=d, block_size=s, wall_s=wall_s,
            rungs_attempted=1, sketch_size=s, sketch_variant=variant, **extra,
        )
        _names.metric(_names.SKETCH_FITS).inc(variant=variant)
        _names.metric(_names.SKETCH_SIZE).set(s)
        _names.metric(_names.SKETCH_STATE_BYTES).set(sketch_state_bytes(s, d, k))


# -------------------------------------------------- sketch-and-precondition


def sketch_precond_lstsq(
    xc: torch.Tensor,
    yc: torch.Tensor,
    reg: float = 0.0,
    sketch_size: Optional[int] = None,
    variant: str = "countsketch",
    seed: int = 0,
    iters: Optional[int] = None,
    block_rows: int = 8192,
) -> torch.Tensor:
    """Solve min ‖xc·w − yc‖² + reg‖w‖² by sketch-and-precondition, on
    ``xc``'s device.

    ``xc``/``yc`` are CENTERED (n, d)/(n, k). The sketch of xc (built
    block by block — additivity is exact) yields the exact inverse of
    the SKETCHED normal operator as a preconditioner: by the Blendenpik
    QR of [S·xc; √λ·I] when s ≥ d, by the Woodbury identity

        M⁻¹v = (v − (S·xc)ᵀ(K+λI)⁻¹(S·xc)v) / λ,   K = (S·xc)(S·xc)ᵀ,

    through one s×s LU factor when s < d. Block PCG on the full operator
    N·v = xcᵀ(xc·v) + λv then converges in a handful of iterations.
    Returns w (d, k).
    """
    xc = xc.to(torch.float32)
    yc = yc.to(torch.float32)
    if yc.ndim == 1:
        yc = yc[:, None]
    n, d = int(xc.shape[0]), int(xc.shape[1])
    s = int(sketch_size or default_sketch_size(d))
    iters = _refine_iters_default() if iters is None else int(iters)

    step = sketch_stream_step(variant, int(seed))
    carry = sketch_stream_init(s, d, int(yc.shape[1]), xc.device)
    for start in range(0, n, block_rows):
        stop = min(start + block_rows, n)
        carry = step(carry, xc[start:stop], yc[start:stop], index_mask(start, stop, xc.device))
    sa = carry[0]  # xc is pre-centred: the raw sketch IS the centred one

    k_mat = sketch_gram(sa)
    lam = _reg_floor(k_mat, s, reg)

    if s >= d:
        # Blendenpik form: R from QR of [SA; √λ·I] gives RᵀR = SAᵀSA + λI
        # exactly, applied by two triangular solves — stable where the
        # s×s K (rank ≤ d < s) would fail a float32 factorisation.
        stacked = torch.cat([sa, (lam ** 0.5) * _eye(d, sa)], dim=0)
        rmat = torch.linalg.qr(stacked, mode="r")[1]

        def minv(v):
            t = torch.linalg.solve_triangular(rmat.T, v, upper=False)
            return torch.linalg.solve_triangular(rmat, t, upper=True)

    else:
        lu, pivots = torch.linalg.lu_factor(k_mat + lam * _eye(s, k_mat))

        def minv(v):
            return (v - _mm32(sa.T, torch.linalg.lu_solve(lu, pivots, _mm32(sa, v)))) / lam

    def nmat(v):  # the full (never materialized) normal operator
        return linalg._mm_t(xc, _mm32(xc, v), "ieee_fp32") + lam * v

    tiny = 1e-30
    b = linalg._mm_t(xc, yc, "ieee_fp32")
    w = torch.zeros_like(b)
    r = b  # w0 = 0
    z = minv(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    for _ in range(max(iters, 0)):
        q = nmat(p)
        alpha = rz / torch.clamp_min(torch.sum(p * q, dim=0), tiny)
        w = w + alpha * p
        r = r - alpha * q
        z = minv(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / torch.clamp_min(rz, tiny)
        p = z + beta * p
        rz = rz_new

    def sketch_only():
        # The dual identity on the sketched system alone — coarser than
        # refined PCG but bounded, and never NaN.
        return _mm32(sa.T, torch.linalg.solve(k_mat + lam * _eye(s, k_mat), carry[1]))

    if iters <= 0:
        return sketch_only()
    # Divergence guard (one host sync): when s undersamples the row space
    # M⁻¹N is no longer O(1)-conditioned and PCG can run away — float32
    # overflow shows up as a residual past ‖b‖, then NaN. The refined
    # answer is kept only when it beats the starting residual.
    r_norm = float(torch.linalg.norm(r))
    if not np.isfinite(r_norm) or r_norm > float(torch.linalg.norm(b)):
        return sketch_only()
    return w


# ------------------------------------------------------------ Nyström KRR


def nystrom_krr(x: torch.Tensor, y, gamma: float, reg: float, landmarks: int, seed: int = 0):
    """Randomized Nyström kernel ridge: m seeded uniform landmarks, solve
    min ‖K_nm·α − y‖² + λ·αᵀK_mm·α — O(n·m + m²) state instead of the
    full O(n²) kernel. The kernel panels are computed on ``x``'s device;
    the solve runs in float64 numpy on the host, as in the JAX package.
    Returns (landmark_indices, duals float32 on ``x``'s device)."""
    from ..ops.learning.kernel import gaussian_kernel_block

    x = x.to(torch.float32)
    y = np.asarray(y, np.float64)
    if y.ndim == 1:
        y = y[:, None]
    n = int(x.shape[0])
    m = int(min(landmarks, n))
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0xA11CE5))
    idx = np.sort(rng.choice(n, size=m, replace=False))
    xm = x[torch.from_numpy(idx).to(x.device)]
    knm = gaussian_kernel_block(x, xm, gamma).cpu().numpy().astype(np.float64)  # (n, m)
    kmm = gaussian_kernel_block(xm, xm, gamma).cpu().numpy().astype(np.float64)  # (m, m)
    lam = max(float(reg), 1e-6)
    # The stacked least squares [K_nm; √λ·Lᵀ]·α ≈ [y; 0] with
    # L = chol(K_mm + jitter) keeps κ(K) itself where the normal
    # equations would square it.
    with _spans.span("sketch:nystrom_host_solve", rows=n, landmarks=m):
        jitter = 1e-10 * max(float(np.trace(kmm)) / m, 1.0)
        lmat = np.linalg.cholesky(kmm + jitter * np.eye(m))
        stacked = np.concatenate([knm, np.sqrt(lam) * lmat.T], axis=0)
        rhs = np.concatenate([y, np.zeros((m, y.shape[1]))], axis=0)
        duals, *_ = np.linalg.lstsq(stacked, rhs, rcond=None)
    return idx, torch.as_tensor(duals.astype(np.float32), device=x.device)


__all__ = [
    "SketchedLeastSquaresEstimator",
    "default_sketch_size",
    "lstsq_min_norm",
    "nystrom_krr",
    "sketch_min_width",
    "sketch_precond_lstsq",
]
