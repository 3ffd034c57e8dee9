"""L-BFGS least-squares solvers (dense + sparse data).

Port of ``keystone_tpu/ops/learning/lbfgs.py`` (reference:
nodes/learning/LBFGS.scala:14-281, nodes/learning/Gradient.scala:10-119).

Loss (matching LeastSquaresDenseGradient): ½‖XW − Y‖²/n + ½λ‖W‖².

The JAX package runs ``optax.lbfgs(memory_size=m)`` inside one compiled
loop. :func:`minimize_lbfgs` is the same algorithm, written out on
tensors (optax 0.2.6, ``optax.lbfgs`` defaults):

- the two-loop recursion with ``scale_init_precond=True`` (the initial
  inverse Hessian is γ·I, γ = ⟨Δg, Δw⟩/‖Δg‖² after the first step and
  min(1, 1/‖g₀‖) before it), memory ``m`` in a ring buffer;
- the zoom line search (Nocedal & Wright Algorithms 3.5/3.6 with the
  approximate Wolfe test of Hager & Zhang): ``max_linesearch_steps=20``,
  ``initial_guess_strategy='one'``, ``slope_rtol=1e-4``,
  ``curv_rtol=0.9``, ``approx_dec_rtol=1e-6``, ``increase_factor=2``,
  ``stepsize_precision=1e-5`` (the interval length below which a step of
  sufficient decrease is taken);
- the line search's last value and gradient are reused at the next
  iterate (``optax.value_and_grad_from_state``);
- the loop runs while ``i < num_iterations and ‖g‖₂ > tol``, where ``g``
  is the gradient the previous step started from (the JAX loop's
  carry), tested before each step.

The line search's control flow reads two scalars (value and slope) to
the host per objective evaluation; the iterate, the memory and the
two-loop recursion stay on the device. The objective's gradient is in
closed form, ``Xcᵀ(Xc·W − Yc)/n + λW``, its two products through the
solver binding at the mode's precision (``linalg.mm`` and the
row-chunked ``linalg.mm_t``).

The sparse variant solves on the host, as in the JAX package: scipy
L-BFGS-B over CSR matvecs (``_sparse_lbfgs_host``), and the model lands
on the estimator's device.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ...data.dataset import ArrayDataset, Dataset
from ...device import DeviceLike, resolve_device
from ...parallel import linalg
from ...workflow.pipeline import LabelEstimator
from .block import _as_array_dataset
from .linear import LinearMapper, SparseLinearMapper

#: ``optax.scale_by_zoom_linesearch`` as ``optax.lbfgs`` configures it.
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR, STEPSIZE_PRECISION = 2.0, 1e-5

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class DenseLBFGSEstimator(LabelEstimator):
    """reference: LBFGS.scala DenseLBFGSwithL2. Fits on ``device``
    (default CUDA); the fitted mapper carries the run's ``lbfgs`` record
    (:func:`minimize_lbfgs`)."""

    def __init__(
        self,
        reg: float = 0.0,
        num_iterations: int = 100,
        memory_size: int = 10,
        tol: float = 1e-6,
        fit_intercept: bool = True,
        device: DeviceLike = None,
    ):
        self.reg = reg
        self.num_iterations = num_iterations
        self.memory_size = memory_size
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.device = device

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        device = resolve_device(self.device)
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        n = features.num_examples
        x = features.data[:n].to(device=device, dtype=torch.float32)
        y = targets.data[:n].to(device=device, dtype=torch.float32)
        if self.fit_intercept:
            mu_a, mu_b = x.sum(dim=0) / n, y.sum(dim=0) / n
            xc, yc = x - mu_a, y - mu_b
        else:
            xc, yc = x, y
        del x, y
        reg = float(self.reg)

        def value_and_grad(w):
            r = linalg.mm(xc, w) - yc
            value = 0.5 * torch.sum(r * r) / n + 0.5 * reg * torch.sum(w * w)
            return value, linalg.mm_t(xc, r) / n + reg * w

        w0 = torch.zeros(xc.shape[1], yc.shape[1], dtype=torch.float32, device=device)
        w, info = minimize_lbfgs(value_and_grad, w0, self.num_iterations, self.memory_size, self.tol)
        mapper = LinearMapper(
            w,
            intercept=mu_b if self.fit_intercept else None,
            feature_mean=mu_a if self.fit_intercept else None,
        )
        mapper.lbfgs = info
        return mapper


class SparseLBFGSEstimator(LabelEstimator):
    """reference: LBFGS.scala SparseLBFGSwithL2.

    Accepts an ObjectDataset of scipy CSR rows (the Sparsify output) or a
    dense ArrayDataset. The solve is host-side scipy L-BFGS over the CSR
    matrix, as in the JAX package; the model lands on ``device`` (default
    CUDA).
    """

    def __init__(self, reg: float = 0.0, num_iterations: int = 100,
                 memory_size: int = 10, tol: float = 1e-6, device: DeviceLike = None):
        self.reg = reg
        self.num_iterations = num_iterations
        self.memory_size = memory_size
        self.tol = tol
        self.device = device

    def fit(self, data: Dataset, labels: Dataset) -> SparseLinearMapper:
        import scipy.sparse as sp

        device = resolve_device(self.device)
        targets = _as_array_dataset(labels, device)
        y = targets.data[: targets.num_examples].cpu().numpy().astype(np.float64)

        if isinstance(data, ArrayDataset):
            mat = sp.csr_matrix(data.data[: data.num_examples].cpu().numpy())
        else:
            rows = data.collect()
            mat = sp.vstack([r if sp.issparse(r) else sp.csr_matrix(np.asarray(r).reshape(1, -1)) for r in rows])
        w = _sparse_lbfgs_host(
            mat.tocsr(), y, float(self.reg),
            self.num_iterations, self.memory_size, self.tol,
        )
        return SparseLinearMapper(torch.as_tensor(w, dtype=torch.float32, device=device))


def _sparse_lbfgs_host(mat, y, reg, num_iterations, memory_size, tol):
    """scipy L-BFGS-B on 0.5·‖Xw − y‖²/n + 0.5·reg·‖w‖² with CSR matvecs.

    One Xw + one Xᵀr per objective evaluation (~2·nnz·k flops); scipy's
    Wolfe line search typically needs 1-2 evaluations per iteration.

    Stop rule: the estimator's documented ‖g‖₂ ≤ tol, enforced directly
    by a callback over the most recently evaluated gradient (scipy's own
    gtol tests the inf-norm). The callback raises StopIteration: scipy
    >= 1.11 treats that as clean termination (status 99, current iterate
    returned); on older scipy the exception propagates out of
    ``minimize``, so it is caught here and the last accepted iterate
    (recorded by the callback before raising) is returned — identical
    result either way.
    """
    from scipy.optimize import minimize

    n, d = mat.shape
    k = y.shape[1]
    mat_t = mat.T.tocsr()  # one-time CSC→CSR so Xᵀr is also a fast product
    last_grad_norm = [np.inf]  # written by value_and_grad, read by callback
    last_xk = [None]  # pre-raise snapshot for the scipy<1.11 escape path

    def value_and_grad(w_flat):
        w = w_flat.reshape(d, k)
        r = mat @ w - y
        value = 0.5 * float(np.sum(r * r)) / n + 0.5 * reg * float(np.sum(w * w))
        grad = (mat_t @ r) / n + reg * w
        last_grad_norm[0] = float(np.linalg.norm(grad))
        return value, grad.ravel()

    def stop_on_grad_norm(xk):
        from ...obs import solver as solver_obs

        solver_obs.count_iteration(
            "sparse_lbfgs", grad_norm=round(last_grad_norm[0], 8)
        )
        # The last gradient the line search evaluated is at (or adjacent
        # to) the accepted iterate xk — close enough for a stop test.
        if last_grad_norm[0] <= tol:
            last_xk[0] = np.array(xk, copy=True)
            raise StopIteration

    try:
        res = minimize(
            value_and_grad,
            np.zeros(d * k),
            jac=True,
            method="L-BFGS-B",
            callback=stop_on_grad_norm,
            options={
                "maxiter": num_iterations,
                "maxcor": memory_size,
                # The callback owns the gradient stop; disable scipy's
                # inf-norm gtol and the ftol flat-step stop.
                "gtol": 0.0,
                "ftol": 0.0,
                # keep line-search probes bounded at huge nnz
                "maxls": 20,
            },
        )
        w_flat = res.x
    except StopIteration:  # scipy < 1.11: the callback's stop propagates
        w_flat = last_xk[0]
    return w_flat.reshape(d, k)


# ------------------------------------------------------------ the L-BFGS loop


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def minimize_lbfgs(
    value_and_grad: ValueAndGrad,
    w0: torch.Tensor,
    num_iterations: int,
    memory_size: int,
    tol: float,
) -> Tuple[torch.Tensor, dict]:
    """Minimize a smooth objective from ``w0`` by ``optax.lbfgs``'s
    algorithm (module docstring). ``value_and_grad(w)`` returns the
    objective as a 0-dim tensor and its gradient shaped like ``w``.

    Returns the final iterate and a record: ``iterations`` (steps taken),
    ``evaluations`` (calls of ``value_and_grad``), ``objective`` (the
    value at each iterate, the start and the last included) and
    ``linesearch_steps`` per iteration."""
    m = memory_size
    dw_mem: List[Optional[torch.Tensor]] = [None] * m
    du_mem: List[Optional[torch.Tensor]] = [None] * m
    rho: List[Optional[torch.Tensor]] = [None] * m
    prev_w = prev_g = None
    evaluations = 0

    def evaluate(w):
        nonlocal evaluations
        evaluations += 1
        return value_and_grad(w)

    w = w0
    value, grad = evaluate(w)
    objective = [float(value)]
    ls_steps: List[int] = []
    count, gnorm = 0, math.inf
    while count < num_iterations and gnorm > tol:
        # scale_by_lbfgs: store the last (Δw, Δg) pair, then precondition.
        if count > 0:
            dw, du = w - prev_w, grad - prev_g
            curv = _vdot(du, dw)
            slot = (count - 1) % m
            dw_mem[slot], du_mem[slot] = dw, du
            rho[slot] = torch.where(curv == 0, torch.zeros_like(curv), 1.0 / curv)
            den = _vdot(du, du)
            gamma = torch.where(den > 0, curv / den, torch.ones_like(den))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        direction = _two_loop(grad, dw_mem, du_mem, rho, gamma, count % m)
        prev_w, prev_g = w, grad
        updates = -direction
        step, value, new_grad, steps = _zoom_linesearch(
            evaluate, w, updates, value, grad
        )
        w = w + step * updates
        gnorm = float(torch.linalg.vector_norm(grad))
        grad = new_grad
        objective.append(value)
        ls_steps.append(steps)
        count += 1
    return w, {
        "iterations": count, "evaluations": evaluations, "objective": objective,
        "linesearch_steps": ls_steps,
    }


def _two_loop(g, dw_mem, du_mem, rho, gamma, memory_idx):
    """optax's ``_precondition_by_lbfgs``: slots visited newest to oldest,
    then oldest to newest, from the ring position ``memory_idx``. Slots
    never written hold zeros in optax (ρ = 0, a no-op) and are skipped."""
    m = len(rho)
    order = [(memory_idx + j) % m for j in range(m)]
    order = [i for i in order if rho[i] is not None]
    vec = g
    alphas = {}
    for i in reversed(order):
        alphas[i] = rho[i] * _vdot(dw_mem[i], vec)
        vec = vec - alphas[i] * du_mem[i]
    vec = gamma * vec
    for i in order:
        beta = rho[i] * _vdot(du_mem[i], vec)
        vec = vec + (alphas[i] - beta) * dw_mem[i]
    return vec


def _nan_max(a: float, b: float) -> float:
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _nan_min(a: float, b: float) -> float:
    return math.nan if math.isnan(a) or math.isnan(b) else min(a, b)


def _decrease_error(stepsize, value, slope, value0, slope0) -> float:
    err = value - value0 - SLOPE_RTOL * stepsize * slope0
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope0
    delta = value - value0 - APPROX_DEC_RTOL * abs(value0)
    err = _nan_min(_nan_max(approx, delta), err)
    err = _nan_max(err, 0.0)
    return math.inf if math.isnan(err) else err


def _curvature_error(slope, slope0) -> float:
    err = _nan_max(abs(slope) - CURV_RTOL * abs(slope0), 0.0)
    return math.inf if math.isnan(err) else err


def _cubicmin(a, fa, fpa, b, fb, c, fc) -> float:
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (scipy's, as optax adapts it); NaN where none exists."""
    try:
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r1 = fb - fa - fpa * db
        r2 = fc - fa - fpa * dc
        big_a = (dc**2 * r1 - db**2 * r2) / denom
        big_b = (-(dc**3) * r1 + db**3 * r2) / denom
        radical = big_b * big_b - 3.0 * big_a * fpa
        if radical < 0:
            return math.nan
        return a + (-big_b + math.sqrt(radical)) / (3.0 * big_a)
    except (ZeroDivisionError, OverflowError, ValueError):
        return math.nan


def _quadmin(a, fa, fpa, b, fb) -> float:
    try:
        db = b - a
        big_b = (fb - fa - fpa * db) / (db**2)
        return a - fpa / (2.0 * big_b)
    except (ZeroDivisionError, OverflowError):
        return math.nan


def _zoom_linesearch(evaluate, w, u, value0, grad0):
    """optax's ``zoom_linesearch`` along ``u`` from ``w``: returns the
    step, the value and gradient there, and the steps taken."""
    slope0 = float(_vdot(u, grad0))
    value0 = float(value0)

    def on_line(t):
        v, g = evaluate(w + t * u)
        v_host, s_host = torch.stack([v.reshape(()), _vdot(g, u)]).tolist()
        return v_host, g, s_host

    count, stepsize, value, grad, slope = 0, 0.0, value0, grad0, slope0
    dec_err = math.inf
    interval_found = done = failed = False
    low, value_low, slope_low = 0.0, value0, slope0
    high, value_high, slope_high = 0.0, value0, slope0
    cubic_ref, value_cubic_ref = 0.0, value0
    safe_step, safe_value, safe_grad = 0.0, value0, grad0
    while not (done or failed):
        if not interval_found:  # Algorithm 3.5: find an interval
            new = 1.0 if count == 0 else INCREASE_FACTOR * stepsize
            v, g, s = on_line(new)
            dec_err = _decrease_error(new, v, s, value0, slope0)
            error = max(dec_err, _curvature_error(s, slope0))
            if dec_err <= 0.0:
                safe_step, safe_value, safe_grad = new, v, g
            set_high = dec_err > 0.0 or (v >= value and count > 0)
            set_low = s >= 0.0 and not set_high
            if set_low:
                low, value_low, slope_low = new, v, s
                high, value_high, slope_high = stepsize, value, slope
            else:
                low, value_low, slope_low = stepsize, value, slope
                high, value_high, slope_high = new, v, s
            interval_found = set_high or set_low or error <= 0.0
            done = error <= 0.0
            failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
            cubic_ref, value_cubic_ref = low, value_low
        else:  # Algorithm 3.6: zoom into it
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref, value_cubic_ref)
            quad = _quadmin(low, value_low, slope_low, high, value_high)
            if left + 0.2 * delta < cubic < right - 0.2 * delta:
                new = cubic
            elif left + 0.1 * delta < quad < right - 0.1 * delta:
                new = quad
            else:
                new = (low + high) / 2.0
            v, g, s = on_line(new)
            dec_err = _decrease_error(new, v, s, value0, slope0)
            error = max(dec_err, _curvature_error(s, slope0))
            if dec_err <= 0.0 and v < safe_value:
                safe_step, safe_value, safe_grad = new, v, g
            done = error <= 0.0
            set_high_mid = dec_err > 0.0 or v >= value_low
            set_high_low = s * (high - low) >= 0.0 and not set_high_mid
            old_low, old_value_low, old_slope_low = low, value_low, slope_low
            old_high, old_value_high = high, value_high
            if set_high_mid:
                high, value_high, slope_high = new, v, s
            elif set_high_low:
                high, value_high, slope_high = old_low, old_value_low, old_slope_low
            if not set_high_mid:
                low, value_low, slope_low = new, v, s
            if set_high_mid or set_high_low:
                cubic_ref, value_cubic_ref = old_high, old_value_high
            else:
                cubic_ref, value_cubic_ref = old_low, old_value_low
            failed = (count + 1 >= MAX_LINESEARCH_STEPS
                      or (delta <= STEPSIZE_PRECISION and safe_step > 0.0)) and not done
        count += 1
        stepsize, value, grad, slope = new, v, g, s
        if failed and (safe_step > 0.0 or math.isinf(dec_err)):
            stepsize, value, grad = safe_step, safe_value, safe_grad
    return stepsize, value, grad, count


__all__ = ["DenseLBFGSEstimator", "SparseLBFGSEstimator", "minimize_lbfgs"]
