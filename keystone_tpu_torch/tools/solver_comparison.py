"""Solver comparison sweep + cost-constant fit.

Port of ``scripts/solver_comparison.py``: it times each least-squares
rung (``exact``, ``block``, ``lbfgs``, ``sparse_lbfgs``) over a shape
grid on ``--device`` (default: the card), writes the comparison CSV,
and with ``--fit-constants`` least-squares-fits the (cpu, mem, network)
weights of the cost model (``ops/learning/cost.py``) to the measured
rung times, the reference's ``scripts/constantEstimator.R``; on the card
each weight is bounded below by the card's data-sheet peak. It prints
the fitted weights beside the defaults the device would use
(``default_cost_weights``: the card's data-sheet peaks, or the
reference's cluster constants on the host) and changes no default: it
writes a constants file only where ``--constants-out`` names one.

Usage:
    python -m keystone_tpu_torch.tools.solver_comparison --out rows.csv \\
        [--fit-constants] [--preset quick|full] [--device cpu]
    python -m keystone_tpu_torch.tools.solver_comparison --fit-only \\
        --merge-csv rows.csv --fit-constants

``--preset quick`` fits in a minute on the host; ``full`` is the JAX
sweep's ``FULL_GRID`` for the card.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

QUICK_GRID = [
    # (n, d, k, sparsity)
    (20_000, 256, 8, 1.0),
    (20_000, 512, 8, 1.0),
    (40_000, 256, 8, 1.0),
    (20_000, 1024, 8, 0.01),
]

FULL_GRID = [
    # TIMIT-like dense column (reference csv rows: n=2.2M, k=138)
    (500_000, 1024, 138, 1.0),
    (500_000, 2048, 138, 1.0),
    (1_000_000, 1024, 138, 1.0),
    # Amazon-like sparse shapes (reference csv: n=65M, k=2, sparsity=0.005)
    (1_000_000, 1024, 2, 0.005),
    (1_000_000, 4096, 2, 0.005),
    (1_000_000, 16384, 2, 0.005),
]

# Dense-materialization ceiling: sparse problems above this many logical
# elements only run the sparse solver.
DENSE_ELEMS_LIMIT = 2e8

#: The rungs' fixed settings (the JAX sweep's ``solvers()``).
BLOCK, EPOCHS, ITERS = 1024, 3, 20


def make_problem(n, d, k, sparsity, seed=0):
    """(x, y): a scipy CSR matrix for sparse shapes (never densified at
    generation time), a dense float32 array otherwise; the JAX sweep's
    draws."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d, k)).astype(np.float32)
    if sparsity < 1.0:
        import scipy.sparse as sp

        per_row = max(1, round(d * sparsity))
        indices = rng.integers(0, d, size=n * per_row, dtype=np.int32)
        indptr = np.arange(0, n * per_row + 1, per_row, dtype=np.int64)
        data = rng.random(n * per_row, dtype=np.float32)
        x = sp.csr_matrix((data, indices, indptr), shape=(n, d))
        y = np.asarray(x @ w_true, dtype=np.float32)
        y += 0.1 * rng.normal(size=(n, k)).astype(np.float32)
        return x, y
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = x @ w_true + 0.1 * rng.normal(size=(n, k)).astype(np.float32)
    return x, y


def solvers(reg: float, sparsity: float, n: int, d: int, device) -> Dict[str, Any]:
    """Rung name → estimator factory for one grid row."""
    from ..ops.learning.block import BlockLeastSquaresEstimator
    from ..ops.learning.lbfgs import DenseLBFGSEstimator, SparseLBFGSEstimator
    from ..ops.learning.linear import LinearMapEstimator

    out = {}
    if sparsity >= 1.0 or n * d <= DENSE_ELEMS_LIMIT:
        out["exact"] = lambda: LinearMapEstimator(reg, device=device)
        out["block"] = lambda: BlockLeastSquaresEstimator(BLOCK, num_iter=EPOCHS, reg=reg, device=device)
        out["lbfgs"] = lambda: DenseLBFGSEstimator(num_iterations=ITERS, reg=reg, device=device)
    if sparsity < 1.0:
        out["sparse_lbfgs"] = lambda: SparseLBFGSEstimator(num_iterations=ITERS, reg=reg, device=device)
    return out


def time_solver(name: str, make, x, y, device):
    """(milliseconds of one warm fit, train MSE on up to 65,536 head
    rows). Dense problems are placed on the device before the clock; the
    host rung (scipy) is timed cold, as in the JAX sweep."""
    import scipy.sparse as sp
    import torch

    from ..data.dataset import ArrayDataset, ObjectDataset

    is_sparse = sp.issparse(x)
    if name == "sparse_lbfgs":
        xd = ObjectDataset([x if is_sparse else sp.csr_matrix(x)])
        yd = ArrayDataset(y, device=device)
    else:
        dense = np.asarray(x.todense()) if is_sparse else x
        xd = ArrayDataset(torch.from_numpy(dense).to(device))
        yd = ArrayDataset(torch.from_numpy(y).to(device))

    def run():
        model = make().fit(xd, yd)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return model

    if name != "sparse_lbfgs":
        run()
    start = time.perf_counter()
    model = run()
    seconds = time.perf_counter() - start
    head = min(x.shape[0], 65536, max(1024, int(1e8 / x.shape[1])))
    xh = np.asarray(x[:head].todense()) if is_sparse else x[:head]
    pred = model.apply_arrays(torch.from_numpy(xh).to(device)).cpu().numpy()
    err = float(np.mean((pred - y[:head]) ** 2))
    return seconds * 1000.0, err


def cost_features(name, n, d, k, sparsity, num_machines=1):
    """Per-rung (flops, elements scanned, elements moved): the expressions
    of the cost classes in ``ops/learning/least_squares.py`` (keep in
    sync), in the raw units ``CostWeights`` carries."""
    m = num_machines
    log_m = np.log2(max(2, m))
    if name == "exact":
        flops = n * d * (d + k) / m + d * d * d
        elems = n * d / m + d * d
        moved = d * (d + k)
    elif name == "block":
        b = BLOCK
        iters = EPOCHS * max(d // b, 1)
        flops = iters * (n * b * (b + k)) / m
        elems = iters * n * b / m
        moved = iters * (b * b + b * k) * log_m
    else:  # lbfgs / sparse_lbfgs
        iters = ITERS
        sp_ = max(sparsity, 1e-12)
        flops = iters * n * d * k * sp_ / m
        elems = iters * n * d * sp_ / m
        moved = iters * d * k * log_m
    return flops, elems, moved


def fit_constants(rows: List[Dict[str, Any]], lower) -> Dict[str, Any]:
    """Bounded least-squares fit of ms ≈ c₀ + cpu·flops + mem·elems +
    net·moved over the dense rows (rows on the device), each weight
    bounded below by ``lower`` (a ``CostWeights``: a device cannot beat
    its own peak) and a per-solve intercept c₀ that the argmin cancels;
    the sparse rows (host scipy) get their own (cpu, c₀). Returns the
    fitted weights, intercepts and per-row relative residuals."""
    from scipy.optimize import lsq_linear

    def features(r):
        return cost_features(r["solver"], r["n"], r["d"], r["k"], r["sparsity"], r.get("machines", 1))

    dense_rows = [r for r in rows if r["sparsity"] >= 1.0]
    sparse_rows = [r for r in rows if r["sparsity"] < 1.0]
    if not dense_rows:
        raise ValueError("no dense rows to fit")
    a = np.asarray([list(features(r)) + [1.0] for r in dense_rows])
    t = np.asarray([r["ms"] for r in dense_rows])
    fit = lsq_linear(a, t, bounds=([lower.cpu, lower.mem, lower.network, 0.0], [np.inf] * 4))
    pred = a @ fit.x
    rel = np.abs(pred - t) / np.maximum(t, 1e-9)
    out: Dict[str, Any] = {
        "cpu": float(fit.x[0]),
        "mem": float(fit.x[1]),
        "network": float(fit.x[2]),
        "dispatch_intercept_ms": float(fit.x[3]),
        "fit_residual_ms": float(np.sqrt(np.mean((pred - t) ** 2))),
        "per_row_rel_residual": {
            f"{r['solver']}_n{r['n']}_d{r['d']}": round(float(e), 3) for r, e in zip(dense_rows, rel)
        },
        "physical_lower_bounds": {"cpu": lower.cpu, "mem": lower.mem, "network": lower.network},
    }
    if sparse_rows:
        a2 = np.asarray([[features(r)[0], 1.0] for r in sparse_rows])
        t2 = np.asarray([r["ms"] for r in sparse_rows])
        fit2 = lsq_linear(a2, t2, bounds=([0.0, 0.0], [np.inf] * 2))
        pred2 = a2 @ fit2.x
        out["host_sparse"] = {
            "cpu": float(fit2.x[0]),
            "intercept_ms": float(fit2.x[1]),
            "per_row_rel_residual": {
                f"{r['solver']}_n{r['n']}_d{r['d']}": round(float(abs(p - m) / max(m, 1e-9)), 3)
                for r, p, m in zip(sparse_rows, pred2, t2)
            },
        }
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m keystone_tpu_torch.tools.solver_comparison")
    parser.add_argument("--out", default="solver-comparisons.csv")
    parser.add_argument("--preset", choices=("quick", "full"), default="quick")
    parser.add_argument("--fit-constants", action="store_true")
    parser.add_argument(
        "--fit-only", action="store_true",
        help="skip measurement: load --merge-csv rows and fit",
    )
    parser.add_argument(
        "--constants-out", default=None,
        help="write the fitted constants here (nothing is written otherwise)",
    )
    parser.add_argument("--reg", type=float, default=1e-3)
    parser.add_argument("--grid", choices=("all", "dense", "sparse"), default="all")
    parser.add_argument(
        "--merge-csv", default=None,
        help="CSV of previously measured rows to merge in; fresh rows win on "
        "(solver, n, d, k, sparsity)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA device; 'cpu' to run on the CPU)",
    )
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from ..ops.learning.cost import CostWeights, default_cost_weights

    device = resolve_device(args.device)
    grid = QUICK_GRID if args.preset == "quick" else FULL_GRID
    if args.grid == "dense":
        grid = [g for g in grid if g[3] >= 1.0]
    elif args.grid == "sparse":
        grid = [g for g in grid if g[3] < 1.0]
    if args.fit_only:
        grid = []
        if not args.merge_csv:
            parser.error("--fit-only needs --merge-csv (the rows to fit)")
    rows: List[Dict[str, Any]] = []
    for n, d, k, sparsity in grid:
        x, y = make_problem(n, d, k, sparsity)
        for name, make in solvers(args.reg, sparsity, n, d, device).items():
            ms, err = time_solver(name, make, x, y, device)
            rows.append({
                "solver": name, "n": n, "d": d, "k": k, "sparsity": sparsity,
                "ms": round(ms, 2), "train_mse": round(err, 6), "machines": 1,
            })
            print(rows[-1], flush=True)
    if args.merge_csv:
        fresh = {(r["solver"], r["n"], r["d"], r["k"], r["sparsity"]) for r in rows}
        with open(args.merge_csv) as f:
            for r in csv.DictReader(f):
                r = {
                    "solver": r["solver"], "n": int(r["n"]), "d": int(r["d"]),
                    "k": int(r["k"]), "sparsity": float(r["sparsity"]),
                    "ms": float(r["ms"]), "train_mse": float(r["train_mse"]),
                    "machines": int(r.get("machines") or 1),
                }
                if (r["solver"], r["n"], r["d"], r["k"], r["sparsity"]) not in fresh:
                    rows.append(r)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {args.out} ({len(rows)} measurements)")

    if args.fit_constants:
        defaults = default_cost_weights(device)
        # The card's data-sheet peaks bound each weight below; the host
        # has no such peaks (its defaults are the reference's cluster
        # constants, not physical limits), so there the bounds are 0.
        lower = defaults if device.type == "cuda" else CostWeights(0.0, 0.0, 0.0)
        fitted = fit_constants(rows, lower)
        fitted["device"] = str(device)
        fitted["defaults"] = {"cpu": defaults.cpu, "mem": defaults.mem, "network": defaults.network}
        print(
            "fitted CostWeights(cpu=%.3e, mem=%.3e, network=%.3e) against the defaults "
            "CostWeights(cpu=%.3e, mem=%.3e, network=%.3e)  # ms per flop / fp32 element; "
            "dispatch intercept %.1f ms"
            % (fitted["cpu"], fitted["mem"], fitted["network"],
               defaults.cpu, defaults.mem, defaults.network, fitted["dispatch_intercept_ms"])
        )
        print("FIT_CONSTANTS:" + json.dumps(fitted))
        if args.constants_out:
            with open(args.constants_out, "w") as f:
                json.dump(fitted, f, indent=1)
            print(f"wrote {args.constants_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
