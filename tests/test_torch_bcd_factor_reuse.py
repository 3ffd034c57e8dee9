"""Block Cholesky factors kept across the passes of a block coordinate
descent, on the CPU.

A block's A_bᵀA_b + λI does not change between passes, so every
multi-pass BCD of the port forms each block's Gram and factor on the
first pass and solves the later passes with the kept factor
(``linalg._BlockFactors``): in core, over 8 row shards, rematerialised,
host-streamed, from Gram statistics, on a 2-D mesh and in the
conv-block estimator's own loops. For each, with 3 passes:

- the weights equal those of the same solve with the factors declined
  (a device budget too small for them) to within 1e-6 relative;
- ``keystone_bcd_steps_total`` counts ``gram`` = blocks (none from
  statistics), ``factor`` = blocks and ``factor_reuse`` = (passes − 1) ×
  blocks, and per pass ``gram`` and ``factor`` when declined;
- a one-pass solve keeps nothing, reads no device budget and counts no
  ``factor_reuse``.

The two fallbacks, at the estimator: a budget too small for the factors,
and an out-of-memory error while they are being kept, each form per pass,
give the same weights and leave the block size as it was (no
``model.degradation``).
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.obs import names
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator
from keystone_tpu_torch.parallel import linalg
from keystone_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")
STEPS = ("gram", "factor", "factor_reuse", "block_update")
PASSES = 3
TOL = 1e-6


def _steps():
    counter = names.metric(names.BCD_STEPS)
    return {step: counter.value(step=step) for step in STEPS}


def _counted(fn):
    before = _steps()
    out = fn()
    after = _steps()
    return out, {s: after[s] - before[s] for s in STEPS}


def _rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def _problem(n=100, d=16, k=3, seed=0):
    """n = 100 is not a multiple of 8: the sharded solves pad rows."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) + 0.5
    y = x @ torch.randn(d, k, generator=g) + 0.1 * torch.randn(n, k, generator=g)
    return x - x.mean(0), y - y.mean(0)


def _conv_problem(n=24, num_filters=6, seed=1):
    rng = np.random.default_rng(seed)
    filters = rng.normal(size=(num_filters, 6 * 6 * 3)).astype(np.float32) * 0.1
    fz = tcore.FusedConvFeaturizer(tcore.Convolver(filters, 3, normalize_patches=True, device=CPU),
                                   tcore.SymmetricRectifier(alpha=0.25),
                                   tcore.Pooler(13, 14, None, "sum"), filter_block=2)
    images = rng.random((n, 32, 32, 3)).astype(np.float32)
    y = rng.normal(size=(n, 3)).astype(np.float32)
    return fz, ArrayDataset(images, device=CPU), ArrayDataset(y, device=CPU)


def _in_core(passes, mesh=None):
    x, y = _problem()
    return linalg.block_coordinate_descent(x, y, 0.1, passes, 4, mesh=mesh)


def _rematerialized(passes, mesh=None):
    x, y = _problem(n=128)

    def block_fn(b, offset, rows):
        return x[offset : offset + rows, b * 4 : (b + 1) * 4]

    return linalg.block_coordinate_descent_rematerialized(block_fn, y, 0.1, passes, 4, 4, mesh=mesh)


def _streamed(passes, mesh=None):
    x, y = _problem(d=14)  # a short last block
    return linalg.block_coordinate_descent_streaming(x, y, 0.1, passes, 4, device=CPU, mesh=mesh)[0]


def _from_gram(passes, mesh=None):
    x, y = _problem()
    return linalg.bcd_from_gram(x.T @ x, x.T @ y, 0.1, passes, 4)


def _two_d(passes, mesh=None):
    x, y = _problem(n=128)
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    return linalg.block_coordinate_descent_2d(x, y, 0.1, passes, 2, mesh=mesh)


def _conv_block(passes, mesh=None):
    fz, images, y = _conv_problem()
    est = ConvBlockLeastSquaresEstimator(fz, block_size=16, num_iter=passes, reg=0.5, image_chunk=10, device=CPU)
    if mesh is None:
        return est.fit(images, y).weights
    with tmesh.use_mesh(mesh):
        return est.fit(images, y).weights


# name → (solve, blocks, forms its Grams, on 8 row shards)
PATHS = {
    "in_core": (_in_core, 4, True, False),
    "sharded": (_in_core, 4, True, True),
    "rematerialized": (_rematerialized, 4, True, False),
    "rematerialized_sharded": (_rematerialized, 4, True, True),
    "streamed": (_streamed, 4, True, False),
    "streamed_sharded": (_streamed, 4, True, True),
    "from_gram": (_from_gram, 4, False, False),
    "two_d": (_two_d, 8, True, False),
    "conv_block": (_conv_block, 3, True, False),
    "conv_block_sharded": (_conv_block, 3, True, True),
}


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh(devices=[CPU] * 8)


def _declined(monkeypatch):
    """A device budget too small for any factor."""
    monkeypatch.setattr(linalg, "_free_device_bytes", lambda device: 0)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_kept_factors_give_the_declined_weights_with_one_gram_and_factor_a_block(path, mesh8, monkeypatch):
    solve, blocks, forms_grams, sharded = PATHS[path]
    mesh = mesh8 if sharded else None
    kept, kept_steps = _counted(lambda: solve(PASSES, mesh))
    assert kept_steps == {
        "gram": blocks if forms_grams else 0,
        "factor": blocks,
        "factor_reuse": (PASSES - 1) * blocks,
        "block_update": PASSES * blocks,
    }
    _declined(monkeypatch)
    declined, declined_steps = _counted(lambda: solve(PASSES, mesh))
    assert declined_steps == {
        "gram": PASSES * blocks if forms_grams else 0,
        "factor": PASSES * blocks,
        "factor_reuse": 0,
        "block_update": PASSES * blocks,
    }
    assert _rel(kept, declined) <= TOL


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_one_pass_solve_keeps_nothing(path, mesh8, monkeypatch):
    solve, blocks, forms_grams, sharded = PATHS[path]

    def no_budget_read(device):
        raise AssertionError("a one-pass solve read the device budget")

    monkeypatch.setattr(linalg, "_free_device_bytes", no_budget_read)
    _, steps = _counted(lambda: solve(1, mesh8 if sharded else None))
    assert steps == {"gram": blocks if forms_grams else 0, "factor": blocks, "factor_reuse": 0,
                     "block_update": blocks}


def test_factors_are_kept_only_when_they_fit_the_budget(monkeypatch):
    # 4 blocks of 4 × 4 float32 factors, and 3 blocks' workspace: 7 × 64 bytes.
    need = (4 + 3) * 4 * 4 * 4
    for budget, kept in [(need, True), (need - 1, False), (None, True)]:
        monkeypatch.setattr(linalg, "_free_device_bytes", lambda device, budget=budget: budget)
        assert linalg._BlockFactors(PASSES, 4, 4, torch.float32, CPU).enabled is kept
    monkeypatch.setattr(linalg, "_free_device_bytes", lambda device: need + 10)
    assert not linalg._BlockFactors(PASSES, 4, 4, torch.float32, CPU, workspace=11).enabled


# ---------------------------------------------------------------- fallbacks


def _fit(host_streaming):
    x, y = _problem(n=64, d=12)
    est = BlockLeastSquaresEstimator(4, num_iter=PASSES, reg=0.1, device=CPU, host_streaming=host_streaming)
    return est.fit(ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))


def _oom_on_call(monkeypatch, call):
    """The ``call``-th block factorisation runs out of device memory."""
    original, calls = linalg._cholesky, []

    def cholesky(a):
        calls.append(1)
        if len(calls) == call:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 64.00 MiB")
        return original(a)

    monkeypatch.setattr(linalg, "_cholesky", cholesky)


# fallback → the steps it counts over 3 blocks and 3 passes. The
# out-of-memory error comes at the third block of the first pass, with
# two factors kept: its Gram was formed (and counted) before the failed
# factorisation, then the step runs again with nothing kept.
FALLBACKS = {
    "budget": (_declined, {"gram": 9, "factor": 9, "factor_reuse": 0, "block_update": 9}),
    "oom_while_keeping": (lambda mp: _oom_on_call(mp, 3), {"gram": 10, "factor": 9, "factor_reuse": 0,
                                                          "block_update": 9}),
}


@pytest.mark.parametrize("host_streaming", [False, True], ids=["in_core", "streamed"])
@pytest.mark.parametrize("fallback", sorted(FALLBACKS))
def test_fallbacks_form_per_pass_and_keep_the_block_size(fallback, host_streaming, monkeypatch):
    kept, kept_steps = _counted(lambda: _fit(host_streaming))
    assert kept_steps == {"gram": 3, "factor": 3, "factor_reuse": 6, "block_update": 9}
    arrange, expected = FALLBACKS[fallback]
    arrange(monkeypatch)
    model, steps = _counted(lambda: _fit(host_streaming))
    assert steps == expected
    assert model.block_size == kept.block_size == 4
    assert not hasattr(model, "degradation")
    assert _rel(model.weights, kept.weights) <= TOL


def test_an_oom_with_nothing_kept_still_reaches_the_ladder(monkeypatch):
    """The first factorisation fails with no factor kept: the cache is not
    the cause, and the estimator halves the block as before."""
    _oom_on_call(monkeypatch, 1)
    model = _fit(False)
    assert model.block_size == 2 and model.degradation["rung"] == 2
