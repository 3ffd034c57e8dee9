"""The sharded half of the port's ``parallel/linalg.py`` on the CPU, held
against the JAX package's on the conftest's 8 virtual devices and against
the port's own 1-shard results, with the same numpy inputs made from a
seed: ``gram``, ``normal_equations_solve``, the centered solve with and
without refinement (row padding included), ``tsqr_r`` / ``tsqr_svd``,
block coordinate descent in-core, rematerialized and host-streamed,
the 2-D solver on 4×2 and 2×4 meshes, and ``block_sharded_apply``.

Tolerance: ≤ 1e-5 relative (Frobenius) everywhere. An R factor is
compared up to the sign of each row (QR's sign convention is the
LAPACK kernel's, not the math's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from keystone_tpu.parallel import linalg as jl
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch.parallel import linalg as tl
from keystone_tpu_torch.parallel import mesh as tmesh
from keystone_tpu_torch.parallel.collectives import Sharded

CPU = torch.device("cpu")
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def meshes():
    return {
        "port8": tmesh.make_mesh(devices=[CPU] * 8),
        "port1": tmesh.make_mesh(devices=[CPU]),
        "jax8": jmesh.make_mesh(devices=jax.devices()[:8]),
    }


def _problem(n=100, d=16, k=3, seed=0):
    """n = 100 is not a multiple of 8: every sharded call pads rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) + 0.5
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=(n, k))).astype(np.float32)
    return x, y


def _sign_rows(r):
    r = np.asarray(r, np.float64)
    return r * np.sign(np.diag(r))[:, None]


# ------------------------------------------------------------------- layout


def test_prepare_row_sharded_pads_and_views(meshes):
    x, _ = _problem()
    a = _t(x)
    laid = tl.prepare_row_sharded(a, meshes["port8"])
    assert isinstance(laid, Sharded) and laid.shape == (104, 16)
    assert [tuple(s.shape) for s in laid.shards] == [(13, 16)] * 8
    assert torch.count_nonzero(laid.shards[-1][9:]) == 0  # the 4 pad rows
    jlaid = jl.prepare_row_sharded(jnp.asarray(x), meshes["jax8"])
    assert tuple(jlaid.shape) == laid.shape
    np.testing.assert_array_equal(laid.assemble().numpy(), np.asarray(jlaid))
    even = tl.prepare_row_sharded(a[:96], meshes["port8"])
    assert even.shards[2].data_ptr() == a[24:].data_ptr()  # a view, not a copy


# ------------------------------------------------------------- Gram / solve


def test_gram_sharded_equals_jax_and_one_shard(meshes):
    x, y = _problem()
    g8, c8 = tl.gram(_t(x), _t(y), mesh=meshes["port8"])
    g1, c1 = tl.gram(_t(x), _t(y), mesh=meshes["port1"])
    jg, jc = jl.gram(jl.prepare_row_sharded(x, meshes["jax8"]), jl.prepare_row_sharded(y, meshes["jax8"]),
                     mesh=meshes["jax8"])
    assert _rel(g8, jg) <= TOL and _rel(c8, jc) <= TOL
    assert _rel(g8, g1) <= TOL and _rel(c8, c1) <= TOL
    only, none = tl.gram(_t(x), mesh=meshes["port8"])
    assert none is None and torch.equal(only, g8)


def test_normal_equations_solve_sharded(meshes):
    x, y = _problem()
    w8 = tl.normal_equations_solve(_t(x), _t(y), reg=0.1, mesh=meshes["port8"])
    w1 = tl.normal_equations_solve(_t(x), _t(y), reg=0.1)
    jw = jl.normal_equations_solve(jl.prepare_row_sharded(x, meshes["jax8"]),
                                   jl.prepare_row_sharded(y, meshes["jax8"]), reg=0.1, mesh=meshes["jax8"])
    assert _rel(w8, jw) <= TOL and _rel(w8, w1) <= TOL


@pytest.mark.parametrize("refine_steps", [0, 2])
def test_centered_solve_refined_with_row_padding(meshes, refine_steps):
    """The logical n = 100 centers: the 4 pad rows change no mean."""
    x, y = _problem()
    kw = dict(gram_precision="highest", refine_steps=refine_steps)
    w8, mua8, mub8 = tl.centered_solve_refined(_t(x), _t(y), 100, 0.1, mesh=meshes["port8"], **kw)
    w1, mua1, mub1 = tl.centered_solve_refined(_t(x), _t(y), 100, 0.1, **kw)
    jm = meshes["jax8"]
    jw, jmua, jmub = jl.centered_solve_refined(
        jl.prepare_row_sharded(x, jm), jl.prepare_row_sharded(y, jm), 100, 0.1, mesh=jm,
        gram_precision=lax.Precision.HIGHEST, refine_steps=refine_steps,
    )
    for got, one, want in ((w8, w1, jw), (mua8, mua1, jmua), (mub8, mub1, jmub)):
        assert _rel(got, want) <= TOL and _rel(got, one) <= TOL
    xc, yc = x - x.mean(0), y - y.mean(0)
    exact = np.linalg.solve(xc.T @ xc + 0.1 * np.eye(16), xc.T @ yc)
    assert _rel(w8, exact) <= 1e-4


def test_refine_guard_fires_under_a_mesh(meshes, monkeypatch):
    x, y = _problem()
    monkeypatch.setattr(tl, "_TEST_GRAM_PERTURB", 0.5)
    before = tl.centered_solve_refined.guard_fired
    w8, _, _ = tl.centered_solve_refined(_t(x), _t(y), 100, 0.1, gram_precision="default",
                                         refine_steps=2, mesh=meshes["port8"])
    assert tl.centered_solve_refined.guard_fired == before + 1
    monkeypatch.setattr(tl, "_TEST_GRAM_PERTURB", 0.0)
    clean, _, _ = tl.centered_solve_refined(_t(x), _t(y), 100, 0.1, gram_precision="highest",
                                            refine_steps=2, mesh=meshes["port8"])
    assert _rel(w8, clean) <= 1e-4


# --------------------------------------------------------------------- TSQR


def test_tsqr_sharded_equals_jax(meshes):
    x, _ = _problem(n=96, d=12)
    r8 = tl.tsqr_r(_t(x), mesh=meshes["port8"])
    r1 = tl.tsqr_r(_t(x))
    jr = jl.tsqr_r(jl.prepare_row_sharded(x, meshes["jax8"]), mesh=meshes["jax8"])
    assert _rel(_sign_rows(r8), _sign_rows(jr)) <= TOL
    assert _rel(_sign_rows(r8), _sign_rows(r1)) <= TOL
    assert _rel(r8.T @ r8, x.T.astype(np.float64) @ x) <= TOL
    s8, vt8 = tl.tsqr_svd(_t(x), mesh=meshes["port8"])
    js, jvt = jl.tsqr_svd(jl.prepare_row_sharded(x, meshes["jax8"]), mesh=meshes["jax8"])
    assert _rel(s8, js) <= TOL
    assert _rel(np.abs(vt8.numpy()), np.abs(np.asarray(jvt))) <= TOL


# ---------------------------------------------------------------------- BCD


def _centered(n=128, d=16, k=3, seed=1):
    x, y = _problem(n, d, k, seed)
    return x - x.mean(0), y - y.mean(0)


def test_bcd_sharded_equals_jax_and_one_shard(meshes):
    xc, yc = _centered(n=100)
    w8 = tl.block_coordinate_descent(_t(xc), _t(yc), 0.1, 3, 4, mesh=meshes["port8"])
    w1 = tl.block_coordinate_descent(_t(xc), _t(yc), 0.1, 3, 4)
    jm = meshes["jax8"]
    jw = jl.block_coordinate_descent(jl.prepare_row_sharded(xc, jm), jl.prepare_row_sharded(yc, jm),
                                     0.1, 3, 4, mesh=jm)
    assert _rel(w8, jw) <= TOL and _rel(w8, w1) <= TOL


def test_rematerialized_bcd_sharded_equals_jax(meshes):
    xc, yc = _centered(n=128)
    a_t, a_j = _t(xc), jnp.asarray(xc)

    def t_block(b, offset, rows):
        return a_t[offset : offset + rows, b * 4 : (b + 1) * 4]

    def j_block(b, offset, rows):
        return lax.dynamic_slice(a_j, (offset, b * 4), (rows, 4))

    w8 = tl.block_coordinate_descent_rematerialized(t_block, _t(yc), 0.1, 2, 4, 4, mesh=meshes["port8"])
    w1 = tl.block_coordinate_descent_rematerialized(t_block, _t(yc), 0.1, 2, 4, 4)
    jm = meshes["jax8"]
    jw = jl.block_coordinate_descent_rematerialized(j_block, jl.prepare_row_sharded(yc, jm), 0.1, 2, 4, 4,
                                                    mesh=jm)
    assert _rel(w8, jw) <= TOL and _rel(w8, w1) <= TOL


def test_streaming_bcd_sharded_equals_jax(meshes):
    x, y = _problem(n=100, d=14, seed=2)  # 14 columns: a short last block
    w8, mua8, mub8 = tl.block_coordinate_descent_streaming(
        x, y, 0.1, 2, 4, device=CPU, mesh=meshes["port8"]
    )
    w1, _, _ = tl.block_coordinate_descent_streaming(x, y, 0.1, 2, 4, device=CPU)
    jw, jmua, jmub = jl.block_coordinate_descent_streaming(x, jnp.asarray(y), 0.1, 2, 4, mesh=meshes["jax8"])
    assert _rel(w8, jw) <= TOL and _rel(w8, w1) <= TOL
    assert _rel(mua8, jmua) <= TOL and _rel(mub8, jmub) <= TOL


# ---------------------------------------------------------------------- 2-D


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_bcd_2d_equals_jax(meshes, shape):
    xc, yc = _centered(n=128, d=16)
    mesh = tmesh.make_mesh(shape, ("data", "model"), devices=[CPU] * 8)
    jm = jmesh.make_mesh(shape, ("data", "model"), devices=jax.devices()[:8])
    w = tl.block_coordinate_descent_2d(_t(xc), _t(yc), 0.1, 3, 2, mesh=mesh)
    jw = jl.block_coordinate_descent_2d(
        jl.prepare_block_sharded(xc, jm), jl.prepare_block_sharded(yc, jm, fine_rows=True), 0.1, 3, 2, mesh=jm
    )
    assert tuple(w.shape) == (16, 3)
    assert _rel(w, jw) <= TOL
    # The same fixed point as the 1-D solver: many epochs meet the ridge solution.
    w_long = tl.block_coordinate_descent_2d(_t(xc), _t(yc), 0.1, 40, 2, mesh=mesh)
    exact = np.linalg.solve(xc.T @ xc + 0.1 * np.eye(16), xc.T @ yc)
    assert _rel(w_long, exact) <= 1e-4


def test_prepare_block_sharded_layouts(meshes):
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    a = torch.arange(100 * 6, dtype=torch.float32).reshape(100, 6)
    tiles = tl.prepare_block_sharded(a, mesh)
    fine = tl.prepare_block_sharded(a, mesh, fine_rows=True)
    assert tiles.shape == fine.shape == (104, 6)
    assert tuple(tiles.shards[0].shape) == (26, 3) and tuple(fine.shards[0].shape) == (13, 6)
    jm = jmesh.make_mesh((4, 2), ("data", "model"), devices=jax.devices()[:8])
    np.testing.assert_array_equal(tiles.assemble().numpy(), np.asarray(jl.prepare_block_sharded(a.numpy(), jm)))


def test_block_sharded_apply_equals_jax(meshes):
    x, _ = _problem(n=100, d=16)
    w = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    jm = jmesh.make_mesh((4, 2), ("data", "model"), devices=jax.devices()[:8])
    got = tl.block_sharded_apply(_t(x), _t(w), mesh=mesh)
    want = jl.block_sharded_apply(jl.prepare_block_sharded(x, jm), jnp.asarray(w), mesh=jm)
    assert tuple(got.shape) == tuple(want.shape) == (104, 3)
    assert _rel(got, want) <= TOL and _rel(got[:100], x @ w) <= TOL
    assert torch.equal(tl.block_sharded_apply(_t(x), _t(w), mesh=meshes["port8"]), tl.mm(_t(x), _t(w)))


def test_gram_stream_step_declares_the_blocked_protocol():
    """The blocks of ``gram_stream_block_step``, summed over block
    indices, are ``gram_stream_step``'s carry (the 2-D streamed fit's
    identity)."""
    x, y = _problem(n=32, d=8)
    full = tl.gram_stream_step(tl.gram_stream_init(8, 3, CPU), _t(x), _t(y))
    assert tl.gram_stream_step.model_layout == jl.gram_stream_step.model_layout == (0, 0, 0, None)
    def block_carry():
        return (torch.zeros(2, 8), torch.zeros(2, 3), torch.zeros(2), torch.zeros(3))

    blocks = [tl.gram_stream_block_step(block_carry(), _t(x), _t(y), j) for j in range(4)]
    assert _rel(torch.cat([b[0] for b in blocks]), full[0]) <= 1e-6
    assert _rel(torch.cat([b[2] for b in blocks]), full[2]) <= 1e-6
    assert _rel(sum(b[3] for b in blocks), full[3]) <= 1e-6
