"""The port's mesh and collectives (``keystone_tpu_torch/parallel/mesh.py``,
``collectives.py``) on the CPU, held against the JAX package's on the
conftest's 8 virtual devices: each of the six collectives against its
``lax`` counterpart under ``shard_map`` (1-D and 2-D meshes, each axis),
the mesh helpers against ``keystone_tpu/parallel/mesh.py``, and the
single-controller contract — fixed summation order, shards as views,
refusals of mismatched shapes and devices, a card that is not there.

An 8-shard mesh here names the CPU eight times, as ``chip_smoke.py``'s
names ``cuda:0`` eight times."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from keystone_tpu.parallel import collectives as jcoll
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch.parallel import collectives as coll
from keystone_tpu_torch.parallel import mesh as tmesh
from keystone_tpu_torch.parallel.collectives import P, Sharded, shard_tensor

CPU = torch.device("cpu")


def _port_mesh(shape=(8,), axes=("data",)):
    return tmesh.make_mesh(shape, axes, devices=[CPU] * 8)


def _jax_mesh(shape=(8,), axes=("data",)):
    return jmesh.make_mesh(shape, axes, devices=jax.devices()[:8])


def _local_blocks(x: np.ndarray, mesh) -> list:
    """Shard i's (rows_i) block of ``x`` for a P(all axes) row layout."""
    return [torch.from_numpy(b.copy()) for b in np.split(x, mesh.size)]


# ------------------------------------------------------------------ the mesh


def test_default_mesh_is_one_shard_on_the_visible_device():
    mesh = tmesh.make_mesh()
    assert mesh.size == tmesh.num_devices() == 1
    assert mesh.shape == {"data": 1}
    assert tmesh.row_shard_count(mesh) == 1 and tmesh.model_axis_size(mesh) == 1
    assert mesh.flat_devices == tmesh.visible_devices() == (CPU,)


def test_mesh_may_name_one_device_eight_times_like_jax_names_eight():
    mesh, jm = _port_mesh(), _jax_mesh()
    assert mesh.shape == dict(jm.shape) == {"data": 8}
    assert tmesh.row_axes(mesh) == jmesh.row_axes(jm) == ("data",)
    assert tmesh.row_shard_count(mesh) == jmesh.row_shard_count(jm) == 8
    assert mesh.shards_per_device() == {CPU: 8}
    with tmesh.use_mesh(mesh):
        assert tmesh.get_mesh() is mesh and tmesh.data_axis_size() == 8
    assert tmesh.get_mesh() is not mesh


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_2d_mesh_axes_equal_the_jax_packages(shape):
    mesh, jm = _port_mesh(shape, ("data", "model")), _jax_mesh(shape, ("data", "model"))
    assert mesh.shape == dict(jm.shape)
    assert tmesh.row_axes(mesh) == jmesh.row_axes(jm) == ("data",)
    assert tmesh.row_shard_count(mesh) == jmesh.row_shard_count(jm)
    assert tmesh.model_axis_size(mesh) == jmesh.model_axis_size(jm)


def test_model_mesh_is_cached_by_identity():
    base = _port_mesh()
    m2 = tmesh.model_mesh(base, 2)
    assert m2 is tmesh.model_mesh(base, 2)
    assert m2.shape == {"data": 4, "model": 2}
    jm = jmesh.model_mesh(_jax_mesh(), 2)
    assert m2.shape == dict(jm.shape)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.model_mesh(base, 3)


def test_make_mesh_refuses_a_card_that_is_not_there_and_a_bad_shape():
    if torch.cuda.is_available():
        missing = torch.device("cuda", torch.cuda.device_count())
    else:
        missing = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="not present"):
        tmesh.make_mesh(devices=[missing])
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh((3,), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="only 'cpu' and 'cuda'"):
        tmesh.make_mesh(devices=["meta"])


def test_memory_budget_is_per_shard():
    one, eight = tmesh.make_mesh(devices=[CPU]), _port_mesh()
    assert tmesh.device_memory_budget_bytes(mesh=one) == int(4e9 * 0.75)
    assert tmesh.device_memory_budget_bytes(mesh=eight) == int(4e9 * 0.75) // 8


# ----------------------------------------------- collectives against lax


def _jax_run(body, jm, in_spec, out_spec, x):
    fn = jcoll.shard_map(body, mesh=jm, in_specs=in_spec, out_specs=out_spec)
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


CASES_1D = {
    "allreduce_sum": (lambda x: lax.psum(x, "data"), lambda xs, m: coll.allreduce_sum(xs, m, "data")),
    "all_gather": (
        lambda x: lax.all_gather(x, "data").reshape(-1, x.shape[-1]),
        lambda xs, m: [t.reshape(-1, t.shape[-1]) for t in coll.all_gather(xs, m, "data")],
    ),
    "all_gather_tiled": (
        lambda x: lax.all_gather(x, "data", tiled=True),
        lambda xs, m: coll.all_gather(xs, m, "data", tiled=True),
    ),
    "ring_permute": (
        lambda x: jcoll.ring_permute(x, "data", shift=3),
        lambda xs, m: coll.ring_permute(xs, m, "data", shift=3),
    ),
    "reduce_scatter": (
        lambda x: jcoll.reduce_scatter(x, "data"),
        lambda xs, m: coll.reduce_scatter(xs, m, "data"),
    ),
    "all_to_all": (
        lambda x: jcoll.all_to_all(x, "data", split_axis=0, concat_axis=1),
        lambda xs, m: coll.all_to_all(xs, m, "data", split_axis=0, concat_axis=1),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES_1D))
def test_collective_equals_lax_on_8_shards(name):
    jbody, tbody = CASES_1D[name]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 16)).astype(np.float32)  # 8 rows per shard
    mesh, jm = _port_mesh(), _jax_mesh()
    want = _jax_run(jbody, jm, JP("data"), JP("data"), x)
    got = torch.cat(tbody(_local_blocks(x, mesh), mesh)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model")])
@pytest.mark.parametrize("name", ["allreduce_sum", "all_to_all", "ring_permute", "reduce_scatter"])
def test_collective_over_one_axis_of_a_2d_mesh_equals_lax(axis, name):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    mesh, jm = _port_mesh((4, 2), ("data", "model")), _jax_mesh((4, 2), ("data", "model"))
    jbodies = {
        "allreduce_sum": lambda v: lax.psum(v, axis),
        "all_to_all": lambda v: lax.all_to_all(v, axis, 0, 1, tiled=True),
        "ring_permute": lambda v: jcoll.ring_permute(v, axis, shift=1),
        "reduce_scatter": lambda v: lax.psum_scatter(v, axis, scatter_dimension=0, tiled=True),
    }
    tbodies = {
        "allreduce_sum": lambda xs: coll.allreduce_sum(xs, mesh, axis),
        "all_to_all": lambda xs: coll.all_to_all(xs, mesh, axis, split_axis=0, concat_axis=1),
        "ring_permute": lambda xs: coll.ring_permute(xs, mesh, axis, shift=1),
        "reduce_scatter": lambda xs: coll.reduce_scatter(xs, mesh, axis),
    }
    spec = JP(("data", "model"))
    want = _jax_run(jbodies[name], jm, spec, spec, x)
    got = torch.cat(tbodies[name](_local_blocks(x, mesh))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model")])
def test_axis_index_equals_lax(axis):
    mesh, jm = _port_mesh((4, 2), ("data", "model")), _jax_mesh((4, 2), ("data", "model"))
    spec = JP(("data", "model"))
    want = _jax_run(lambda v: v + jmesh_axis_index(axis), jm, spec, spec, np.zeros((8, 1), np.float32))
    assert coll.axis_index(mesh, axis) == [int(v) for v in want.ravel()]


def jmesh_axis_index(axis):
    if isinstance(axis, str):
        return lax.axis_index(axis).astype(jnp.float32)
    idx = jnp.int32(0)
    for name in axis:
        idx = idx * lax.axis_size(name) + lax.axis_index(name)
    return idx.astype(jnp.float32)


# ------------------------------------------------------- the port's contract


def test_allreduce_sums_in_shard_order_and_hands_every_shard_one_result():
    rng = np.random.default_rng(9)
    mesh = _port_mesh()
    xs = [torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)) for _ in range(8)]
    before = coll.calls["allreduce_sum"]
    out = coll.allreduce_sum(xs, mesh)
    assert coll.calls["allreduce_sum"] == before + 1
    sequential = functools.reduce(lambda a, b: a + b, xs)
    assert torch.equal(out[0], sequential)  # bit for bit: 0 + 1 + … + 7
    assert all(o is out[0] for o in out)  # one device: one shared result


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "count"])
def test_collectives_refuse_mismatched_shards(bad):
    mesh = _port_mesh()
    xs = [torch.zeros(4, 2) for _ in range(8)]
    if bad == "shape":
        xs[3] = torch.zeros(5, 2)
    elif bad == "dtype":
        xs[3] = torch.zeros(4, 2, dtype=torch.float64)
    elif bad == "device":
        xs[3] = torch.zeros(4, 2, device="meta")
    else:
        xs = xs[:7]
    for fn in (coll.allreduce_sum, coll.all_gather, coll.ring_permute, coll.reduce_scatter, coll.all_to_all):
        with pytest.raises(ValueError):
            fn(xs, mesh)


def test_shards_are_views_and_assemble_round_trips():
    mesh = _port_mesh((4, 2), ("data", "model"))
    a = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    rows = shard_tensor(a, mesh, P("data"))
    tiles = shard_tensor(a, mesh, P("data", "model"))
    assert all(s.untyped_storage().data_ptr() == a.untyped_storage().data_ptr() for s in tiles.shards)
    assert rows.shards[1] is not rows.shards[0] and torch.equal(rows.shards[0], rows.shards[1])
    assert tuple(tiles.shards[0].shape) == (2, 3)
    assert torch.equal(tiles.assemble(), a) and torch.equal(rows.assemble(), a)
    fine = shard_tensor(a, mesh, P(("data", "model")))
    assert tuple(fine.shards[0].shape) == (1, 6) and torch.equal(fine.assemble(), a)
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor(torch.zeros(6, 2), mesh, P(("data", "model")))


def test_shard_map_and_replicated_equal_jax():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    mesh, jm = _port_mesh(), _jax_mesh()
    got = coll.shard_map(lambda v: v * 2 + 1, mesh, P("data"), P("data"))(torch.from_numpy(x))
    want = jcoll.shard_map(lambda v: v * 2 + 1, mesh=jm, in_specs=JP("data"), out_specs=JP("data"))(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)
    summed = coll.shard_map(lambda v: v.sum(dim=0), mesh, P("data"), P("data"))(torch.from_numpy(x))
    assert tuple(summed.shape) == (32,)
    rep = coll.replicated(mesh, {"w": torch.ones(3)})
    assert isinstance(rep["w"], Sharded) and len(rep["w"].shards) == 8
    assert torch.equal(rep["w"].assemble(), torch.ones(3))
