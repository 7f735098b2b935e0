"""The port's mesh and collectives (`parallel.mesh`, `parallel.collectives`)
against the JAX package's.

`make_mesh`'s rules are cases of both packages: the port counts ranks
(``devices=`` takes them) where the reference counts devices. The
collectives run in one 4-rank gloo world on the CPU (`torch_worlds/`,
one module-scoped fixture) on the blocks of global arrays made from a
seed, and are held against `shard_map` of the JAX package's collectives
over 4 of the 8 virtual CPU devices: exact for the int32 payloads,
within 1e-6 for float32 (the reduction orders may differ). Two
gradients, all_gather's (reduce_scatter) and ring_permute's (the inverse
shift), are held against `jax.grad` of the same shard_map.
"""
import os
import sys
from functools import partial

import numpy as onp
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from incubator_mxnet_tpu.parallel import collectives as JC
from incubator_mxnet_tpu.parallel import make_mesh as jax_make_mesh
from incubator_mxnet_tpu_torch import parallel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_worlds import world  # noqa: E402
from torch_worlds.mesh_collectives import inputs  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
X = inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.spawn(os.path.join(HERE, "torch_worlds",
                                    "mesh_collectives.py"), 4,
                       tmp_path_factory.mktemp("mesh_world"))


def _jmesh(names=("x",), shape=(4,)):
    return Mesh(onp.array(jax.devices()[:4]).reshape(shape), names)


def _sm(fn, n_in=1, out=P("x")):
    return jax.jit(shard_map(fn, mesh=_jmesh(), in_specs=(P("x"),) * n_in,
                             out_specs=out))


def _cat(ranks, key, axis=0):
    return onp.concatenate([onp.asarray(r[key]) for r in ranks], axis=axis)


def _check(got, want, kind):
    if kind == "i":
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- make_mesh's rules, in both packages --------------------------------------
MESH_CASES = [
    ({"dp": 2, "tp": 4}, {"dp": 2, "tp": 4}),
    ({"dp": -1}, {"dp": 8}),
    ([("a", 2), ("b", -1)], {"a": 2, "b": 4}),
]
MESH_ERRORS = [
    ({"dp": -1, "tp": 3}, "wildcard axis 'dp'.*divisible"),
    ({"dp": -1, "tp": -1}, "at most one -1"),
    ([("dp", 2), ("dp", 4)], "unique.*dp"),
    ({"dp": 3}, "needs 3 devices, have 8"),
]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("axes,shape", MESH_CASES)
def test_make_mesh_shapes(pkg, axes, shape):
    if pkg == "jax":
        mesh = jax_make_mesh(axes)
        got = dict(mesh.shape)
    else:
        mesh = parallel.make_mesh(axes, devices=list(range(8)))
        got = mesh.shape
        assert mesh.devices.size == 8
        assert sorted(mesh.devices.ravel().tolist()) == list(range(8))
    assert got == shape


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("axes,match", MESH_ERRORS)
def test_make_mesh_errors(pkg, axes, match):
    with pytest.raises(ValueError, match=match):
        if pkg == "jax":
            jax_make_mesh(axes)
        else:
            parallel.make_mesh(axes, devices=list(range(8)))


def test_no_world_is_a_world_of_one():
    """With no initialised world the default mesh is one rank, its
    collectives the identity, and `mesh_scope`/`current_mesh` nest."""
    import torch

    mesh = parallel.make_mesh({"dp": 1, "tp": 1})
    assert mesh.shape == {"dp": 1, "tp": 1} and parallel.current_mesh() is None
    x = torch.arange(6.0).reshape(2, 3)
    with parallel.mesh_scope(mesh):
        assert parallel.current_mesh() is mesh
        for y in (parallel.all_reduce(x, "tp"), parallel.all_gather(x, "dp"),
                  parallel.ring_permute(x, "tp"),
                  parallel.reduce_scatter(x, "dp"),
                  parallel.broadcast(x, "tp")):
            assert torch.equal(y, x)
    assert parallel.current_mesh() is None
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        parallel.make_mesh({"dp": 4})


# -- the collectives in a 4-rank world ----------------------------------------
def _ref(name, kind):
    v = jnp.asarray(X[kind])
    if name.startswith("all_reduce_"):
        op = name.split("_")[2]
        return _sm(partial(JC.all_reduce, axis_name="x", op=op))(v)
    if name == "all_gather0":
        return _sm(partial(JC.all_gather, axis_name="x", axis=0))(v)
    if name == "all_gather1":
        return _sm(partial(JC.all_gather, axis_name="x", axis=1))(v)
    if name == "all_gather_stack":
        return _sm(partial(JC.all_gather, axis_name="x", axis=0,
                           tiled=False))(v)
    if name == "reduce_scatter1":
        return _sm(partial(JC.reduce_scatter, axis_name="x", axis=1))(
            v[:, :4])
    if name == "broadcast":
        return _sm(partial(JC.broadcast, axis_name="x", src=2))(v)
    if name.startswith("ring_permute"):
        s = int(name[len("ring_permute"):])
        return _sm(partial(JC.ring_permute, axis_name="x", shift=s))(v)
    raise KeyError(name)


NAMES = (["all_reduce_sum", "all_reduce_max", "all_reduce_min",
          "all_gather0", "all_gather1", "all_gather_stack",
          "reduce_scatter1", "broadcast"]
         + [f"ring_permute{s}" for s in (1, 2, -1)])


@pytest.mark.parametrize("kind", ["i", "f"])
@pytest.mark.parametrize("name", NAMES)
def test_collective_matches_shard_map(ranks, name, kind):
    want = onp.asarray(_ref(name, kind))
    got = _cat(ranks, f"{name}_{kind}")
    assert got.shape == want.shape
    _check(got, want, kind)


def test_all_reduce_mean(ranks):
    want = _sm(partial(JC.all_reduce, axis_name="x", op="mean"))(
        jnp.asarray(X["f"]))
    _check(_cat(ranks, "all_reduce_mean_f"), onp.asarray(want), "f")


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0)])
def test_all_to_all(ranks, split, concat):
    v = jnp.asarray(X["a2a"]).reshape(16, 4)
    f = _sm(lambda b: JC.all_to_all(b, "x", split_axis=split,
                                    concat_axis=concat))
    want = onp.asarray(f(v))
    got = _cat(ranks, f"all_to_all{split}{concat}", axis=0)
    _check(got.reshape(want.shape), want, "i")


def test_axis_size_and_sub_axes(ranks):
    assert all(r["axis_size"] == 4 for r in ranks)
    coords = [r["dp_tp_coord"] for r in ranks]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    mesh = _jmesh(("dp", "tp"), (2, 2))
    v = jnp.asarray(X["i"])
    for axis in ("tp", "dp"):
        want = jax.jit(shard_map(partial(JC.all_reduce, axis_name=axis),
                                 mesh=mesh, in_specs=P(("dp", "tp")),
                                 out_specs=P(("dp", "tp"))))(v)
        onp.testing.assert_array_equal(_cat(ranks, f"sum_{axis}"),
                                       onp.asarray(want))
    want = jax.jit(shard_map(partial(JC.all_gather, axis_name="tp"),
                             mesh=mesh, in_specs=P(("dp", "tp")),
                             out_specs=P(("dp", "tp"))))(v)
    onp.testing.assert_array_equal(_cat(ranks, "gather_tp"),
                                   onp.asarray(want))


@pytest.mark.parametrize("name", ["all_gather", "ring_permute"])
def test_collective_gradients(ranks, name):
    w = jnp.arange(8 * 6, dtype=jnp.float32).reshape(8, 6)
    v = jnp.asarray(X["f"])
    mesh = _jmesh()
    if name == "all_gather":
        def loss(b):
            return (JC.all_gather(b, "x", axis=0) * w).sum()
    else:
        def loss(b):
            i = jax.lax.axis_index("x")
            wb = jax.lax.dynamic_slice_in_dim(w, 0, 2, 0) + 0 * i
            return (JC.ring_permute(b, "x", 1) * wb).sum()
    g = jax.jit(shard_map(jax.grad(loss), mesh=mesh, in_specs=P("x"),
                          out_specs=P("x")))(v)
    onp.testing.assert_allclose(_cat(ranks, f"grad_{name}"), onp.asarray(g),
                                rtol=1e-6, atol=1e-6)


def test_sharding_constraint_lays_the_activation_out(ranks):
    """`npx.sharding_constraint` (reference `numpy_extension/__init__.py:
    937`): the identity with no active mesh; on a (dp 2, tp 2) mesh this
    rank's block of each dimension the spec cuts, an axis the mesh lacks
    ("sp") dropped, an axis the step is already local along (a
    `DataParallel` step's batch axis) left alone; the gradient is
    gathered back whole, the same on the ranks that share the block."""
    import torch

    a = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    for r, got in enumerate(ranks):
        dp, tp = divmod(r, 2)
        assert torch.equal(got["constraint_none"], a)
        assert torch.equal(got["constraint"],
                           a[dp * 2:dp * 2 + 2, tp * 3:tp * 3 + 3])
        assert torch.equal(got["constraint_laid_out"],
                           a[:, tp * 3:tp * 3 + 3])
        want = torch.zeros_like(a)
        for t in range(2):
            want[:, t * 3:t * 3 + 3] = 2 * a[:, t * 3:t * 3 + 3]
        assert torch.equal(got["constraint_grad"], want)


def test_workers_import_no_jax(ranks):
    assert all(r["forbidden"] == [] for r in ranks)
