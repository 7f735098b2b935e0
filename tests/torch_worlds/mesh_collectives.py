"""Cases of `test_torch_mesh_collectives.py`, run by each rank of a
4-rank gloo world (`world.py`): every collective of the port on a 1-D
mesh of 4 ranks, and over the axes of a (2, 2) mesh, on the blocks of
global arrays made from a seed, so the test can hold them against the
JAX package's `shard_map` over 4 devices."""
import numpy as onp
import torch

from incubator_mxnet_tpu_torch import parallel
from incubator_mxnet_tpu_torch.parallel import collectives as C


def inputs():
    """The global arrays, (4 * 2, 6) each: int32 and float32."""
    r = onp.random.RandomState(11)
    return {"i": r.randint(-50, 50, (8, 6)).astype("int32"),
            "f": r.normal(size=(8, 6)).astype("float32"),
            "a2a": r.randint(-50, 50, (8, 8)).astype("int32")}


def block(a, rank, n=4):
    c = a.shape[0] // n
    return torch.from_numpy(a[rank * c:(rank + 1) * c].copy())


def run(rank, n):
    x = inputs()
    out = {}
    mesh = parallel.make_mesh({"x": 4})
    with parallel.mesh_scope(mesh):
        for kind in ("i", "f"):
            b = block(x[kind], rank)
            for op in ("sum", "max", "min"):
                out[f"all_reduce_{op}_{kind}"] = C.all_reduce(b, "x", op)
            out[f"all_gather0_{kind}"] = C.all_gather(b, "x", axis=0)
            out[f"all_gather1_{kind}"] = C.all_gather(b, "x", axis=1)
            out[f"all_gather_stack_{kind}"] = C.all_gather(b, "x", axis=0,
                                                           tiled=False)
            out[f"reduce_scatter1_{kind}"] = C.reduce_scatter(
                b[:, :4].contiguous(), "x", axis=1)
            out[f"broadcast_{kind}"] = C.broadcast(b, "x", src=2)
            for s in (1, 2, -1):
                out[f"ring_permute{s}_{kind}"] = C.ring_permute(b, "x", s)
        out["all_reduce_mean_f"] = C.all_reduce(block(x["f"], rank), "x",
                                                "mean")
        a = block(x["a2a"], rank)
        out["all_to_all01"] = C.all_to_all(a.reshape(4, 4), "x", 0, 1)
        out["all_to_all10"] = C.all_to_all(a.reshape(4, 4), "x", 1, 0)
        out["axis_size"] = C.axis_size("x")
        # gradients: all_gather's is reduce_scatter's, ring_permute's the
        # inverse shift
        f = block(x["f"], rank).requires_grad_(True)
        w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
        (C.all_gather(f, "x", axis=0) * w).sum().backward()
        out["grad_all_gather"] = f.grad.clone()
        f.grad = None
        (C.ring_permute(f, "x", 1) * w[:2]).sum().backward()
        out["grad_ring_permute"] = f.grad.clone()
    mesh2 = parallel.make_mesh({"dp": 2, "tp": 2})
    # npx.sharding_constraint: this rank's block of the dims the spec cuts
    # (axes the mesh lacks dropped; a laid-out axis left alone); its
    # gradient gathered back
    from incubator_mxnet_tpu_torch import npx
    from incubator_mxnet_tpu_torch.parallel import _layout

    a = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    out["constraint_none"] = npx.sharding_constraint(a, ("dp", "tp", None))
    with parallel.mesh_scope(mesh2):
        out["constraint"] = npx.sharding_constraint(a, ("dp", "tp", "sp"))
        with _layout.laid_out("dp"):
            g = a.clone().requires_grad_()
            c = npx.sharding_constraint(g, (("dp",), "tp"))
            (c * c).sum().backward()
        out["constraint_laid_out"] = c.detach()
        out["constraint_grad"] = g.grad
    with parallel.mesh_scope(mesh2):
        b = block(x["i"], rank)
        out["dp_tp_coord"] = (mesh2.coordinate("dp"), mesh2.coordinate("tp"))
        out["sum_tp"] = C.all_reduce(b, "tp")
        out["sum_dp"] = C.all_reduce(b, "dp")
        out["gather_tp"] = C.all_gather(b, "tp", axis=0)
    return out
