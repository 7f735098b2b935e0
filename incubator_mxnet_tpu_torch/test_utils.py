"""Test harness library (port of `incubator_mxnet_tpu/test_utils.py`):
the comparisons, the random shapes and arrays, the numeric gradient
check and the cross-device consistency check (CPU against the card).
``tpu`` is the port's `device.tpu`, the reference's accelerator
spelling for the card. The symbolic checks wait for `symbol/`
(`ROADMAP.md` §1 item 11b)."""
from __future__ import annotations

import contextlib
import os

import numpy as onp

from .base import MXNetError
from .device import cpu, current_device, tpu  # noqa: F401
from .ndarray.ndarray import NDArray

__all__ = [
    "assert_almost_equal", "almost_equal", "same", "rand_ndarray", "rand_shape_2d",
    "rand_shape_3d", "rand_shape_nd", "check_numeric_gradient", "check_consistency",
    "check_symbolic_forward", "check_symbolic_backward",
    "environment", "default_device", "default_context", "effective_dtype",
    "assert_allclose",
]


def _to_numpy(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return onp.asarray(a)


def default_device():
    return current_device()


default_context = default_device


def effective_dtype(a):
    return _to_numpy(a).dtype


def same(a, b):
    return onp.array_equal(_to_numpy(a), _to_numpy(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20, equal_nan=False):
    return onp.allclose(_to_numpy(a), _to_numpy(b), rtol=rtol, atol=atol,
                        equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b"),
                        equal_nan=False):
    """(reference: test_utils.py:656)"""
    a_np, b_np = _to_numpy(a), _to_numpy(b)
    if not onp.allclose(a_np, b_np, rtol=rtol, atol=atol, equal_nan=equal_nan):
        abs_err = onp.abs(a_np - b_np)
        with onp.errstate(divide="ignore", invalid="ignore"):
            rel = abs_err / (onp.abs(b_np) + atol)
        idx = onp.unravel_index(onp.nanargmax(rel), rel.shape)
        raise AssertionError(
            f"Arrays {names[0]} and {names[1]} not almost equal "
            f"(rtol={rtol}, atol={atol}); max rel err {onp.nanmax(rel):.3e} at "
            f"{idx}: {a_np[idx]!r} vs {b_np[idx]!r}")


assert_allclose = assert_almost_equal


def rand_shape_2d(dim0=10, dim1=10):
    return (onp.random.randint(1, dim0 + 1), onp.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (onp.random.randint(1, dim0 + 1), onp.random.randint(1, dim1 + 1),
            onp.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 device=None):  # noqa: ARG001
    if stype != "default":
        raise MXNetError("sparse storage is not ported")
    return NDArray(onp.random.uniform(-1, 1, size=shape).astype(dtype),
                   device=device)


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-4):
    """Central finite differences vs autograd (reference: test_utils.py:1044).

    `fn(*inputs)` must return a scalar-reducible NDArray; inputs are
    NDArrays with float dtype. Both the analytic backward and the numeric
    evaluations run in training mode (`autograd.record`)."""
    from . import autograd

    inputs = [x if isinstance(x, NDArray) else NDArray(x) for x in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        out = fn(*inputs)
        loss = out.sum()
    loss.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    def eval_scalar(args):
        with autograd.record():
            return float(fn(*args).sum().item())

    for i, x in enumerate(inputs):
        base = x.asnumpy().astype("float64")
        num = onp.zeros_like(base)
        flat = base.ravel()
        num_flat = num.ravel()
        dev = x.device
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = eval_scalar([NDArray(base.astype(x.dtype), device=dev)
                              if k == i else inputs[k]
                              for k in range(len(inputs))])
            flat[j] = orig - eps
            fm = eval_scalar([NDArray(base.astype(x.dtype), device=dev)
                              if k == i else inputs[k]
                              for k in range(len(inputs))])
            flat[j] = orig
            num_flat[j] = (fp - fm) / (2 * eps)
        assert_almost_equal(analytic[i], num, rtol=rtol, atol=atol,
                            names=(f"analytic[{i}]", f"numeric[{i}]"))


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-6,
                           aux_states=None, ctx=None, equal_nan=False,
                           dtype=None):  # noqa: ARG001
    raise MXNetError("check_symbolic_forward: symbol/ is not ported yet "
                     "(ROADMAP.md §1 item 11b)")


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-6, aux_states=None, grad_req="write",
                            ctx=None, equal_nan=False, dtype=None):  # noqa: ARG001
    raise MXNetError("check_symbolic_backward: symbol/ is not ported yet "
                     "(ROADMAP.md §1 item 11b)")


def check_consistency(fn, inputs, devices=None, rtol=1e-4, atol=1e-5):
    """Run `fn` on each device and require the same outputs (the
    reference's cross-device trick, test_utils.py:1491): the CPU against
    the current device by default."""
    devices = devices or [cpu(0), current_device()]
    results = []
    for dev in devices:
        dev_inputs = [x.to_device(dev) if isinstance(x, NDArray) else x
                      for x in inputs]
        out = fn(*dev_inputs)
        if isinstance(out, (list, tuple)):
            results.append([_to_numpy(o) for o in out])
        else:
            results.append([_to_numpy(out)])
    ref = results[0]
    for got, dev in zip(results[1:], devices[1:]):
        for r, g in zip(ref, got):
            assert_almost_equal(g, r, rtol=rtol, atol=atol,
                                names=(str(dev), str(devices[0])))


@contextlib.contextmanager
def environment(*args):
    """Scoped env vars (reference: test_utils.py:2359). Accepts (key, value)
    or a dict; value None removes the variable."""
    if len(args) == 1 and isinstance(args[0], dict):
        env = args[0]
    else:
        env = {args[0]: args[1]}
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
