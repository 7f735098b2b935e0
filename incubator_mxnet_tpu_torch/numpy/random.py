"""`mx.np.random` (port of `incubator_mxnet_tpu/numpy/random.py`).

Every draw takes a fresh key from the framework's key source
(`random.next_key`, re-seeded by ``mx.np.random.seed``) and draws from a
torch generator on the target device seeded with it. So the same seed
gives the same draws; the bits are not the reference's (threefry), an
accepted divergence (`ROADMAP.md` §3). The distributions that are not
ported raise :class:`MXNetError`.
"""
from __future__ import annotations

import torch

from .. import _tnp
from ..base import MXNetError, canonical_dtype
from ..device import resolve_device
from ..ndarray.ndarray import NDArray
from ..random import next_key, seed  # noqa: F401  (re-export seed)

__all__ = [
    "seed", "uniform", "normal", "randn", "rand", "randint", "choice",
    "shuffle", "permutation", "beta", "gamma", "exponential", "chisquare",
    "multinomial", "laplace", "logistic", "lognormal", "pareto", "power",
    "rayleigh", "weibull", "gumbel", "multivariate_normal", "binomial",
    "poisson", "geometric", "negative_binomial", "bernoulli", "f",
    "standard_normal", "categorical", "dirichlet",
]


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _val(x):
    return x._data.detach() if isinstance(x, NDArray) else x


def _device(*vals, device=None):
    for v in vals:
        if isinstance(v, NDArray):
            return v._data.device
    return resolve_device(device)


def _gen(device):
    """A generator on ``device`` seeded from the framework's next key."""
    k0, k1 = next_key()
    g = torch.Generator(device=device)
    g.manual_seed((int(k0) << 32 | int(k1)) & ((1 << 63) - 1))
    return g


def _bshape(size, *params):
    if size is not None:
        return _shape(size)
    return tuple(torch.broadcast_shapes(*[
        tuple(_val(p).shape) if isinstance(_val(p), torch.Tensor) else ()
        for p in params]))


def uniform(low=0.0, high=1.0, size=None, dtype=None, device=None,
            ctx=None, shape=None):
    size = size if size is not None else shape  # legacy mx.nd kwarg
    dev = _device(low, high, device=device or ctx)
    dt = canonical_dtype(dtype) if dtype else torch.float32
    u = torch.rand(_bshape(size, low, high), generator=_gen(dev),
                   dtype=dt, device=dev)
    return NDArray(u * (_val(high) - _val(low)) + _val(low))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, device=None,
           ctx=None, shape=None):
    size = size if size is not None else shape  # legacy mx.nd kwarg
    dev = _device(loc, scale, device=device or ctx)
    dt = canonical_dtype(dtype) if dtype else torch.float32
    n = torch.randn(_bshape(size, loc, scale), generator=_gen(dev),
                    dtype=dt, device=dev)
    return NDArray(n * _val(scale) + _val(loc))


def standard_normal(size=None, dtype=None):
    return normal(0.0, 1.0, size=size, dtype=dtype)


def randn(*shape):
    return normal(size=shape)


def rand(*shape):
    return uniform(size=shape)


def randint(low, high=None, size=None, dtype=None):
    if high is None:
        low, high = 0, low
    dt = canonical_dtype(dtype) if dtype else torch.int32  # x64 off
    dev = _device()
    return NDArray(torch.randint(int(low), int(high), _shape(size),
                                 generator=_gen(dev), dtype=dt, device=dev))


def choice(a, size=None, replace=True, p=None):
    a_val = _val(a)
    dev = _device(a, p)
    if isinstance(a_val, int):
        a_val = torch.arange(a_val, device=dev)
    else:
        a_val = _tnp._arr(a_val, dev)
    n = a_val.shape[0]
    shape = _shape(size)
    count = 1
    for s in shape:
        count *= s
    g = _gen(dev)
    if p is None and replace:
        idx = torch.randint(0, n, (count,), generator=g, device=dev)
    else:
        w = torch.ones(n, device=dev) if p is None else _tnp._arr(
            _val(p), dev).float()
        idx = torch.multinomial(w, count, replacement=replace, generator=g)
    return NDArray(a_val[idx].reshape(shape + tuple(a_val.shape[1:])))


def shuffle(x):
    """In-place row shuffle (mx.np.random.shuffle semantics): rebinds ``x``."""
    dev = x._data.device
    perm = torch.randperm(x.shape[0], generator=_gen(dev), device=dev)
    x._set_data(x._data.detach()[perm])


def permutation(x):
    if isinstance(x, int):
        dev = _device()
        return NDArray(torch.randperm(x, generator=_gen(dev), device=dev))
    v = _tnp._arr(_val(x))
    perm = torch.randperm(v.shape[0], generator=_gen(v.device),
                          device=v.device)
    return NDArray(v[perm])


def bernoulli(p, size=None):
    dev = _device(p)
    pv = _val(p)
    shape = _bshape(size, p)
    prob = torch.broadcast_to(torch.as_tensor(pv, dtype=torch.float32,
                                              device=dev), shape)
    return NDArray(torch.rand(shape, generator=_gen(dev), device=dev) < prob)


def categorical(logits, size=None, axis=-1):
    """Category indices drawn from (log-)probability rows (reference
    `_npx__random_categorical`): ``size`` draws a row, leading."""
    val = _tnp._arr(_val(logits)).float()
    val = torch.movedim(val, axis, -1)
    batch = val.shape[:-1]
    shape = _shape(size)
    count = 1
    for s in shape[:len(shape) - len(batch)] if shape else ():
        count *= s
    probs = torch.softmax(val.reshape(-1, val.shape[-1]), dim=-1)
    draws = torch.multinomial(probs, count, replacement=True,
                              generator=_gen(val.device))  # (rows, count)
    draws = draws.T.reshape(tuple(shape[:len(shape) - len(batch)]) + batch
                            if shape else batch)
    return NDArray(draws)


def _queued(name):
    return MXNetError(f"mx.np.random.{name} is not ported yet (ROADMAP.md "
                      f"§1 item 4)")


def beta(a, b, size=None):  # noqa: ARG001
    raise _queued("beta")


def gamma(shape, scale=1.0, size=None):  # noqa: ARG001
    raise _queued("gamma")


def exponential(scale=1.0, size=None):  # noqa: ARG001
    raise _queued("exponential")


def chisquare(df, size=None):  # noqa: ARG001
    raise _queued("chisquare")


def multinomial(n, pvals, size=None):  # noqa: ARG001
    raise _queued("multinomial")


def laplace(loc=0.0, scale=1.0, size=None):  # noqa: ARG001
    raise _queued("laplace")


def logistic(loc=0.0, scale=1.0, size=None):  # noqa: ARG001
    raise _queued("logistic")


def lognormal(mean=0.0, sigma=1.0, size=None):  # noqa: ARG001
    raise _queued("lognormal")


def pareto(a, size=None):  # noqa: ARG001
    raise _queued("pareto")


def power(a, size=None):  # noqa: ARG001
    raise _queued("power")


def rayleigh(scale=1.0, size=None):  # noqa: ARG001
    raise _queued("rayleigh")


def weibull(a, size=None):  # noqa: ARG001
    raise _queued("weibull")


def gumbel(loc=0.0, scale=1.0, size=None):  # noqa: ARG001
    raise _queued("gumbel")


def multivariate_normal(mean, cov, size=None):  # noqa: ARG001
    raise _queued("multivariate_normal")


def binomial(n, p, size=None):  # noqa: ARG001
    raise _queued("binomial")


def poisson(lam=1.0, size=None):  # noqa: ARG001
    raise _queued("poisson")


def geometric(p, size=None):  # noqa: ARG001
    raise _queued("geometric")


def negative_binomial(n, p, size=None):  # noqa: ARG001
    raise _queued("negative_binomial")


def f(dfnum, dfden, size=None):  # noqa: ARG001
    raise _queued("f")


def dirichlet(alpha, size=None):  # noqa: ARG001
    raise _queued("dirichlet")
