"""`mx.np.random` (port of `incubator_mxnet_tpu/numpy/random.py`).

Every draw takes a fresh key from the framework's key source
(`random.next_key`, re-seeded by ``mx.np.random.seed``) and draws from a
torch generator on the target device seeded with it. So the same seed
gives the same draws; the bits are not the reference's (threefry), an
accepted divergence (`ROADMAP.md` §3). The distributions draw with
torch's samplers where one takes a generator (``_standard_gamma``,
``poisson``, ``binomial``, ``multinomial``, ``exponential_``) and by
inverse-CDF transforms of uniform draws otherwise; shapes, dtypes and
the parameters' broadcasting are the reference's (float32 draws, int32
counts, binomial's float32).
"""
from __future__ import annotations

import torch

from .. import _tnp
from ..base import canonical_dtype
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


def _param(x, dev):
    """A distribution parameter as a float32 tensor on ``dev``."""
    v = _val(x)
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(_tnp._arr(v, dev), dtype=torch.float32,
                           device=dev)


def _draw_shape(size, *params):
    """``size``, or the broadcast of the parameters' shapes without it."""
    return _shape(size) if size is not None else _bshape(None, *params)


def _out_shape(size, *params):
    """The reference's output shape: the draw of ``size`` broadcast with
    the parameter tensors it is scaled and shifted by."""
    return tuple(torch.broadcast_shapes(_shape(size),
                                        *[tuple(p.shape) for p in params]))


def _uniform_open(shape, gen, dev):
    """Uniform draws in (0, 1): never 0 (a 0 becomes float32's smallest
    normal), and below 1 as ``torch.rand``'s are, so logs stay finite."""
    u = torch.rand(shape, generator=gen, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    return u.clamp_min(tiny)


def _standard_gamma(alpha, shape, gen):
    return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                 generator=gen)


def beta(a, b, size=None):
    dev = _device(a, b)
    a, b = _param(a, dev), _param(b, dev)
    shape = _draw_shape(size, a, b)
    g = _gen(dev)
    ga, gb = _standard_gamma(a, shape, g), _standard_gamma(b, shape, g)
    return NDArray(ga / (ga + gb))


def gamma(shape, scale=1.0, size=None):
    """Gamma(shape, scale): a standard gamma draw of ``size`` (shape's
    shape without it) times ``scale``."""
    dev = _device(shape, scale)
    k = _param(shape, dev)
    draw = _standard_gamma(k, _draw_shape(size, k), _gen(dev))
    return NDArray(draw * _param(scale, dev))


def exponential(scale=1.0, size=None):
    dev = _device(scale)
    sc = _param(scale, dev)
    e = torch.empty(_out_shape(size, sc), device=dev).exponential_(
        1.0, generator=_gen(dev))
    return NDArray(e * sc)


def chisquare(df, size=None):
    dev = _device(df)
    k = _param(df, dev)
    return NDArray(2.0 * _standard_gamma(k / 2.0, _draw_shape(size, k),
                                         _gen(dev)))


def multinomial(n, pvals, size=None):
    """Counts of ``n`` draws over the categories of ``pvals`` (the last
    axis), int32: shape ``size + pvals.shape``."""
    pv = _tnp._arr(_val(pvals)).float()
    dev = pv.device
    k = pv.shape[-1]
    lead = _shape(size) + tuple(pv.shape[:-1])
    rows = torch.broadcast_to(pv, lead + (k,)).reshape(-1, k)
    draws = torch.multinomial(rows, int(n), replacement=True,
                              generator=_gen(dev))
    counts = torch.zeros(rows.shape, dtype=torch.int32, device=dev)
    counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.int32))
    return NDArray(counts.reshape(lead + (k,)))


def _loc_scale(name, standard, loc, scale, size):
    dev = _device(loc, scale)
    lo, sc = _param(loc, dev), _param(scale, dev)
    u = standard(_out_shape(size, lo, sc), _gen(dev), dev)
    return NDArray(u * sc + lo)


def _std_laplace(shape, gen, dev):
    """The inverse CDF on an open uniform u: ``log(2u)`` below 1/2,
    ``-log(2(1 - u))`` above (finite at both ends)."""
    u = _uniform_open(shape, gen, dev)
    return torch.where(u < 0.5, torch.log(2 * u), -torch.log(2 * (1 - u)))


def _std_logistic(shape, gen, dev):
    u = _uniform_open(shape, gen, dev)
    return torch.log(u) - torch.log1p(-u)


def _std_gumbel(shape, gen, dev):
    return -torch.log(-torch.log(_uniform_open(shape, gen, dev)))


def laplace(loc=0.0, scale=1.0, size=None):
    return _loc_scale("laplace", _std_laplace, loc, scale, size)


def logistic(loc=0.0, scale=1.0, size=None):
    return _loc_scale("logistic", _std_logistic, loc, scale, size)


def gumbel(loc=0.0, scale=1.0, size=None):
    return _loc_scale("gumbel", _std_gumbel, loc, scale, size)


def lognormal(mean=0.0, sigma=1.0, size=None):
    dev = _device(mean, sigma)
    m, sg = _param(mean, dev), _param(sigma, dev)
    z = torch.randn(_out_shape(size, m, sg), generator=_gen(dev), device=dev)
    return NDArray(torch.exp(z * sg + m))


def pareto(a, size=None):
    """numpy's Pareto, the Lomax (Pareto II) on [0, inf): ``exp(E / a) -
    1`` with E a standard exponential draw."""
    dev = _device(a)
    al = _param(a, dev)
    e = torch.empty(_draw_shape(size, al), device=dev).exponential_(
        1.0, generator=_gen(dev))
    return NDArray(torch.expm1(e / al))


def power(a, size=None):
    dev = _device(a)
    al = _param(a, dev)
    u = torch.rand(_out_shape(size, al), generator=_gen(dev), device=dev)
    return NDArray(torch.pow(u, 1.0 / al))


def rayleigh(scale=1.0, size=None):
    dev = _device(scale)
    sc = _param(scale, dev)
    u = _uniform_open(_out_shape(size, sc), _gen(dev), dev)
    return NDArray(torch.sqrt(-2.0 * torch.log(u)) * sc)


def weibull(a, size=None):
    dev = _device(a)
    al = _param(a, dev)
    u = _uniform_open(_out_shape(size, al), _gen(dev), dev)
    return NDArray(torch.pow(-torch.log(u), 1.0 / al))


def multivariate_normal(mean, cov, size=None):
    """``mean + L z`` with L the Cholesky factor of ``cov``: shape
    ``size + mean.shape[-1:]`` (the parameters' batch shape without
    ``size``)."""
    dev = _device(mean, cov)
    m, c = _param(mean, dev), _param(cov, dev)
    n = m.shape[-1]
    batch = _shape(size) if size is not None else tuple(
        torch.broadcast_shapes(tuple(m.shape[:-1]), tuple(c.shape[:-2])))
    chol = torch.linalg.cholesky_ex((c + c.mT) / 2).L
    z = torch.randn(batch + (n,), generator=_gen(dev), device=dev)
    return NDArray(m + (chol @ z.unsqueeze(-1)).squeeze(-1))


def binomial(n, p, size=None):
    """Float32 counts, as the reference's (``jax.random.binomial``)."""
    dev = _device(n, p)
    cn, pr = _param(n, dev), _param(p, dev)
    shape = _draw_shape(size, cn, pr)
    return NDArray(torch.binomial(cn.expand(shape).contiguous(),
                                  pr.expand(shape).contiguous(),
                                  generator=_gen(dev)))


def _poisson(rate, gen):
    return torch.poisson(rate.contiguous(), generator=gen).to(torch.int32)


def poisson(lam=1.0, size=None):
    """Int32 counts (the reference's with x64 off)."""
    dev = _device(lam)
    lm = _param(lam, dev)
    return NDArray(_poisson(lm.expand(_draw_shape(size, lm)), _gen(dev)))


def geometric(p, size=None):
    """Trials to the first success (support 1, 2, ...), int32: the
    inverse CDF ``floor(log U / log(1 - p)) + 1``."""
    dev = _device(p)
    pr = _param(p, dev)
    u = _uniform_open(_draw_shape(size, pr), _gen(dev), dev)
    return NDArray((torch.floor(torch.log(u) / torch.log1p(-pr)) + 1)
                   .to(torch.int32))


def negative_binomial(n, p, size=None):
    """The gamma-Poisson mixture, int32: λ ~ Gamma(n, (1 - p) / p), then
    Poisson(λ) (two keys, as the reference draws)."""
    dev = _device(n, p)
    cn, pr = _param(n, dev), _param(p, dev)
    g = _standard_gamma(cn, _draw_shape(size, cn), _gen(dev))
    rate = g * (1.0 - pr) / pr
    return NDArray(_poisson(rate, _gen(dev)))


def f(dfnum, dfden, size=None):
    n1 = chisquare(dfnum, size)._data / _param(dfnum, _device(dfnum))
    n2 = chisquare(dfden, size)._data / _param(dfden, _device(dfden))
    return NDArray(n1 / n2.to(n1.device))


def dirichlet(alpha, size=None):
    """Draws of shape ``size + alpha.shape`` on the simplex (normalised
    gamma draws, as the reference's)."""
    dev = _device(alpha)
    a = _param(alpha, dev)
    shape = _shape(size) + tuple(a.shape)
    g = _standard_gamma(a, shape, _gen(dev))
    return NDArray(g / g.sum(dim=-1, keepdim=True))
