"""``mx.np.random``'s 20 distributions held to the reference's contract
(`ROADMAP.md` §3: the bits cannot match, Philox against threefry): the
same seed gives the same draws; shapes, dtypes and the parameters'
broadcasting equal the JAX package's for the same call; and at fixed
seeds the draws follow the distribution: a Kolmogorov-Smirnov test
against ``scipy.stats`` (p > 1e-3) for the continuous ones, the mean and
variance within 5 standard errors for the discrete ones.
"""
import math

import numpy as onp
import pytest
from scipy import stats

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

F = "float32"
MEAN2 = onp.array([1.0, -2.0], F)
COV2 = onp.array([[2.0, 0.6], [0.6, 1.0]], F)
PV = onp.array([0.2, 0.3, 0.5], F)

# (name, args, kwargs) calls whose shape and dtype must be the reference's
CALLS = [
    ("beta", (onp.ones((2, 1), F), onp.full(3, 2.0, F)), {}),
    ("gamma", (onp.ones((2, 3), F) * 2,), {}),
    ("gamma", (2.0, onp.ones((4, 3), F)), dict(size=3)),
    ("exponential", (onp.ones((2, 3), F),), {}),
    ("chisquare", (3.0,), dict(size=(2, 3))),
    ("multinomial", (5, PV), dict(size=(2,))),
    ("laplace", (onp.zeros((2, 1), F), onp.ones(3, F)), {}),
    ("logistic", (1.0, 2.0), dict(size=(2, 2))),
    ("lognormal", (), dict(size=3)),
    ("pareto", (2.0,), dict(size=3)),
    ("power", (2.0,), dict(size=3)),
    ("rayleigh", (), dict(size=3)),
    ("weibull", (2.0,), dict(size=3)),
    ("gumbel", (), dict(size=3)),
    ("multivariate_normal", (MEAN2, COV2), {}),
    ("binomial", (onp.full((2,), 5, F), 0.5), {}),
    ("poisson", (onp.ones((2, 3), F),), {}),
    ("geometric", (0.3,), dict(size=3)),
    ("negative_binomial", (3, 0.4), dict(size=3)),
    ("f", (3.0, 4.0), dict(size=3)),
    ("dirichlet", (onp.ones(3, F),), dict(size=2)),
]


def _nd(mx, v):
    return mx.np.array(v) if isinstance(v, onp.ndarray) else v


@pytest.mark.parametrize("i", range(len(CALLS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CALLS)])
def test_shape_and_dtype_are_the_references(i):
    """The reference's call traced abstractly (``jax.eval_shape``: its
    shapes and dtypes without compiling its samplers; the key source's
    state restored after)."""
    import jax

    name, args, kw = CALLS[i]
    state = jmx.random._STATE
    saved = state.key
    try:
        want = jax.eval_shape(lambda: getattr(jmx.np.random, name)(
            *[_nd(jmx, a) for a in args], **kw)._data)
    finally:
        state.key = saved
    with tmx.cpu():
        got = getattr(tmx.np.random, name)(*[_nd(tmx, a) for a in args],
                                           **kw)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (name, got.shape, got.dtype, want.shape, want.dtype)


N = 20000
P = 1e-3
CONTINUOUS = {
    "beta": ((2.0, 3.0), stats.beta(2, 3)),
    "gamma": ((2.0, 1.5), stats.gamma(2, scale=1.5)),
    "exponential": ((2.0,), stats.expon(scale=2)),
    "chisquare": ((3.0,), stats.chi2(3)),
    "laplace": ((1.0, 2.0), stats.laplace(1, 2)),
    "logistic": ((1.0, 2.0), stats.logistic(1, 2)),
    "lognormal": ((0.5, 0.7), stats.lognorm(0.7, scale=math.exp(0.5))),
    "pareto": ((3.0,), stats.lomax(3)),
    "power": ((2.5,), stats.powerlaw(2.5)),
    "rayleigh": ((2.0,), stats.rayleigh(scale=2)),
    "weibull": ((1.5,), stats.weibull_min(1.5)),
    "gumbel": ((1.0, 2.0), stats.gumbel_r(1, 2)),
    "f": ((3.0, 7.0), stats.f(3, 7)),
}
DISCRETE = {  # args, (mean, variance)
    "binomial": ((10, 0.3), (3.0, 2.1)),
    "poisson": ((3.5,), (3.5, 3.5)),
    "geometric": ((0.3,), (1 / 0.3, 0.7 / 0.09)),
    "negative_binomial": ((3, 0.4), (3 * 0.6 / 0.4, 3 * 0.6 / 0.16)),
}


def _draw(name, args, seed, n=N):
    with tmx.cpu():
        tmx.np.random.seed(seed)
        return getattr(tmx.np.random, name)(*args, size=n).asnumpy()


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_draws_follow_the_distribution(name):
    args, dist = CONTINUOUS[name]
    x = _draw(name, args, 11)
    assert onp.isfinite(x).all()
    assert stats.kstest(x.astype("float64"), dist.cdf).pvalue > P
    onp.testing.assert_array_equal(x, _draw(name, args, 11))
    assert not onp.array_equal(x, _draw(name, args, 12))


@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_discrete_draws_have_the_moments(name):
    args, (mean, var) = DISCRETE[name]
    x = _draw(name, args, 13).astype("float64")
    assert (x == onp.round(x)).all() and x.min() >= 0
    assert abs(x.mean() - mean) < 5 * math.sqrt(var / N)
    # the sample variance's standard error, from the fourth moment
    m4 = ((x - x.mean()) ** 4).mean()
    assert abs(x.var() - var) < 5 * math.sqrt((m4 - var * var) / N)
    onp.testing.assert_array_equal(x, _draw(name, args, 13))


def test_multinomial_multivariate_normal_and_dirichlet_follow_theirs():
    with tmx.cpu():
        tmx.np.random.seed(21)
        c = tmx.np.random.multinomial(10, PV, size=N).asnumpy()
        mvn = tmx.np.random.multivariate_normal(
            tmx.np.array(MEAN2), tmx.np.array(COV2), size=N).asnumpy()
        d = tmx.np.random.dirichlet(tmx.np.array([1.0, 2.0, 3.0]),
                                    size=N).asnumpy()
    assert (c.sum(1) == 10).all()
    se = onp.sqrt(10 * PV * (1 - PV) / N)
    assert (onp.abs(c.mean(0) - 10 * PV) < 5 * se).all()
    assert (onp.abs(mvn.mean(0) - MEAN2) < 5 * onp.sqrt(onp.diag(COV2) / N)
            ).all()
    onp.testing.assert_allclose(onp.cov(mvn.T), COV2, atol=0.06)
    assert stats.kstest(mvn[:, 0], stats.norm(1.0, math.sqrt(2)).cdf
                        ).pvalue > P
    onp.testing.assert_allclose(d.sum(1), 1.0, rtol=1e-5)
    assert stats.kstest(d[:, 2].astype("float64"), stats.beta(3, 3).cdf
                        ).pvalue > P


def test_parameters_broadcast_per_element():
    """An array of parameters draws per element, each from its own
    distribution."""
    with tmx.cpu():
        tmx.np.random.seed(5)
        lam = tmx.np.array(onp.array([[1.0], [50.0]], F))
        x = tmx.np.random.poisson(lam, size=(2, 4000)).asnumpy()
        g = tmx.np.random.gamma(tmx.np.array([1.0, 9.0]), 2.0,
                                size=(4000, 2)).asnumpy()
    assert abs(x[0].mean() - 1) < 0.1 and abs(x[1].mean() - 50) < 1.2
    assert abs(g[:, 0].mean() - 2) < 0.2 and abs(g[:, 1].mean() - 18) < 0.6


def test_draws_land_on_the_parameters_device_and_the_key_source_advances():
    with tmx.cpu():
        tmx.np.random.seed(3)
        a = tmx.np.random.beta(2.0, 2.0, size=4)
        b = tmx.np.random.beta(2.0, 2.0, size=4)
        assert a.device == tmx.cpu()
        assert not onp.array_equal(a.asnumpy(), b.asnumpy())
        tmx.np.random.seed(3)
        onp.testing.assert_array_equal(
            tmx.np.random.beta(2.0, 2.0, size=4).asnumpy(), a.asnumpy())
