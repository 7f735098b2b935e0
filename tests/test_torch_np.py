"""`mx.np` of the port against the JAX package's: every ported name is one
case, the same seeded numpy inputs through both, values compared at the
stated tolerance and dtypes compared exactly (x64 off on both sides).
The port runs on the CPU (``with mx.cpu():``)."""
import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

# f32 tolerance of a case unless it states its own
RTOL, ATOL = 1e-5, 1e-6

_R = onp.random.RandomState(0)
X = _R.uniform(-2, 2, (3, 4)).astype("float32")
Y = _R.uniform(-2, 2, (3, 4)).astype("float32")
POS = _R.uniform(0.5, 2, (3, 4)).astype("float32")
U = _R.uniform(-0.9, 0.9, (3, 4)).astype("float32")
I = _R.randint(1, 10, (3, 4)).astype("int32")
J = _R.randint(1, 5, (3, 4)).astype("int32")
XN = X.copy()
XN[0, 1] = onp.nan
XN[2, 3] = onp.nan
V3 = _R.uniform(-1, 1, (4, 3)).astype("float32")
W3 = _R.uniform(-1, 1, (4, 3)).astype("float32")
M45 = _R.uniform(-1, 1, (4, 5)).astype("float32")
T234 = _R.uniform(-1, 1, (2, 3, 4)).astype("float32")
VEC = _R.uniform(-1, 1, (5,)).astype("float32")
SORTED = onp.sort(_R.uniform(-2, 2, (8,))).astype("float32")
IDX = onp.array([[0, 2], [1, 3], [3, 0]], "int32")
ZEROS_PAD = onp.array([0, 0, 1, 2, 0, 3, 0], "float32")
SQ = _R.uniform(-1, 1, (4, 4)).astype("float32")
REP = onp.array([1, 2, 2, 3, 3, 3, 7, 1], "int32")


# name -> (call(np, A), options); A(x) makes the package's array of x
CASES = {}


def case(name, fn, **opts):
    CASES[name] = (fn, opts)


for _n in ("abs", "absolute", "fabs", "cbrt", "square", "exp", "expm1",
           "exp2", "sin", "cos", "tan", "arctan", "sinh", "cosh", "tanh",
           "arcsinh", "floor", "ceil", "trunc", "rint", "fix", "sign",
           "signbit", "negative", "positive", "deg2rad", "rad2deg",
           "degrees", "radians", "sinc", "real", "imag", "conj",
           "conjugate", "angle", "isnan", "isinf", "isfinite", "isposinf",
           "isneginf", "spacing", "frexp", "logical_not"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(X)))
for _n in ("sqrt", "log", "log2", "log10", "log1p", "reciprocal"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(POS)))
for _n in ("arcsin", "arccos", "arctanh"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(U)))
case("arccosh", lambda np, A: np.arccosh(A(POS + 1)))
case("around", lambda np, A: np.around(A(X), 1))
case("round", lambda np, A: np.round(A(X), 2))
case("nan_to_num", lambda np, A: np.nan_to_num(A(XN)))
for _n in ("invert", "bitwise_not"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(I)))
for _n in ("add", "subtract", "multiply", "divide", "true_divide",
           "floor_divide", "mod", "remainder", "fmod", "arctan2", "maximum",
           "minimum", "fmax", "fmin", "hypot", "copysign", "logaddexp",
           "logaddexp2", "heaviside", "nextafter", "equal", "not_equal",
           "greater", "greater_equal", "less", "less_equal", "logical_and",
           "logical_or", "logical_xor", "isclose", "array_equal",
           "allclose"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(X), A(Y)))
for _n in ("power", "float_power"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(POS), A(Y)))
for _n in ("gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
           "left_shift", "right_shift"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(I), A(J)))
case("ldexp", lambda np, A: np.ldexp(A(X), A(J)))
case("clip", lambda np, A: np.clip(A(X), -1.0, 1.0))
case("matmul", lambda np, A: np.matmul(A(X), A(M45)))
case("dot", lambda np, A: [np.dot(A(X), A(M45)), np.dot(A(VEC), A(VEC)),
                           np.dot(A(T234), A(M45))])
case("vdot", lambda np, A: np.vdot(A(X), A(Y)))
case("inner", lambda np, A: np.inner(A(X), A(Y)))
case("outer", lambda np, A: np.outer(A(VEC), A(X)))
case("tensordot", lambda np, A: np.tensordot(A(T234), A(M45), axes=1))
case("kron", lambda np, A: np.kron(A(X), A(SQ[:2, :2])))
case("cross", lambda np, A: np.cross(A(V3), A(W3)))
case("trace", lambda np, A: np.trace(A(SQ)))
case("diag", lambda np, A: [np.diag(A(SQ)), np.diag(A(VEC), 1)])
case("diagonal", lambda np, A: np.diagonal(A(T234), 0, 1, 2))
case("diagflat", lambda np, A: np.diagflat(A(VEC)))
case("tril", lambda np, A: np.tril(A(SQ), -1))
case("triu", lambda np, A: np.triu(A(SQ), 1))
case("vander", lambda np, A: np.vander(A(VEC), 3))
for _n in ("sum", "prod", "mean", "min", "max", "amin", "amax", "ptp",
           "nansum", "nanprod", "nanmean", "nanmin", "nanmax", "all", "any",
           "count_nonzero"):
    case(_n, lambda np, A, n=_n: [getattr(np, n)(A(X)),
                                  getattr(np, n)(A(X), axis=1),
                                  getattr(np, n)(A(T234), axis=(0, 2))])
case("std", lambda np, A: [np.std(A(X)), np.std(A(X), axis=0, ddof=1)])
case("var", lambda np, A: [np.var(A(X)), np.var(A(T234), axis=(1, 2))])
for _n in ("nanstd", "nanvar"):
    case(_n, lambda np, A, n=_n: [getattr(np, n)(A(XN)),
                                  getattr(np, n)(A(XN), axis=1)])
for _n in ("argmin", "argmax"):
    case(_n, lambda np, A, n=_n: [getattr(np, n)(A(X)),
                                  getattr(np, n)(A(X), axis=0)])
for _n in ("nanargmin", "nanargmax"):
    case(_n, lambda np, A, n=_n: [getattr(np, n)(A(XN)),
                                  getattr(np, n)(A(XN), axis=1)])
for _n in ("cumsum", "cumprod"):
    case(_n, lambda np, A, n=_n: [getattr(np, n)(A(X), axis=1),
                                  getattr(np, n)(A(I))])
for _n in ("nancumsum", "nancumprod"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(A(XN), axis=1))
case("average", lambda np, A: [np.average(A(X)),
                               np.average(A(X), axis=1,
                                          weights=A(POS[0]))])
for _n in ("median", "nanmedian"):
    case(_n, lambda np, A, n=_n: [getattr(np, n)(A(X)),
                                  getattr(np, n)(A(X), axis=1)])
case("quantile", lambda np, A: np.quantile(A(X), 0.3, axis=1))
case("percentile", lambda np, A: np.percentile(A(X), 30.0, axis=0))
case("nanquantile", lambda np, A: np.nanquantile(A(XN), 0.7, axis=1))
case("nanpercentile", lambda np, A: np.nanpercentile(A(XN), 70.0))
case("reshape", lambda np, A: np.reshape(A(X), (4, 3)))
case("ravel", lambda np, A: np.ravel(A(X)))
case("transpose", lambda np, A: [np.transpose(A(T234)),
                                 np.transpose(A(T234), (1, 0, 2))])
case("swapaxes", lambda np, A: np.swapaxes(A(T234), 0, 2))
case("moveaxis", lambda np, A: np.moveaxis(A(T234), 0, -1))
case("rollaxis", lambda np, A: np.rollaxis(A(T234), 2))
case("squeeze", lambda np, A: np.squeeze(A(X[None, :, None])))
case("expand_dims", lambda np, A: np.expand_dims(A(X), 1))
case("broadcast_to", lambda np, A: np.broadcast_to(A(VEC), (3, 5)))
case("concatenate", lambda np, A: [np.concatenate([A(X), A(Y)]),
                                   np.concatenate([A(X), A(Y)], axis=1),
                                   np.concatenate([A(X), A(Y)], axis=None)])
for _n in ("stack", "vstack", "hstack", "dstack", "column_stack"):
    case(_n, lambda np, A, n=_n: getattr(np, n)([A(X), A(Y)]))
case("tile", lambda np, A: np.tile(A(X), (2, 1)))
case("repeat", lambda np, A: [np.repeat(A(X), 2), np.repeat(A(X), 3,
                                                            axis=1)])
case("flip", lambda np, A: [np.flip(A(X)), np.flip(A(X), 1)])
case("flipud", lambda np, A: np.flipud(A(X)))
case("fliplr", lambda np, A: np.fliplr(A(X)))
case("roll", lambda np, A: [np.roll(A(X), 2), np.roll(A(X), -1, axis=1)])
case("rot90", lambda np, A: np.rot90(A(X)))
case("atleast_1d", lambda np, A: np.atleast_1d(A(onp.float32(3.0))))
case("atleast_2d", lambda np, A: np.atleast_2d(A(VEC)))
case("atleast_3d", lambda np, A: np.atleast_3d(A(X)))
case("append", lambda np, A: [np.append(A(X), A(Y)),
                              np.append(A(X), A(Y), axis=0)])
case("resize", lambda np, A: np.resize(A(X), (5, 3)))
case("pad", lambda np, A: [np.pad(A(X), 1), np.pad(A(X), ((1, 2), (0, 1)),
                                                  mode="edge"),
                           np.pad(A(X), 2, mode="reflect"),
                           np.pad(A(X), 1, mode="wrap"),
                           np.pad(A(X), 2, mode="symmetric")])
case("where", lambda np, A: [np.where(A(X > 0), A(X), A(Y)),
                             np.where(A(X > 0))])
case("take", lambda np, A: [np.take(A(X), A(IDX)),
                            np.take(A(X), A(onp.array([0, 2], "int32")),
                                    axis=1)])
case("take_along_axis", lambda np, A: np.take_along_axis(
    A(X), A(IDX[:, :1]), axis=1))
case("choose", lambda np, A: np.choose(A(IDX[:, 0] % 3), [A(VEC[:3]),
                                                           A(VEC[1:4]),
                                                           A(VEC[2:5])]))
case("compress", lambda np, A: np.compress(A(onp.array([True, False, True])),
                                           A(X), axis=0))
case("extract", lambda np, A: np.extract(A(X > 0), A(X)))
case("searchsorted", lambda np, A: [np.searchsorted(A(SORTED), A(VEC)),
                                    np.searchsorted(A(SORTED), A(VEC),
                                                    side="right")])
case("argsort", lambda np, A: np.argsort(A(X), axis=1))
case("sort", lambda np, A: [np.sort(A(X)), np.sort(A(X), axis=0)])
case("lexsort", lambda np, A: np.lexsort([A(REP.astype("float32")),
                                          A(onp.arange(8)[::-1]
                                            .astype("float32"))]))
case("partition", lambda np, A: np.partition(A(X), 2, axis=1),
     sort_axis=1)
case("argpartition", lambda np, A: np.take_along_axis(
    A(X), np.argpartition(A(X), 2, axis=1), axis=1), sort_axis=1)
case("nonzero", lambda np, A: np.nonzero(A(X > 0)))
case("argwhere", lambda np, A: np.argwhere(A(X > 0)))
case("flatnonzero", lambda np, A: np.flatnonzero(A(X > 0)))
case("unravel_index", lambda np, A: np.unravel_index(A(REP), (2, 4)))
case("ravel_multi_index", lambda np, A: np.ravel_multi_index(
    [A(IDX[:, 0]), A(IDX[:, 1])], (4, 4)))
case("diag_indices", lambda np, A: np.diag_indices(3))
case("tril_indices", lambda np, A: np.tril_indices(4, -1))
case("triu_indices", lambda np, A: np.triu_indices(3, 1, 4))
case("indices", lambda np, A: np.indices((2, 3)))
case("diag_indices_from", lambda np, A: np.diag_indices_from(A(SQ)))
case("unique", lambda np, A: [np.unique(A(REP)),
                              np.unique(A(REP), return_counts=True,
                                        return_index=True,
                                        return_inverse=True)])
case("intersect1d", lambda np, A: np.intersect1d(A(REP), A(I)))
case("union1d", lambda np, A: np.union1d(A(REP), A(I)))
case("setdiff1d", lambda np, A: np.setdiff1d(A(I), A(REP)))
case("setxor1d", lambda np, A: np.setxor1d(A(I), A(REP)))
case("isin", lambda np, A: np.isin(A(I), A(REP)))
case("bincount", lambda np, A: [np.bincount(A(REP)),
                                np.bincount(A(REP), minlength=10)])
case("histogram", lambda np, A: [np.histogram(A(X)),
                                 np.histogram(A(X), bins=4,
                                              range=(-1.0, 1.0))])
case("digitize", lambda np, A: [np.digitize(A(VEC), A(SORTED)),
                                np.digitize(A(VEC), A(SORTED), right=True)])
case("corrcoef", lambda np, A: np.corrcoef(A(X)))
case("cov", lambda np, A: [np.cov(A(X)), np.cov(A(X), rowvar=False,
                                                ddof=0)])
case("einsum", lambda np, A: [np.einsum("ij,jk->ik", A(X), A(M45)),
                              np.einsum("bij->bji", A(T234))])
case("diff", lambda np, A: [np.diff(A(X)), np.diff(A(X), n=2, axis=0)])
case("ediff1d", lambda np, A: np.ediff1d(A(VEC), to_begin=A(VEC[:1])))
case("gradient", lambda np, A: [np.gradient(A(VEC)), np.gradient(A(X))])
case("convolve", lambda np, A: [np.convolve(A(VEC), A(VEC[:3])),
                                np.convolve(A(VEC), A(VEC[:3]), "same"),
                                np.convolve(A(VEC), A(VEC[:3]), "valid")])
case("correlate", lambda np, A: [np.correlate(A(VEC), A(VEC[:3])),
                                 np.correlate(A(VEC), A(VEC[:3]), "full")])
case("polyval", lambda np, A: np.polyval(A(VEC[:3]), A(X)))
case("meshgrid", lambda np, A: np.meshgrid(A(VEC), A(VEC[:3])))
case("broadcast_arrays", lambda np, A: np.broadcast_arrays(A(X), A(VEC[:4])))
case("array_split", lambda np, A: np.array_split(A(VEC), 3))
case("split", lambda np, A: [np.split(A(X), 2, axis=1),
                             np.split(A(X), [1, 2])])
case("hsplit", lambda np, A: np.hsplit(A(X), 2))
case("vsplit", lambda np, A: np.vsplit(A(X), 3))
case("dsplit", lambda np, A: np.dsplit(A(T234), 2))
case("delete", lambda np, A: [np.delete(A(X), 1, axis=1),
                              np.delete(A(VEC),
                                        A(onp.array([0, 3], "int32")))])
case("insert", lambda np, A: [np.insert(A(VEC), 2, 9.0),
                              np.insert(A(X), 1, A(VEC[:3]), axis=1)])
case("trim_zeros", lambda np, A: np.trim_zeros(A(ZEROS_PAD)))
case("may_share_memory", lambda np, A: np.may_share_memory(A(X), A(X)))
case("shares_memory", lambda np, A: np.shares_memory(A(X), A(X)))
case("can_cast", lambda np, A: np.can_cast("int32", "float32"))
case("iscomplexobj", lambda np, A: np.iscomplexobj(A(X)))
case("isrealobj", lambda np, A: np.isrealobj(A(X)))
case("isscalar", lambda np, A: np.isscalar(A(X)))
case("ndim", lambda np, A: np.ndim(A(T234)))
case("shape", lambda np, A: np.shape(A(T234)))
case("size", lambda np, A: np.size(A(T234)))
for _n in ("blackman", "hamming", "hanning", "bartlett"):
    case(_n, lambda np, A, n=_n: getattr(np, n)(7), atol=1e-6)
case("kaiser", lambda np, A: np.kaiser(7, 3.0), atol=1e-6)
# creation, the hand-written ops and the aliases
case("zeros", lambda np, A: [np.zeros((2, 3)), np.zeros(4, dtype="int32")])
case("ones", lambda np, A: np.ones((2, 3), dtype="float16"))
case("empty", lambda np, A: np.empty((2, 3)), shape_only=True)
case("eye", lambda np, A: [np.eye(3), np.eye(3, 4, 1), np.eye(4, 3, -1)])
case("identity", lambda np, A: np.identity(3))
case("arange", lambda np, A: [np.arange(5), np.arange(1, 7, 2),
                              np.arange(0.5, 3.0, 0.5)])
case("linspace", lambda np, A: [np.linspace(0, 1, 5),
                                np.linspace(-1, 2, 7, endpoint=False)])
case("logspace", lambda np, A: np.logspace(0, 2, 5), rtol=1e-5)
case("tri", lambda np, A: np.tri(3, 4, 1))
case("full", lambda np, A: [np.full((2, 2), 3), np.full((2,), 2.5),
                            np.full((2,), True)])
case("zeros_like", lambda np, A: np.zeros_like(A(X)))
case("ones_like", lambda np, A: np.ones_like(A(I)))
case("full_like", lambda np, A: np.full_like(A(X), 7.0))
case("empty_like", lambda np, A: np.empty_like(A(X)), shape_only=True)
case("array", lambda np, A: [np.array([[1, 2], [3, 4]]),
                             np.array([1.5, 2.5]), np.array(X,
                                                            dtype="int32"),
                             np.array(onp.ones(3, "float64")),
                             np.array(onp.ones(3, "int64")),
                             np.array([True, False])])
case("asarray", lambda np, A: np.asarray([1.0, 2.0]))
case("astype", lambda np, A: np.astype(A(X), "int32"))
case("copy", lambda np, A: np.copy(A(X)))
case("product", lambda np, A: np.product(A(X), axis=0))
case("sometrue", lambda np, A: np.sometrue(A(X > 1)))
case("bitwise_left_shift", lambda np, A: np.bitwise_left_shift(A(I), A(J)))
case("bitwise_right_shift", lambda np, A: np.bitwise_right_shift(A(I),
                                                                  A(J)))


def _fill_diagonal(np, A):
    a = A(SQ)
    np.fill_diagonal(a, 5.0)
    b = A(onp.zeros((5, 3), "float32"))
    np.fill_diagonal(b, A(onp.array([1.0, 2.0], "float32")))
    return [a, b]


def _put_along_axis(np, A):
    a = A(X)
    np.put_along_axis(a, A(IDX[:, :1]), 9.0, axis=1)
    return a


case("fill_diagonal", _fill_diagonal)
case("put_along_axis", _put_along_axis)


def _run(pkg, fn):
    def A(x):
        return pkg.np.array(x)

    if pkg is tmx:
        with tmx.cpu():
            return fn(pkg.np, A)
    return fn(pkg.np, A)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _np_of(x):
    if hasattr(x, "asnumpy"):
        d = x.dtype
        name = "bfloat16" if str(d) == "bfloat16" else onp.dtype(d).name
        return x.asnumpy(), name
    a = onp.asarray(x)
    return a, type(x).__name__


def _compare(name, got, want, opts):
    g_leaves, w_leaves = _leaves(got), _leaves(want)
    assert len(g_leaves) == len(w_leaves), (name, len(g_leaves),
                                            len(w_leaves))
    for g, w in zip(g_leaves, w_leaves):
        ga, gd = _np_of(g)
        wa, wd = _np_of(w)
        assert gd == wd, (name, "dtype", gd, wd)
        assert ga.shape == wa.shape, (name, "shape", ga.shape, wa.shape)
        if opts.get("shape_only"):
            continue
        if "sort_axis" in opts:
            ga = onp.sort(ga, axis=opts["sort_axis"])
            wa = onp.sort(wa, axis=opts["sort_axis"])
        if ga.dtype.kind in "biu":
            assert onp.array_equal(ga, wa), (name, ga, wa)
        else:
            onp.testing.assert_allclose(
                ga, wa, rtol=opts.get("rtol", RTOL),
                atol=opts.get("atol", ATOL), equal_nan=True,
                err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_np_name_matches_reference(name):
    fn, opts = CASES[name]
    _compare(name, _run(tmx, fn), _run(jmx, fn), opts)


def _mapped_names():
    from incubator_mxnet_tpu_torch import numpy as tnp

    names = set()
    for n in tnp._ELEMWISE_AND_FRIENDS:
        if n in tnp.NOT_PORTED or not hasattr(tnp, n):
            continue
        names.add(n)
    return names


def test_every_ported_name_has_a_case():
    missing = sorted(_mapped_names() - set(CASES))
    assert not missing, missing


def test_table_is_the_references():
    """The port maps the reference's names: every name of the reference's
    table is ported, raises as not ported, or is missing in both (`flat`,
    which jax.numpy lacks)."""
    from incubator_mxnet_tpu import numpy as jnp_mod
    from incubator_mxnet_tpu_torch import numpy as tnp

    assert tnp._ELEMWISE_AND_FRIENDS == jnp_mod._ELEMWISE_AND_FRIENDS
    for n in tnp._ELEMWISE_AND_FRIENDS:
        assert hasattr(tnp, n) == hasattr(jnp_mod, n), n


@pytest.mark.parametrize("name", ["histogram2d", "interp", "polyfit",
                                  "result_type", "promote_types"])
def test_unported_names_raise_naming_themselves(name):
    with tmx.cpu():
        x = tmx.np.array(X)
        with pytest.raises(MXNetError, match=name):
            getattr(tmx.np, name)(x, x)


def test_linalg_is_queued_and_hasattr_is_false():
    assert not hasattr(tmx.np, "linalg")
    with pytest.raises(MXNetError, match="linalg"):
        tmx.np.linalg  # noqa: B018


def test_ufunc_and_array_function_dispatch():
    """``onp.<ufunc>(nd)`` and ``onp.mean(nd)`` dispatch into the framework
    and return NDArrays, as the reference's protocols do."""
    with tmx.cpu():
        x = tmx.np.array(X)
        r = onp.add(x, x)
        m = onp.mean(x, axis=1)
    jx = jmx.np.array(X)
    assert isinstance(r, tmx.NDArray) and isinstance(m, tmx.NDArray)
    onp.testing.assert_allclose(r.asnumpy(), onp.add(jx, jx).asnumpy())
    onp.testing.assert_allclose(m.asnumpy(), onp.mean(jx, axis=1).asnumpy(),
                                rtol=RTOL)


# ---------------------------------------------------------------------------
# np.random: the contract (same seed, same draw; range; moments)
# ---------------------------------------------------------------------------

RANDOM = {
    "uniform": lambda r: r.uniform(-1.0, 3.0, size=(4000,)),
    "normal": lambda r: r.normal(1.0, 2.0, size=(4000,)),
    "randn": lambda r: r.randn(2000, 2),
    "rand": lambda r: r.rand(4000),
    "randint": lambda r: r.randint(2, 9, size=(4000,)),
    "choice": lambda r: r.choice(10, size=(4000,)),
    "permutation": lambda r: r.permutation(4000),
    "bernoulli": lambda r: r.bernoulli(0.3, size=(4000,)),
    "categorical": lambda r: r.categorical(
        tmx.np.array(onp.log(onp.array([[0.1, 0.2, 0.7]] * 2, "float32"))),
        size=(2000, 2)),
}

# (low, high) of the draws, and (mean, std) with the tolerance of 4000
# draws (the standard error times ~6)
RANDOM_CONTRACT = {
    "uniform": ((-1.0, 3.0), (1.0, 4 / 12 ** 0.5), 0.11),
    "normal": (None, (1.0, 2.0), 0.2),
    "randn": (None, (0.0, 1.0), 0.1),
    "rand": ((0.0, 1.0), (0.5, 1 / 12 ** 0.5), 0.03),
    "randint": ((2, 8), (5.0, (48 / 12) ** 0.5), 0.2),
    "choice": ((0, 9), (4.5, (99 / 12) ** 0.5), 0.3),
    "permutation": ((0, 3999), None, 0.0),
    "bernoulli": ((0, 1), (0.3, 0.3 ** 0.5 * 0.7 ** 0.5), 0.05),
    "categorical": ((0, 2), (1.6, (0.2 + 4 * 0.7 - 1.6 ** 2) ** 0.5), 0.1),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_draw_contract(name):
    with tmx.cpu():
        tmx.np.random.seed(7)
        a = RANDOM[name](tmx.np.random).asnumpy().astype("float64")
        tmx.np.random.seed(7)
        b = RANDOM[name](tmx.np.random).asnumpy().astype("float64")
        c = RANDOM[name](tmx.np.random).asnumpy().astype("float64")
    assert onp.array_equal(a, b)              # same seed, same draw
    assert not onp.array_equal(b, c)          # the key stream moves on
    rng, moments, tol = RANDOM_CONTRACT[name]
    if rng is not None:
        assert a.min() >= rng[0] and a.max() <= rng[1], (a.min(), a.max())
    if moments is not None:
        assert abs(a.mean() - moments[0]) < tol, a.mean()
        assert abs(a.std() - moments[1]) < tol, a.std()
    if name == "permutation":
        assert onp.array_equal(onp.sort(a), onp.arange(4000))


def test_random_dtypes_match_reference():
    for name in ("uniform", "normal", "randint", "bernoulli"):
        with tmx.cpu():
            got = getattr(tmx.np.random, name)(
                *([0, 5] if name == "randint" else [0.5] if name ==
                  "bernoulli" else []), size=(3,))
        want = getattr(jmx.np.random, name)(
            *([0, 5] if name == "randint" else [0.5] if name == "bernoulli"
              else []), size=(3,))
        assert onp.dtype(got.dtype) == onp.dtype(want.dtype), name


def test_random_shuffle_rebinds_rows():
    with tmx.cpu():
        x = tmx.np.arange(20).reshape(10, 2)
        view = x[0:3]
        tmx.np.random.shuffle(x)
    rows = sorted(map(tuple, x.asnumpy().tolist()))
    assert rows == [(2 * i, 2 * i + 1) for i in range(10)]
    assert view.asnumpy().tolist() == [[0, 1], [2, 3], [4, 5]]


@pytest.mark.parametrize("name", ["beta", "gamma", "exponential", "poisson",
                                  "dirichlet", "multinomial"])
def test_unported_distributions_raise(name):
    with pytest.raises(MXNetError, match=name):
        getattr(tmx.np.random, name)(1.0, 1.0)
