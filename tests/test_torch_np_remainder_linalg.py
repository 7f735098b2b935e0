"""``mx.np.linalg`` (the 20 numpy names and the ``linalg_*`` family) and
``np.interp``/``np.polyfit``/``np.histogram2d`` against the JAX package,
on the same numpy inputs, the port on the CPU, with gradients through
``autograd`` where the op has one (`test_torch_np_remainder.both`).

Both packages run LAPACK here, so vectors compare raw except where a
factorization's sign or order is free: ``svd``'s and ``eigh``'s vectors,
``qr``'s and ``gelqf``'s factors and ``eig``'s pairs are held by their
reconstruction, their values and the vectors' absolute values
(`ROADMAP.md` §3). Tolerances: rtol 1e-4 / atol 1e-5 (``LOOSE``: the
libraries' float32 factorizations round differently); integer outputs
(ranks, counts) equal.
"""
import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from test_torch_np_remainder import LOOSE, TOL, both

R = onp.random.RandomState(3)
A = R.uniform(-1, 1, (4, 4)).astype("float32") + 4 * onp.eye(4, dtype="float32")
B = R.uniform(-1, 1, (4, 2)).astype("float32")
SPD = (A @ A.T).astype("float32")
BATCH = onp.stack([A, A.T + onp.eye(4, dtype="float32")])
RECT = R.uniform(-1, 1, (5, 3)).astype("float32")
LOW = onp.tril(A)
T4 = (R.uniform(-1, 1, (2, 3, 6)) + 0).astype("float32")

NUMPY = {
    "norm": (lambda mx, a: mx.np.linalg.norm(a), [RECT], (0,)),
    "norm_fro_inf": (lambda mx, a: [mx.np.linalg.norm(a, "fro"),
                                    mx.np.linalg.norm(a, onp.inf)],
                     [RECT], (0,)),
    "svd_values": (lambda mx, a: mx.np.linalg.svd(a, compute_uv=False),
                   [RECT], (0,)),
    "cholesky": (lambda mx, a: mx.np.linalg.cholesky(a), [SPD], (0,)),
    "inv": (lambda mx, a: mx.np.linalg.inv(a), [A], (0,)),
    "pinv": (lambda mx, a: mx.np.linalg.pinv(a), [RECT], (0,)),
    "det": (lambda mx, a: mx.np.linalg.det(a), [BATCH], (0,)),
    "slogdet": (lambda mx, a: mx.np.linalg.slogdet(a), [BATCH], (0,)),
    "solve": (lambda mx, a, b: mx.np.linalg.solve(a, b), [A, B], (0, 1)),
    "solve_vector": (lambda mx, a, b: mx.np.linalg.solve(a, b),
                     [A, B[:, 0].copy()], (0, 1)),
    "lstsq": (lambda mx, a, b: mx.np.linalg.lstsq(a, b), [RECT, B[:, :1]
              .repeat(5, 0)[:5]], (0,)),
    "eigvalsh": (lambda mx, a: mx.np.linalg.eigvalsh(a), [SPD], (0,)),
    "matrix_rank": (lambda mx, a: mx.np.linalg.matrix_rank(a), [RECT], ()),
    "matrix_rank_deficient": (
        lambda mx, a: mx.np.linalg.matrix_rank(a, rtol=1e-3),
        [onp.concatenate([RECT, RECT[:, :1]], 1)], ()),
    "matrix_power": (lambda mx, a: mx.np.linalg.matrix_power(a, 3), [A],
                     (0,)),
    "multi_dot": (lambda mx, a, b, c: mx.np.linalg.multi_dot([a, b, c]),
                  [RECT.T.copy(), RECT, B[:3]], (0, 1, 2)),
    "tensorinv": (lambda mx, a: mx.np.linalg.tensorinv(a, ind=1),
                  [A], (0,)),
    "tensorsolve": (lambda mx, a, b: mx.np.linalg.tensorsolve(a, b),
                    [A.reshape(4, 2, 2), B[:, 0].copy()], (0, 1)),
    "cond": (lambda mx, a: mx.np.linalg.cond(a), [A], ()),
}


@pytest.mark.parametrize("name", sorted(NUMPY))
def test_numpy_linalg_matches_the_reference(name):
    fn, inputs, grad = NUMPY[name]
    both(fn, inputs, grad, LOOSE)


def _pair(fn, *arrays):
    """``fn(mx, *arrays)`` on both packages, as numpy lists."""
    ref = fn(jmx, *[jmx.np.array(a) for a in arrays])
    with tmx.cpu():
        got = fn(tmx, *[tmx.np.array(a) for a in arrays])
    conv = (lambda o: [x.asnumpy() for x in o]) if isinstance(
        ref, (list, tuple)) else (lambda o: [o.asnumpy()])
    return conv(got), conv(ref)


@pytest.mark.parametrize("full", [False, True])
def test_svd_and_qr_reconstruct_with_the_references_values(full):
    (u, s, vh), (ju, js, jvh) = _pair(
        lambda mx, a: mx.np.linalg.svd(a, full_matrices=full), RECT)
    assert u.shape == ju.shape and vh.shape == jvh.shape
    onp.testing.assert_allclose(s, js, **LOOSE)
    k = s.shape[0]
    onp.testing.assert_allclose(u[:, :k] * s @ vh[:k], RECT, **LOOSE)
    onp.testing.assert_allclose(onp.abs(u[:, :k]), onp.abs(ju[:, :k]),
                                **LOOSE)
    mode = "complete" if full else "reduced"
    (q, r), (jq, jr) = _pair(lambda mx, a: mx.np.linalg.qr(a, mode=mode),
                             RECT)
    assert q.shape == jq.shape and r.shape == jr.shape
    onp.testing.assert_allclose(q @ r, RECT, **LOOSE)
    onp.testing.assert_allclose(onp.abs(r), onp.abs(jr), **LOOSE)
    (r_only,), (jr_only,) = _pair(lambda mx, a: mx.np.linalg.qr(a, mode="r"),
                                  RECT)
    onp.testing.assert_allclose(onp.abs(r_only), onp.abs(jr_only), **LOOSE)


def test_eig_and_eigh_match_the_references_values_and_vectors():
    (w, v), (jw, jv) = _pair(lambda mx, a: mx.np.linalg.eigh(a), SPD)
    onp.testing.assert_allclose(w, jw, **LOOSE)
    onp.testing.assert_allclose(onp.abs(v), onp.abs(jv), rtol=1e-3,
                                atol=1e-4)
    onp.testing.assert_allclose(v * w @ v.T, SPD, rtol=1e-4, atol=1e-3)
    (w, v), (jw, jv) = _pair(lambda mx, a: mx.np.linalg.eig(a), A)
    assert w.dtype == jw.dtype == onp.complex64
    order, jorder = onp.argsort(w.real + 1e-3 * w.imag), \
        onp.argsort(jw.real + 1e-3 * jw.imag)
    onp.testing.assert_allclose(w[order], jw[jorder], **LOOSE)
    onp.testing.assert_allclose(A @ v, v * w, rtol=1e-4, atol=1e-4)
    (w,), (jw,) = _pair(lambda mx, a: mx.np.linalg.eigvals(a), A)
    onp.testing.assert_allclose(onp.sort_complex(w), onp.sort_complex(jw),
                                **LOOSE)


LA_OP = {
    "gemm2": (lambda mx, a, b: mx.np.linalg.gemm2(a, b, transpose_b=True,
                                                  alpha=0.5),
              [RECT, RECT], (0, 1)),
    "gemm2_axis": (lambda mx, a, b: mx.np.linalg.gemm2(
        a, b, transpose_a=True, axis=0),
        [onp.ascontiguousarray(BATCH.transpose(1, 2, 0)),
         onp.ascontiguousarray(BATCH.transpose(1, 2, 0))], (0, 1)),
    "gemm": (lambda mx, a, b, c: mx.np.linalg.gemm(a, b, c, transpose_a=True,
                                                   alpha=2.0, beta=-1.0),
             [RECT, B[:1].repeat(5, 0)[:, :1].repeat(3, 1),
              onp.ones((3, 3), "float32")], (0, 1, 2)),
    "potrf": (lambda mx, a: mx.np.linalg.potrf(a), [SPD], (0,)),
    "potri": (lambda mx, a: mx.np.linalg.potri(a), [LOW], (0,)),
    "trsm": (lambda mx, a, b: mx.np.linalg.trsm(a, b, alpha=2.0),
             [LOW, B], (0, 1)),
    "trsm_transpose_right_upper": (
        lambda mx, a, b: mx.np.linalg.trsm(a, b, transpose=True,
                                           rightside=True, lower=False),
        [onp.triu(A), B.T.copy()], (0, 1)),
    "trmm": (lambda mx, a, b: mx.np.linalg.trmm(a, b, alpha=3.0),
             [A, B], (0, 1)),
    "trmm_right_upper_t": (
        lambda mx, a, b: mx.np.linalg.trmm(a, b, transpose=True,
                                           rightside=True, lower=False),
        [A, B.T.copy()], (0, 1)),
    "syrk": (lambda mx, a: mx.np.linalg.syrk(a, alpha=0.5), [RECT], (0,)),
    "sumlogdiag": (lambda mx, a: mx.np.linalg.sumlogdiag(a), [SPD], (0,)),
    "extractdiag": (lambda mx, a: mx.np.linalg.extractdiag(a, offset=1),
                    [BATCH], (0,)),
    "makediag": (lambda mx, v: mx.np.linalg.makediag(v, offset=-1),
                 [RECT], (0,)),
    "extracttrian": (lambda mx, a: mx.np.linalg.extracttrian(a), [BATCH],
                     (0,)),
    "extracttrian_upper_offset": (
        lambda mx, a: mx.np.linalg.extracttrian(a, offset=1, lower=False),
        [A], (0,)),
    "maketrian": (lambda mx, v: mx.np.linalg.maketrian(v),
                  [R.uniform(size=(2, 10)).astype("float32")], (0,)),
    "inverse": (lambda mx, a: mx.np.linalg.inverse(a), [BATCH], (0,)),
}


@pytest.mark.parametrize("name", sorted(LA_OP))
def test_la_op_matches_the_reference(name):
    fn, inputs, grad = LA_OP[name]
    both(fn, inputs, grad, LOOSE)


def test_syevd_and_gelqf_reconstruct_as_the_references():
    (u, lam), (ju, jlam) = _pair(lambda mx, a: mx.np.linalg.syevd(a), SPD)
    onp.testing.assert_allclose(lam, jlam, **LOOSE)
    onp.testing.assert_allclose(onp.abs(u), onp.abs(ju), rtol=1e-3,
                                atol=1e-4)
    onp.testing.assert_allclose(u.T * lam @ u, SPD, rtol=1e-4, atol=1e-3)
    (lo, q), (jlo, jq) = _pair(lambda mx, a: mx.np.linalg.gelqf(a),
                               RECT.T.copy())
    assert lo.shape == jlo.shape and q.shape == jq.shape
    onp.testing.assert_allclose(lo @ q, RECT.T, **LOOSE)
    onp.testing.assert_allclose(q @ q.T, onp.eye(3), atol=1e-5)
    onp.testing.assert_allclose(onp.abs(lo), onp.abs(jlo), **LOOSE)


def test_nd_linalg_is_np_linalg_and_singular_inputs_do_not_raise():
    assert tmx.nd.linalg is tmx.np.linalg
    with tmx.cpu():
        z = tmx.np.zeros((3, 3))
        assert not onp.isfinite(tmx.np.linalg.inv(z).asnumpy()).all()
        assert not onp.isfinite(tmx.np.linalg.cholesky(-tmx.np.eye(3))
                                .asnumpy()).all()


# ---------------------------------------------------------------------------
# mx.np's names ported here: interp, polyfit, histogram2d (their plain calls
# are cases of test_torch_np.py; these are the options)
# ---------------------------------------------------------------------------

XP = onp.array([0.0, 0.5, 0.5, 1.5, 3.0], "float32")
FP = onp.array([1.0, 2.0, 4.0, -1.0, 0.5], "float32")
XS = onp.array([-1.0, 0.0, 0.25, 0.5, 0.7, 2.9, 3.0, 4.0], "float32")
HX = R.uniform(0, 1, 40).astype("float32")
HY = R.uniform(-2, 2, 40).astype("float32")

NP = {
    "interp_left_right": (
        lambda mx, x, xp, fp: mx.np.interp(x, xp, fp, left=-9.0, right=9.0),
        [XS, XP, FP], (0, 2)),
    "interp_extrapolate": (
        lambda mx, x, xp, fp: mx.np.interp(x, xp, fp, left="extrapolate",
                                           right="extrapolate"),
        [XS, XP, FP], ()),
    "interp_period": (
        lambda mx, x, xp, fp: mx.np.interp(x, xp, fp, period=2.0),
        [XS, onp.array([1.5, 0.2, 1.0], "float32"),
         onp.array([3.0, 1.0, -2.0], "float32")], ()),
    "polyfit_full_weighted": (
        lambda mx, x, y, w: mx.np.polyfit(x, y, 3, full=True, w=w),
        [HX, HY, HX + 0.5], ()),
    "polyfit_2d_cov": (
        lambda mx, x, y: mx.np.polyfit(x, y, 1, cov=True),
        [HX, onp.stack([HY, HY * 2 + 1], 1)], ()),
    "histogram2d_range_weights_density": (
        lambda mx, x, y, w: mx.np.histogram2d(
            x, y, bins=(3, 5), range=[[0.2, 0.8], [-1, 1]], weights=w,
            density=True), [HX, HY, HX], ()),
    "histogram2d_edges": (
        lambda mx, x, y: mx.np.histogram2d(
            x, y, bins=[onp.array([0, 0.5, 1.0], "float32"),
                        onp.array([-2.0, 0.0, 2.0], "float32")]),
        [HX, onp.where(HY > 1.5, 2.0, HY).astype("float32")], ()),
}


@pytest.mark.parametrize("name", sorted(NP))
def test_np_name_matches_the_reference(name):
    fn, inputs, grad = NP[name]
    both(fn, inputs, grad, LOOSE)


def test_result_type_and_promote_types_raise_without_an_item():
    with tmx.cpu():
        for name in ("result_type", "promote_types"):
            with pytest.raises(tmx.base.MXNetError) as e:
                getattr(tmx.np, name)("float32", "int32")
            assert "item" not in str(e.value)
