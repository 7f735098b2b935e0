"""``mx.np.linalg`` and the reference's ``linalg_*`` operator family
(port of `incubator_mxnet_tpu/numpy/linalg.py`: the 20 numpy names it
forwards to ``jnp.linalg`` :23-60, and `gemm2` :62, `gemm` :84, `syevd`
:107, `potrf` :121, `potri` :132, `trsm` :148, `trmm` :168, `syrk` :183,
`gelqf` :195, `sumlogdiag` :207, `extractdiag` :218, `makediag` :228,
`extracttrian` :243, `maketrian` :259, `inverse` :284).

Every op goes through the NDArray funnel (recorded under
``autograd.record()``, cast by AMP by the reference's names:
``linalg.<name>`` and ``linalg_<op>``) onto ``torch.linalg`` (LAPACK on
the CPU, cuSOLVER and cuBLAS on the card); nothing here is a kernel of
the port's own. The factorizations whose error checks read the card on
the host (``cholesky``, ``inv``, ``solve``) use their ``*_ex`` forms,
which do not: as ``jnp.linalg``'s, a singular or indefinite input gives
non-finite values, not an exception. ``lstsq`` and ``matrix_rank`` are
the reference's SVD formulas (``jnp.linalg``'s), so they run on the card
too, where ``torch.linalg.lstsq`` takes full-rank inputs only. Named
tuples come back as plain tuples, as the reference's ``_make`` gives
them.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..ndarray.ndarray import NDArray, apply_op_flat

__all__ = [
    "norm", "svd", "cholesky", "qr", "inv", "pinv", "det", "slogdet",
    "solve", "lstsq", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank",
    "matrix_power", "multi_dot", "tensorinv", "tensorsolve", "cond",
    "gemm", "gemm2", "syevd", "potrf", "potri", "trsm", "trmm", "syrk",
    "gelqf",
    "sumlogdiag", "extractdiag", "makediag", "extracttrian", "maketrian",
    "inverse",
]


def _inexact(t):
    """An integer or bool input as float32, as ``jnp.linalg`` promotes
    it."""
    if t.is_floating_point() or t.is_complex():
        return t
    return t.to(torch.float32)


def _call(name, fn, *args):
    """``fn`` of ``args``' tensors through the funnel when any is an
    NDArray (a list among them too), else directly; tuple results (torch's
    named tuples) as plain tuples."""
    def run(*vals):
        res = fn(*vals)
        return tuple(res) if isinstance(res, tuple) else res

    nd = any(isinstance(a, NDArray) or (
        isinstance(a, (list, tuple)) and any(isinstance(b, NDArray)
                                             for b in a)) for a in args)
    if nd:
        return apply_op_flat(name, run, args)
    return run(*args)


# ---------------------------------------------------------------------------
# the numpy names
# ---------------------------------------------------------------------------

def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    return _call("linalg.norm", lambda a: torch.linalg.norm(
        _inexact(a), ord, axis, keepdims), x)


def svd(a, full_matrices=True, compute_uv=True, hermitian=False):  # noqa: ARG001
    """(U, S, Vh), or S alone without ``compute_uv``."""
    def fn(m):
        m = _inexact(m)
        if not compute_uv:
            return torch.linalg.svdvals(m)
        return torch.linalg.svd(m, full_matrices=full_matrices)

    return _call("linalg.svd", fn, a)


def _sym(m):
    """``(m + mᴴ) / 2``: ``jnp.linalg``'s factorizations symmetrize their
    input by default."""
    return (m + m.mH) / 2


def _chol(m, upper=False):
    """The Cholesky factor of ``_sym(m)``, NaN where the matrix is not
    positive definite (``jnp.linalg.cholesky``'s answer), with no error
    read on the host."""
    fac, info = torch.linalg.cholesky_ex(_sym(m), upper=upper)
    return torch.where((info == 0)[..., None, None], fac, torch.nan)


def cholesky(a, upper=False):
    return _call("linalg.cholesky",
                 lambda m: _chol(_inexact(m), upper=upper), a)


def qr(a, mode="reduced"):
    """(Q, R) in mode "reduced" or "complete"; R alone in mode "r"."""
    def fn(m):
        q, r = torch.linalg.qr(_inexact(m), mode=mode)
        return r if mode == "r" else (q, r)

    return _call("linalg.qr", fn, a)


def inv(a):
    return _call("linalg.inv",
                 lambda m: torch.linalg.inv_ex(_inexact(m)).inverse, a)


def pinv(a, rtol=None, hermitian=False, *, rcond=None):
    tol = rcond if rtol is None else rtol
    return _call("linalg.pinv", lambda m: torch.linalg.pinv(
        _inexact(m), rtol=tol, hermitian=hermitian), a)


def det(a):
    return _call("linalg.det", lambda m: torch.linalg.det(_inexact(m)), a)


def slogdet(a):
    """(sign, log|det|)."""
    return _call("linalg.slogdet",
                 lambda m: torch.linalg.slogdet(_inexact(m)), a)


def solve(a, b):
    return _call("linalg.solve", lambda m, r: torch.linalg.solve_ex(
        _inexact(m), _inexact(r)).result, a, b)


def _lstsq(a, b, rcond, numpy_resid=False):
    """``jnp.linalg.lstsq``'s SVD solution: singular values below
    ``rcond`` times the largest dropped; (x, residuals, rank, s)."""
    a, b = _inexact(a), _inexact(b)
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = float(torch.finfo(a.dtype).eps) * max(n, m)
    elif rcond < 0:
        rcond = float(torch.finfo(a.dtype).eps)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0)[:, None]
    x = vt.mH @ (s_inv * (u.mH @ b))
    if numpy_resid and (int(rank) < n or m <= n):
        resid = torch.zeros(0, dtype=a.dtype, device=a.device)
    else:
        resid = torch.linalg.norm(b - a @ x, dim=0) ** 2
    return (x.reshape(-1) if vec else x), resid, rank, s


def lstsq(a, b, rcond=None, *, numpy_resid=False):
    """(x, residuals, rank, singular values): see :func:`_lstsq`."""
    return _call("linalg.lstsq",
                 lambda m, r: _lstsq(m, r, rcond, numpy_resid), a, b)


def eig(a):
    """(eigenvalues, eigenvectors), complex."""
    return _call("linalg.eig", lambda m: torch.linalg.eig(_inexact(m)), a)


def eigh(a, UPLO=None, symmetrize_input=True):  # noqa: N803
    """(eigenvalues ascending, eigenvectors) of ``(a + aᴴ) / 2`` (with
    ``symmetrize_input``, the reference's default) or of the ``UPLO``
    triangle."""
    def fn(m):
        m = _inexact(m)
        if symmetrize_input:
            m = _sym(m)
        return torch.linalg.eigh(m, UPLO=UPLO or "L")

    return _call("linalg.eigh", fn, a)


def eigvals(a):
    return _call("linalg.eigvals",
                 lambda m: torch.linalg.eigvals(_inexact(m)), a)


def eigvalsh(a, UPLO="L", symmetrize_input=True):  # noqa: N803
    def fn(m):
        m = _inexact(m)
        if symmetrize_input:
            m = _sym(m)
        return torch.linalg.eigvalsh(m, UPLO=UPLO)

    return _call("linalg.eigvalsh", fn, a)


def matrix_rank(M, rtol=None, *, tol=None):  # noqa: N803
    """The count of singular values above ``rtol`` (``tol``) times the
    largest, by default ``max(m, n)·eps`` of it: ``jnp.linalg``'s rule."""
    rt = tol if rtol is None else rtol

    def fn(m):
        m = _inexact(m)
        if m.dim() < 2:
            return (m != 0).any().to(torch.int32)
        s = torch.linalg.svdvals(m)
        smax = s.amax(dim=-1, keepdim=True)
        if rt is None:
            cut = smax * max(m.shape[-2:]) * torch.finfo(s.dtype).eps
        else:
            cut = torch.as_tensor(rt, dtype=s.dtype, device=s.device)
            cut = (cut * s.amax(dim=-1)).unsqueeze(-1) if cut.dim() \
                else cut * smax
        return (s > cut).sum(dim=-1).to(torch.int32)

    return _call("linalg.matrix_rank", fn, M)


def matrix_power(a, n):
    return _call("linalg.matrix_power",
                 lambda m: torch.linalg.matrix_power(m, n), a)


def multi_dot(arrays, *, precision=None):  # noqa: ARG001
    return _call("linalg.multi_dot",
                 lambda xs: torch.linalg.multi_dot(list(xs)), list(arrays))


def tensorinv(a, ind=2):
    return _call("linalg.tensorinv",
                 lambda m: torch.linalg.tensorinv(_inexact(m), ind), a)


def tensorsolve(a, b, axes=None):
    return _call("linalg.tensorsolve", lambda m, r: torch.linalg.tensorsolve(
        _inexact(m), _inexact(r), dims=axes), a, b)


def cond(x, p=None):
    return _call("linalg.cond",
                 lambda m: torch.linalg.cond(_inexact(m), p), x)


# ---------------------------------------------------------------------------
# the la_op family
# ---------------------------------------------------------------------------

def _to_last(t, axis):
    """The matrices on (axis, axis + 1) moved to the last two axes."""
    return t if axis == -2 else torch.movedim(t, (axis, axis + 1), (-2, -1))


def _from_last(t, axis):
    return t if axis == -2 else torch.movedim(t, (-2, -1), (axis, axis + 1))


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):  # noqa: N803
    """``alpha · op(A) @ op(B)``; ``axis`` names the axis of the matrix
    rows."""
    def fn(a, b):
        a, b = _to_last(a, axis), _to_last(b, axis)
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return _from_last(alpha * torch.matmul(a, b), axis)

    return apply_op_flat("linalg_gemm2", fn, (A, B), {})


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,  # noqa: N803
         beta=1.0, axis=-2):
    """``alpha · op(A) @ op(B) + beta · C``."""
    def fn(a, b, c):
        a, b, c = (_to_last(t, axis) for t in (a, b, c))
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return _from_last(alpha * torch.matmul(a, b) + beta * c, axis)

    return apply_op_flat("linalg_gemm", fn, (A, B, C), {})


def syevd(A):  # noqa: N803
    """(U, L) with ``A = Uᵀ·diag(L)·U``: the eigenvectors in U's ROWS (the
    reference's convention), the eigenvalues ascending."""
    def fn(a):
        w, v = torch.linalg.eigh(_sym(a))
        return v.transpose(-1, -2), w

    return apply_op_flat("linalg_syevd", fn, (A,), {}, n_outputs=2)


def potrf(A, lower=True):  # noqa: N803
    """The Cholesky factor, lower (or its transpose)."""
    def fn(a):
        chol = _chol(a)
        return chol if lower else chol.transpose(-1, -2)

    return apply_op_flat("linalg_potrf", fn, (A,), {})


def _tri_solve(a, b, lower, trans=False):
    """``op(a) x = b`` with ``a`` triangular (only its ``lower`` or upper
    triangle read), op the transpose with ``trans``."""
    a = torch.tril(a) if lower else torch.triu(a)
    if trans:
        a, lower = a.transpose(-1, -2), not lower
    return torch.linalg.solve_triangular(a, b, upper=not lower)


def potri(L, lower=True):  # noqa: N803
    """``inv(L Lᵀ)`` from the Cholesky factor ``L``."""
    def fn(fac):
        fac = fac if lower else fac.transpose(-1, -2)
        eye = torch.eye(fac.shape[-1], dtype=fac.dtype,
                        device=fac.device).expand(fac.shape)
        linv = _tri_solve(fac, eye, True)
        return linv.transpose(-1, -2) @ linv

    return apply_op_flat("linalg_potri", fn, (L,), {})


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):  # noqa: N803
    """X with ``op(A) X = alpha B`` (``X op(A) = alpha B`` with
    ``rightside``), A triangular."""
    def fn(a, b):
        rhs = alpha * b
        if rightside:
            x_t = _tri_solve(a.transpose(-1, -2), rhs.transpose(-1, -2),
                             not lower, transpose)
            return x_t.transpose(-1, -2)
        return _tri_solve(a, rhs, lower, transpose)

    return apply_op_flat("linalg_trsm", fn, (A, B), {})


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):  # noqa: N803
    """``alpha · op(A) @ B`` (``alpha · B @ op(A)`` with ``rightside``),
    A's ``lower`` (or upper) triangle."""
    def fn(a, b):
        tri = torch.tril(a) if lower else torch.triu(a)
        if transpose:
            tri = tri.transpose(-1, -2)
        return alpha * (b @ tri if rightside else tri @ b)

    return apply_op_flat("linalg_trmm", fn, (A, B), {})


def syrk(A, transpose=False, alpha=1.0):  # noqa: N803
    """``alpha · A Aᵀ`` (``alpha · Aᵀ A`` with ``transpose``)."""
    def fn(a):
        at = a.transpose(-1, -2)
        return alpha * (at @ a if transpose else a @ at)

    return apply_op_flat("linalg_syrk", fn, (A,), {})


def gelqf(A):  # noqa: N803
    """(L, Q) with ``A = L Q``, Q's rows orthonormal: the QR factors of
    Aᵀ, transposed (the reference's output order)."""
    def fn(a):
        q_t, r_t = torch.linalg.qr(a.transpose(-1, -2))
        return r_t.transpose(-1, -2), q_t.transpose(-1, -2)

    return apply_op_flat("linalg_gelqf", fn, (A,), {}, n_outputs=2)


def sumlogdiag(A):  # noqa: N803
    """``sum(log(diag(A)))`` over the last two axes."""
    return apply_op_flat("linalg_sumlogdiag", lambda a: torch.log(
        torch.diagonal(a, dim1=-2, dim2=-1)).sum(dim=-1), (A,), {})


def extractdiag(A, offset=0):  # noqa: N803
    return apply_op_flat("linalg_extractdiag", lambda a: torch.diagonal(
        a, offset=offset, dim1=-2, dim2=-1), (A,), {})


def makediag(v, offset=0):
    """Vectors onto the ``offset`` diagonal of square matrices of size
    ``len + |offset|``."""
    return apply_op_flat("linalg_makediag", lambda x: torch.diag_embed(
        x, offset=offset), (v,), {})


def _trian(n, offset, lower):
    """Row-major (rows, cols) of the ``offset`` triangle of an n x n
    matrix."""
    ones = _onp.ones((n, n), bool)
    mask = _onp.tril(ones, k=offset) if lower else _onp.triu(ones, k=offset)
    return _onp.nonzero(mask)


def extracttrian(A, offset=0, lower=True):  # noqa: N803
    """A triangle's entries, row-major, as a vector."""
    def fn(a):
        rows, cols = _trian(a.shape[-1], offset, lower)
        return a[..., torch.as_tensor(rows, device=a.device),
                 torch.as_tensor(cols, device=a.device)]

    return apply_op_flat("linalg_extracttrian", fn, (A,), {})


def maketrian(v, offset=0, lower=True):
    """Vectors back into triangular matrices (:func:`extracttrian`'s
    inverse); the size is the smallest whose triangle holds them."""
    def fn(x):
        k = x.shape[-1]
        n = 1
        while True:
            rows, cols = _trian(n, offset, lower)
            if len(rows) == k:
                break
            n += 1
            if n > 4096:
                raise ValueError("cannot infer matrix size from vector")
        flat = torch.as_tensor(rows * n + cols, device=x.device)
        out = x.new_zeros(x.shape[:-1] + (n * n,))
        return out.index_copy(out.dim() - 1, flat, x).reshape(
            x.shape[:-1] + (n, n))

    return apply_op_flat("linalg_maketrian", fn, (v,), {})


def inverse(A):  # noqa: N803
    return apply_op_flat("linalg_inverse",
                         lambda a: torch.linalg.inv_ex(a).inverse, (A,), {})
