"""The port's softmax family, ``batch_dot``, ``arange_like``, ``softsign``,
broadcast dropout masks and the legacy ``nd`` names over them, against
the JAX package's, on the same numpy-seeded inputs (NDArrays on both
sides, CPU tensors under the port).

Tolerances (float32): 1e-6 abs and rel for the elementwise ops and the
softmax family's outputs and gradients (the same formula, reductions over
at most 17 elements in another order), 1e-5 for ``batch_dot`` (sums of up
to 16 products); bfloat16 outputs within one bf16 spacing (2^-7 rel)
where the two frameworks round the same f32 value. ``arange_like`` and
the masks are exact. Dropout cannot match the reference's bits (Philox
against threefry): both are held to the contract, the mask constant along
``axes``, the keep fraction within 5 standard deviations of 1 - p, the
kept values x / (1 - p), the same mask in forward and backward, the same
result for the same seed, the identity at p = 0.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import random as tmxrandom
from incubator_mxnet_tpu_torch.ops import _philox as ph

TOL = dict(rtol=1e-6, atol=1e-6)


def _x(shape, seed, scale=2.0):
    return onp.random.RandomState(seed).normal(0, scale, shape) \
        .astype("float32")


def _mask(shape, seed, dead_row=None):
    m = (onp.random.RandomState(seed).uniform(size=shape) > 0.3) \
        .astype("float32")
    m[..., 0] = 1.0
    if dead_row is not None:
        m[dead_row] = 0.0
    return m


def _name(dtype):
    """A dtype's name, "float32" or "bfloat16", on either side."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return onp.dtype(dtype).name


def _both(fn):
    """fn(mx) run on the JAX package and on the port (CPU), as numpy."""
    want = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    conv = (lambda a: onp.asarray(a.asnumpy() if hasattr(a, "asnumpy")
                                  else a, onp.float32))
    if isinstance(want, (list, tuple)):
        return [conv(g) for g in got], [conv(w) for w in want]
    return conv(got), conv(want)


SOFTMAX_CASES = {
    "axis-1": lambda mx, a: mx.npx.softmax(a, axis=-1),
    "axis1": lambda mx, a: mx.npx.softmax(a, axis=1),
    "temperature": lambda mx, a: mx.npx.softmax(a, temperature=2.5),
    "length": lambda mx, a: mx.npx.softmax(
        a, length=mx.np.array(onp.asarray([[3, 17, 1], [5, 9, 2]],
                                          "int32")), use_length=True),
    "dtype": lambda mx, a: mx.npx.softmax(a, dtype="float16"),
    "softmin": lambda mx, a: mx.npx.softmin(a, axis=0, temperature=0.5),
    "log_softmax": lambda mx, a: mx.npx.log_softmax(a, temperature=3.0),
    "masked": lambda mx, a: mx.npx.masked_softmax(
        a, mx.np.array(_mask((2, 3, 17), 4, dead_row=(1, 2)))),
    "masked_temperature": lambda mx, a: mx.npx.masked_softmax(
        a, mx.np.array(_mask((2, 3, 17), 5)), axis=-1, temperature=0.7),
    "masked_log": lambda mx, a: mx.npx.masked_log_softmax(
        a, mx.np.array(_mask((2, 3, 17), 6))),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_softmax_family_matches_jax(case):
    """Forward on (2, 3, 17) inputs (a row with no live entry included),
    and the gradient of a weighted sum of the output (-inf entries of the
    masked log-softmax excluded)."""
    a, w = _x((2, 3, 17), 1), _x((2, 3, 17), 2, scale=1.0)
    op = SOFTMAX_CASES[case]

    def run(mx):
        x = mx.np.array(a)
        x.attach_grad()
        with mx.autograd.record():
            y = op(mx, x)
            fin = mx.np.array(onp.isfinite(op(jmx, jmx.np.array(a))
                                           .asnumpy()).astype("float32"))
            loss = (mx.np.where(fin > 0, y, 0.0) * mx.np.array(w)).sum()
        loss.backward()
        return y, x.grad

    (y, g), (yw, gw) = _both(run)
    assert y.shape == yw.shape
    onp.testing.assert_allclose(y, yw, **TOL)
    onp.testing.assert_allclose(g, gw, rtol=1e-5, atol=1e-5)
    with tmx.cpu():
        out = op(tmx, tmx.np.array(a))
    want_dtype = "float16" if case == "dtype" else "float32"
    assert _name(out.dtype) == want_dtype


def test_softmax_safe_accumulation_matches_jax(monkeypatch):
    """``MXNET_SAFE_ACCUMULATION=1``: a bf16 input reduces in f32 and the
    output is bf16 again, within one bf16 spacing of the reference's. Off,
    the output is bf16 on both sides, but the reference reduces in bf16
    while PyTorch's softmax reduces a bf16 input in f32 and rounds once
    (the rounding divergence of ROADMAP.md §3): within 2^-4 rel (measured
    on the CPU: 0.022)."""
    a = _x((4, 33), 3)
    for flag, rtol in (("1", 2.0 ** -7), ("0", 2.0 ** -4)):
        monkeypatch.setenv("MXNET_SAFE_ACCUMULATION", flag)
        with tmx.cpu():
            got = tmx.npx.softmax(tmx.np.array(a).astype("bfloat16"))
        want = jmx.npx.softmax(jmx.np.array(a).astype("bfloat16"))
        assert _name(got.dtype) == _name(want.dtype) == "bfloat16"
        onp.testing.assert_allclose(
            got.asnumpy().astype("float32"),
            onp.asarray(want.asnumpy(), "float32"), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_batch_dot_matches_jax(ta, tb):
    a = _x((3, 16, 5) if ta else (3, 5, 16), 7)
    b = _x((3, 7, 16) if tb else (3, 16, 7), 8)

    def run(mx):
        x, y = mx.np.array(a), mx.np.array(b)
        x.attach_grad()
        y.attach_grad()
        with mx.autograd.record():
            out = mx.npx.batch_dot(x, y, transpose_a=ta, transpose_b=tb)
            loss = (out * out).sum()
        loss.backward()
        return out, x.grad, y.grad

    got, want = _both(run)
    assert got[0].shape == (3, 5, 7)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def test_batch_dot_casts_under_amp_and_softmax_runs_f32():
    """Under AMP ``batch_dot`` takes the target dtype and the softmax
    family float32, on NDArrays and on torch tensors alike."""
    a = _x((2, 4, 8), 9)
    for target in ("bfloat16", "float16"):
        tmx.amp.init(target)
        jmx.amp.init(target)
        try:
            got, want = _both(lambda mx: mx.npx.batch_dot(
                mx.np.array(a), mx.np.array(a), transpose_b=True))
            assert str(got.dtype) == str(want.dtype)
            with tmx.cpu():
                nd = tmx.npx.batch_dot(tmx.np.array(a), tmx.np.array(a),
                                       transpose_b=True)
                sm = tmx.npx.masked_softmax(nd, tmx.np.array(
                    onp.ones((2, 4, 4), "float32")))
            t = tmx.npx.batch_dot(torch.from_numpy(a), torch.from_numpy(a),
                                  transpose_b=True)
            ts = tmx.npx.softmax(t)
            assert _name(nd.dtype) == _name(t.dtype) == target
            assert _name(sm.dtype) == _name(ts.dtype) == "float32"
        finally:
            tmx.amp.deinit()
            jmx.amp.deinit()


@pytest.mark.parametrize("kw", [dict(), dict(axis=1),
                                dict(start=2.0, step=0.5),
                                dict(start=-1.0, step=3.0, axis=0)])
def test_arange_like_matches_jax(kw):
    a = _x((3, 5, 2), 10)
    got, want = _both(lambda mx: mx.npx.arange_like(mx.np.array(a), **kw))
    assert got.shape == want.shape
    onp.testing.assert_array_equal(got, want)
    t = tmx.npx.arange_like(torch.from_numpy(a), **kw)
    onp.testing.assert_array_equal(t.numpy(), want)


def test_softsign_matches_jax():
    a = _x((4, 9), 11)
    got, want = _both(lambda mx: mx.npx.softsign(mx.np.array(a)))
    onp.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,call", [
    ("softmax", lambda mx, a: mx.nd.softmax(a, axis=0)),
    ("log_softmax", lambda mx, a: mx.nd.log_softmax(a)),
    ("batch_dot", lambda mx, a: mx.nd.batch_dot(
        a.reshape(2, 3, 6), a.reshape(2, 6, 3))),
    ("LeakyReLU", lambda mx, a: mx.nd.LeakyReLU(a, slope=0.2)),
    ("softsign", lambda mx, a: mx.nd.softsign(a)),
])
def test_legacy_nd_names_match_jax(name, call):
    """The legacy names that waited for their npx op resolve to it, with
    the reference's semantics."""
    a = _x((6, 6), 12)
    got, want = _both(lambda mx: call(mx, mx.np.array(a)))
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert name not in tmx.nd._LEGACY_NPX_QUEUED


# -- broadcast dropout masks -------------------------------------------------

@pytest.mark.parametrize("axes", [(1,), (0, 2), 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_axes_contract(axes, dtype):
    """The port's mask is drawn over the shape with ``axes`` set to 1 (the
    dropout kernel's plain version on ones, the bits K5 draws for the
    key) and broadcast; the product is rounded once to x's dtype."""
    p = 0.3
    x = torch.from_numpy(_x((40, 24, 32), 13)).to(dtype)
    x.requires_grad_(True)
    tmxrandom.seed(5)
    with tautograd.train_mode():
        y = tmx.npx.dropout(x, p=p, axes=axes)
    tmxrandom.seed(5)
    key = tmxrandom.next_key()
    ax = (axes,) if isinstance(axes, int) else axes
    shape = [1 if i in ax else n for i, n in enumerate(x.shape)]
    keep = ph.keep_mask(tuple(shape), key, p, device=x.device)
    scale = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    want = (x.detach().float() * torch.where(keep, scale, 0.0)).to(dtype)
    assert y.dtype == dtype and torch.equal(y, want)
    kept = (y != 0) | (x == 0)
    assert torch.equal(kept, keep.expand_as(kept) | (x == 0))
    n = keep.numel()
    frac = keep.float().mean().item()
    assert abs(frac - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad, torch.where(keep, scale, 0.0)
                       .expand_as(x).to(dtype))
    tmxrandom.seed(5)
    with tautograd.train_mode():
        again = tmx.npx.dropout(x.detach(), p=p, axes=axes)
        assert torch.equal(again, y.detach())
        assert tmx.npx.dropout(x, p=0.0, axes=axes) is x
    assert tmx.npx.dropout(x, p=p, axes=axes) is x          # not training


def test_dropout_axes_reference_contract_on_both():
    """Both packages keep the mask constant along ``axes`` and scale the
    kept values by 1 / (1 - p), through NDArrays and gluon's Dropout."""
    a = onp.abs(_x((16, 12, 10), 14)) + 0.5
    for mx in (jmx, tmx):
        with tmx.cpu():
            mx.random.seed(3)
            with mx.autograd.train_mode():
                y = mx.npx.dropout(mx.np.array(a), p=0.5, axes=(1,))
                z = mx.gluon.nn.Dropout(0.5, axes=(0, 2))(mx.np.array(a))
            y, z = y.asnumpy(), z.asnumpy()
        for out, ax in ((y, 1), (z, (0, 2))):
            keep = out != 0
            first = keep.take([0], axis=ax[0] if isinstance(ax, tuple)
                              else ax)
            if isinstance(ax, tuple):
                first = keep[:1, :, :1]
            assert (keep == first).all()
            onp.testing.assert_allclose(out[keep], (a * 2.0)[keep],
                                        rtol=1e-6)
