"""`autograd` of the port against the JAX package's: each scenario runs
the same code on both packages (the port on the CPU, ``with
mx.cpu():``) with the same seeded numpy inputs, and what it returns
(gradients, values, dtypes, raised errors) is compared, values within
1e-5 relative (f32 on both sides). The scenarios are the semantics the
reference has and torch does not give by itself: ``grad_req``, the
all-ones head gradient, the head that is not on the tape, a second
``backward`` over the same graph, zeros for an unreached variable,
``create_graph``, the custom ``Function``."""
import contextlib

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6

_R = onp.random.RandomState(3)
X0 = _R.uniform(-1.5, 1.5, (3, 4)).astype("float32")
W0 = _R.uniform(-1, 1, (4, 2)).astype("float32")
H0 = _R.uniform(-1, 1, (3, 2)).astype("float32")


def _scope(mx):
    return mx.cpu() if mx is tmx else contextlib.nullcontext()


def _out(v):
    if hasattr(v, "asnumpy"):
        return ("array", v.asnumpy(), onp.dtype(v.dtype).name)
    if isinstance(v, (list, tuple)):
        return [_out(x) for x in v]
    return v


def s_basic(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    return [x.grad, y]


def s_chain_ops(mx):
    np = mx.np
    x, w = np.array(X0), np.array(W0)
    x.attach_grad()
    w.attach_grad()
    with mx.autograd.record():
        h = np.tanh(np.dot(x, w))
        y = (np.exp(h) * np.array(H0)).mean() + np.sum(np.square(x[1:, :2]))
    y.backward()
    return [x.grad, w.grad, y]


def s_flags(mx):
    ag = mx.autograd
    out = [ag.is_recording(), ag.is_training()]
    with ag.record():
        out += [ag.is_recording(), ag.is_training()]
        with ag.pause():
            out += [ag.is_recording(), ag.is_training()]
        with ag.predict_mode():
            out += [ag.is_training()]
    with ag.record(train_mode=False):
        out += [ag.is_training()]
    with ag.train_mode():
        out += [ag.is_training(), ag.is_recording()]
    prev = ag.set_training(True)
    out += [prev, ag.is_training(), ag.set_training(prev)]
    prev = ag.set_recording(True)
    out += [prev, ag.is_recording(), ag.set_recording(prev)]
    return out


def s_grad_req_write_overwrites(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    with mx.autograd.record():
        z = (x * 3.0).sum()
    z.backward()
    return x.grad


def s_grad_req_add_accumulates(mx):
    x = mx.np.array(X0)
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
    return x.grad


def s_grad_req_null(mx):
    x, w = mx.np.array(X0), mx.np.array(W0)
    x.attach_grad(grad_req="null")
    w.attach_grad()
    with mx.autograd.record():
        y = mx.np.dot(x, w).sum()
    y.backward()
    return [x.grad, w.grad]


def s_nonscalar_head_ones(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2.0 + x * x
    y.backward()
    return x.grad


def s_head_grads(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.np.sin(x)
    y.backward(mx.np.array(X0 * 0.5))
    return x.grad


def s_head_not_on_tape(mx):
    x = mx.np.array(X0)
    y = (x * x).sum()
    with pytest.raises(ValueError) as e:
        y.backward()
    return str(e.value)


def s_backward_twice(mx):
    x, w = mx.np.array(X0), mx.np.array(W0)
    x.attach_grad()
    w.attach_grad()
    with mx.autograd.record():
        y = mx.np.tanh(mx.np.dot(x, w)).sum()
    y.backward()
    first = [x.grad.asnumpy(), w.grad.asnumpy()]
    y.backward()
    return [first, x.grad, w.grad]


def s_backward_twice_add(mx):
    x = mx.np.array(X0)
    x.attach_grad(grad_req="add")
    with mx.autograd.record():
        y = (mx.np.exp(x) * x).sum()
    y.backward()
    y.backward()
    return x.grad


def s_grad_unreached_is_zero(mx):
    x, w = mx.np.array(X0), mx.np.array(W0)
    x.attach_grad()
    w.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    return mx.autograd.grad(y, [x, w])


def s_grad_single_variable(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.np.sin(x) * x
    g = mx.autograd.grad(y, x)
    return [g, x.grad]


def s_create_graph_second_order(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = (x ** 3).sum()
        (dx,) = mx.autograd.grad([y], [x], create_graph=True)
        s = dx.sum()
    s.backward()
    return [dx, x.grad]


def s_create_graph_matmul(mx):
    w = mx.np.array(W0[:2])
    w.attach_grad()
    with mx.autograd.record():
        y = mx.np.dot(w, w).sum()
        (dw,) = mx.autograd.grad([y], [w], create_graph=True)
        s = (dw * dw).sum()
    s.backward()
    return [dw, w.grad]


def s_pause_stops_recording(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        with mx.autograd.pause():
            c = x * 2.0
        y = (c * x).sum()
    y.backward()
    return x.grad


def s_detach(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = (x.detach() * x).sum()
    y.backward()
    return x.grad


def s_inplace_and_setitem(mx):
    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = x * 1.0
        y += x * x
        y[0] = x[1] * 3.0
        z = y.sum()
    z.backward()
    return [x.grad, y]


def s_mark_variables(mx):
    x = mx.np.array(X0)
    g = mx.np.zeros(X0.shape)
    mx.autograd.mark_variables([x], [g], grad_reqs="write")
    with mx.autograd.record():
        y = (x * x * x).sum()
    y.backward()
    return [x.grad, g]


def s_custom_function(mx):
    seen = []

    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            seen.append((mx.autograd.is_recording(),
                         mx.autograd.is_training()))
            y = 1.0 / (1.0 + mx.np.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1.0 - y)

    x = mx.np.array(X0)
    x.attach_grad()
    with mx.autograd.record():
        y = Sigmoid()(x)
        z = (y * y).sum()
    z.backward()
    return [y, x.grad, seen]


def s_custom_function_two_inputs(mx):
    class Mul(mx.autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b

        def backward(self, dy):
            a, b = self.saved_tensors
            return dy * b * 2.0, dy * a    # 2x on a: the custom rule counts

    a, b = mx.np.array(X0), mx.np.array(X0 + 1.0)
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        y = Mul()(a, b).sum()
    y.backward()
    return [a.grad, b.grad]


def s_dtypes_x64_off(mx):
    np = mx.np
    return [np.array(onp.ones(3, "float64")), np.array(onp.ones(3, "int64")),
            np.arange(5), np.array([1.5, 2.0]), np.array([1, 2]),
            np.array(X0).argmax(), np.argmax(np.array(X0), axis=1),
            np.array(X0).astype("float64"), np.sum(np.array([1, 2, 3])),
            np.array([True, False]).sum(), np.array([3]) / np.array([2])]


def s_check_numeric_gradient(mx):
    mx.test_utils.check_numeric_gradient(
        lambda a, b: mx.np.tanh(a) * b + a * a,
        [mx.np.array(X0[:2, :2]), mx.np.array(W0[:2])], eps=1e-2,
        rtol=1e-2, atol=1e-3)
    return True


SCENARIOS = {n[2:]: f for n, f in sorted(globals().items())
             if n.startswith("s_") and callable(f)}


def _cmp(got, want, path="out"):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got)
        for i, (g, w) in enumerate(zip(got, want)):
            _cmp(g, w, f"{path}[{i}]")
    elif isinstance(want, tuple) and want and want[0] == "array":
        assert isinstance(got, tuple) and got[0] == "array", (path, got)
        assert got[2] == want[2], (path, "dtype", got[2], want[2])
        assert got[1].shape == want[1].shape, (path, got[1].shape,
                                               want[1].shape)
        onp.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL,
                                    err_msg=path)
    elif isinstance(want, onp.ndarray):
        onp.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                    err_msg=path)
    elif isinstance(want, tuple):
        _cmp(list(got), list(want), path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autograd_scenario_matches_reference(name):
    fn = SCENARIOS[name]
    with _scope(tmx):
        got = _out(fn(tmx))
    want = _out(fn(jmx))
    _cmp(got, want)


def test_grad_of_unattached_variable_raises():
    with tmx.cpu():
        x = tmx.np.array(X0)
        w = tmx.np.array(W0)
        w.attach_grad()
        with tmx.autograd.record():
            y = tmx.np.dot(x, w).sum()
        with pytest.raises(tmx.MXNetError, match="attach_grad"):
            tmx.autograd.grad(y, x)


def test_graph_is_torch_autograd_no_second_tape():
    """The port records on torch's graph: an op's output under record()
    has a grad_fn, outside it none, and pause() keeps it off."""
    with tmx.cpu():
        x = tmx.np.array(X0)
        x.attach_grad()
        assert x._data.is_leaf and x._data.requires_grad
        with tmx.autograd.record():
            y = x * 2.0
            with tmx.autograd.pause():
                p = x * 2.0
        z = x * 2.0
    assert y._data.grad_fn is not None
    assert p._data.grad_fn is None and z._data.grad_fn is None
