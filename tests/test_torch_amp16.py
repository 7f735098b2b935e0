"""AMP with the float16 target, multi-precision optimizers and the ``mp_*``
optimizer ops of the port, against the JAX package's, on the CPU.

- A `bert_small` (64 units, 2 layers, 4 heads, FFN 128; vocab 97,
  max_length 32) with the JAX model's scaled random weights, under
  ``amp.init("float16")`` on both sides, dropout 0: the dtypes the
  kernels meet (flash attention f16, every residual site f32 x with an
  f16 h, the MLM LayerNorm an f16 x with f32 gamma/beta), scores and loss
  normwise within 2^-8 and 2^-10 (float16 keeps 3 more mantissa bits than
  bfloat16, whose bounds are 2^-5 and 2^-8; measured on the CPU: 0.0016
  for the MLM scores, 0.0020 for the NSP scores, 0.00007 for the loss),
  each gradient within twice the reference's own distance from the
  float32 gradient and at least 2^-10, as the bfloat16 test holds them
  (measured: at most 0.63 of that bound).
- Every rule with ``multi_precision=True`` on float16 weights, three
  updates: the f32 master within the rule's float32 tolerance of the
  reference's master (1e-6 of the largest magnitude, 1e-5 for the normed
  rules), the float16 weight its master's cast bit for bit on the port
  and within one float16 spacing of the reference's weight.
- `Trainer.save_states`/`load_states` with multi-precision states: the
  reference's ``("mp", master, [inner...])`` layout, read by the other
  package both ways, bit for bit.
- Each ``mp_*``, ``multi_mp_*`` and ``preloaded_multi_mp_*`` op against
  the reference's on the same float16 weights and gradients and f32
  masters: ``weight32`` and the states within 1e-6 relative, the weight
  within one float16 spacing (each side rounds its own master once).
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import autograd, gluon, np
from incubator_mxnet_tpu.models.bert import bert_small as jax_bert_small
from incubator_mxnet_tpu_torch import amp
from incubator_mxnet_tpu_torch import numpy_extension as tnpx
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import bert_small

VOCAB, T = 97, 24
SCORE_TOL, LOSS_TOL = 2.0 ** -8, 2.0 ** -10
GRAD_TIMES, GRAD_FLOOR = 2.0, 2.0 ** -10
F16_SPACING = 2.0 ** -10


def _data():
    r = onp.random.RandomState(1)
    tok = r.randint(0, VOCAB, (3, T)).astype("int32")
    lab = r.randint(0, VOCAB, (3, T)).astype("int32")
    return tok, lab, onp.asarray([T, 11, 5], "int32")


def _rel(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    return onp.linalg.norm(got - want) / onp.linalg.norm(want)


def _dt(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return onp.dtype(a.dtype).name


@pytest.fixture(scope="module")
def ref():
    """Scaled random weights; the JAX model's float16 AMP step (scores,
    loss, gradients) and its float32 gradients."""
    jmx.random.seed(3)
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(0)
    for _name, p in jm.collect_params().items():
        if len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.2, p.shape).astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    tok, lab, vl = _data()
    out = {}
    for target in ("float16", None):
        if target:
            jamp.init(target)
        try:
            with autograd.record():
                mlm, nsp = jm(np.array(tok), None, np.array(vl))
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(mlm,
                                                            np.array(lab))
            loss.backward()
        finally:
            jamp.deinit()
        out[target] = dict(
            mlm=onp.asarray(mlm.asnumpy(), onp.float32),
            nsp=onp.asarray(nsp.asnumpy(), onp.float32),
            loss=loss.asnumpy(),
            grads={n: p.grad().asnumpy().copy() for n, p in
                   jm.collect_params().items() if p.grad() is not None})
        for p in jm.collect_params().values():
            p.zero_grad()
    return params, out


def _port(params):
    tm = bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0,
                    device="cpu", seed=0)
    tm.load_jax_params(params)
    return tm.train()


def _amp16_step(tm, sites=None):
    tok, lab, vl = _data()
    patch = pytest.MonkeyPatch()
    if sites is not None:
        for name in ("layer_norm", "flash_attention", "residual_dropout_ln"):
            fn = getattr(tnpx, name)

            def rec(*args, _fn=fn, _name=name, **kwargs):
                res = _fn(*args, **kwargs)
                sites.setdefault(_name, set()).add(
                    (tuple(_dt(a) for a in args[:3]), _dt(res)))
                return res
            patch.setattr(tnpx, name, rec)
    amp.init("float16")
    try:
        mlm, nsp = tm(torch.from_numpy(tok).long(),
                      valid_length=torch.from_numpy(vl))
        loss = SoftmaxCrossEntropyLoss()(mlm, torch.from_numpy(lab))
        loss.sum().backward()
    finally:
        amp.deinit()
        patch.undo()
    return mlm, nsp, loss


def test_f16_amp_meets_the_kernels_float16_layouts(ref):
    sites = {}
    mlm, nsp, loss = _amp16_step(_port(ref[0]), sites)
    f32, f16 = "float32", "float16"
    assert sites["flash_attention"] == {((f16,) * 3, f16)}
    assert sites["residual_dropout_ln"] == {((f32, f16, f32), f32)}
    assert sites["layer_norm"] == {((f32, f32, f32), f32),
                                   ((f16, f32, f32), f16)}
    assert mlm.dtype == nsp.dtype == torch.float16
    assert loss.dtype == torch.float32


def test_f16_amp_scores_loss_and_gradients_match_jax(ref):
    params, out = ref
    tm = _port(params)
    mlm, nsp, loss = _amp16_step(tm)
    want = out["float16"]
    assert _rel(mlm.detach().float().numpy(), want["mlm"]) <= SCORE_TOL
    assert _rel(nsp.detach().float().numpy(), want["nsp"]) <= SCORE_TOL
    assert _rel(loss.detach().numpy(), want["loss"]) <= LOSS_TOL
    f32 = out[None]["grads"]
    for name, p in tm.named_parameters():
        w = want["grads"].get(name)
        if p.grad is None:
            assert w is None or not onp.abs(w).any(), name
            continue
        assert p.grad.dtype == torch.float32, name
        assert onp.isfinite(p.grad.numpy()).all(), name
        tol = max(GRAD_TIMES * _rel(w, f32[name]), GRAD_FLOOR)
        assert _rel(p.grad.numpy(), w) <= tol, name


def _jax_model(params):
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    for n, p in jm.collect_params().items():
        p.set_data(np.array(params[n]))
    return jm


def test_convert_model_to_float16_matches_jax(ref):
    """Every parameter float16 (the residual stream too): scores within
    2^-7 normwise of the reference's converted model (the bfloat16 bound
    2^-4 at float16's precision; measured on the CPU: 0.0017)."""
    tok, _, vl = _data()
    jm = jamp.convert_model(_jax_model(ref[0]), "float16")
    want, _ = jm(np.array(tok), None, np.array(vl))
    tm = amp.convert_model(_port(ref[0]).eval(), "float16")
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(tok).long(),
                    valid_length=torch.from_numpy(vl))
    assert got.dtype == torch.float16 and _dt(want) == "float16"
    assert _rel(got.float().numpy(), onp.asarray(want.asnumpy(),
                                                 onp.float32)) <= 2.0 ** -7


def test_convert_hybrid_block_to_float16_matches_jax(ref):
    """Dense and Embedding in float16, LayerNorm and the position
    embedding kept float32, AMP float16 inside the wrapper: scores within
    2^-8 normwise of the reference's (measured on the CPU: 0.0016)."""
    tok, _, vl = _data()
    jw = jamp.convert_hybrid_block(_jax_model(ref[0]), "float16")
    want, _ = jw(np.array(tok), None, np.array(vl))
    tm = _port(ref[0]).eval()
    tw = amp.convert_hybrid_block(tm, "float16")
    kept = {n for n, p in tm.named_parameters() if p.dtype == torch.float32}
    assert kept == {n for n in ref[0] if n.endswith(("gamma", "beta"))
                    or n == "encoder.position_embed"}
    with torch.no_grad():
        got, _ = tw(torch.from_numpy(tok).long(), None,
                    torch.from_numpy(vl))
    assert not amp.amp_active()
    assert got.dtype == torch.float32 and _dt(want) == "float32"
    assert _rel(got.numpy(), want.asnumpy()) <= 2.0 ** -8


def test_init_float16_scale_loss_and_has_overflow():
    """``init("float16")`` sets the target; ``has_overflow`` reads a
    Parameter's gradient (or a tensor's) where it lies and finds an
    inf."""
    amp.init("float16")
    try:
        assert amp.amp_active() and amp.amp_dtype() == torch.float16
        assert amp.op_cast_mode("batch_dot") == ("target", "float16")
        x = torch.ones(2)
        assert amp.cast_inputs("fully_connected", x)[0].dtype == \
            torch.float16
    finally:
        amp.deinit()
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        params = net.collect_params()
        scaler = amp.LossScaler()
        assert not scaler.has_overflow(params)          # no gradient yet
        x = tmx.np.ones((2, 4))
        with tmx.autograd.record():
            y = net(x).sum()
        y.backward()
        assert not scaler.has_overflow(params)
        assert not scaler.has_overflow(list(params.values()))
        net.weight.data()._data.grad[0, 0] = float("inf")
        assert scaler.has_overflow(params)
        assert scaler.has_overflow([net.weight.data()._data])


# -- multi-precision rules ---------------------------------------------------

CASES = {
    "sgd": ("SGD", dict(momentum=0.9)),
    "sgd_plain": ("SGD", {}),
    "nag": ("NAG", dict(momentum=0.9)),
    "adam": ("Adam", {}),
    "adamw": ("AdamW", {}),
    "adabelief": ("AdaBelief", {}),
    "adadelta": ("AdaDelta", {}),
    "adagrad": ("AdaGrad", {}),
    "adamax": ("Adamax", {}),
    "dcasgd": ("DCASGD", dict(momentum=0.9)),
    "ftml": ("FTML", {}),
    "ftrl": ("FTRL", {}),
    "lamb": ("LAMB", dict(lower_bound=0.1, upper_bound=10.0)),
    "lans": ("LANS", {}),
    "lars": ("LARS", {}),
    "nadam": ("Nadam", {}),
    "rmsprop": ("RMSProp", {}),
    "signum": ("Signum", {}),
    "groupadagrad": ("GroupAdaGrad", {}),
}
NORMED = ("LAMB", "LANS", "LARS")


def _mp_run(mx, cls, kw, w0, grads):
    opt = getattr(mx.optimizer, cls)(learning_rate=0.05, rescale_grad=0.5,
                                     wd=0.01, multi_precision=True, **kw)
    w = mx.np.array(w0).astype("float16")
    state = opt.create_state_multi_precision(0, w)
    for g in grads:
        new = opt.update_multi_precision(
            0, w, mx.np.array(g).astype("float16"), state)
        state = state if new is None else new
    return w.asnumpy(), onp.asarray(state[0] if not hasattr(state[0],
                                                             "numpy")
                                    else state[0].numpy()), state


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_precision_rule_matches_the_reference(case):
    cls, kw = CASES[case]
    r = onp.random.RandomState(5)
    w0 = r.normal(0, 1.0, (7, 5)).astype("float32")
    grads = [r.normal(0, 1.0, (7, 5)).astype("float32") for _ in range(3)]
    jw, jmaster, _ = _mp_run(jmx, cls, kw, w0, grads)
    with tmx.cpu():
        tw, tmaster, state = _mp_run(tmx, cls, kw, w0, grads)
    assert isinstance(state, tuple) and state[0].dtype == torch.float32
    assert tw.dtype == onp.float16
    tol = 1e-5 if cls in NORMED else 1e-6
    scale = float(onp.abs(jmaster).max())
    onp.testing.assert_allclose(tmaster, jmaster, rtol=tol, atol=tol * scale)
    onp.testing.assert_array_equal(tw, tmaster.astype(onp.float16))
    onp.testing.assert_allclose(tw.astype("float32"),
                                onp.asarray(jw, "float32"),
                                rtol=F16_SPACING, atol=1e-6)
    assert not onp.array_equal(tmaster, w0.astype(onp.float16)
                               .astype(onp.float32))


def test_multi_precision_leaves_f32_weights_and_off_alone():
    """A float32 weight takes the plain rule; without multi_precision a
    float16 weight is updated in float16 with no master."""
    with tmx.cpu():
        opt = tmx.optimizer.Adam(multi_precision=True)
        w32 = tmx.np.ones((3,))
        assert isinstance(opt.create_state_multi_precision(0, w32), list)
        off = tmx.optimizer.Adam()
        w16 = tmx.np.ones((3,)).astype("float16")
        st = off.create_state_multi_precision(0, w16)
        assert isinstance(st, list) and st[0].dtype == torch.float16
        off.update_multi_precision(0, w16, tmx.np.ones((3,)).astype(
            "float16"), st)
        assert w16.dtype == onp.float16 and (w16.asnumpy() < 1).all()


def _mp_net(mx, weights):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=6),
            mx.gluon.nn.Dense(3, in_units=8))
    net.initialize()
    for n, p in net.collect_params().items():
        p.set_data(mx.np.array(weights[n]))
    net.cast("float16")
    return net


def test_trainer_multi_precision_states_cross_the_packages(tmp_path):
    """Two steps of ``Trainer("adam", multi_precision=True)`` over a
    float16 net on each package; each saves its states and the other
    loads them: masters, moments and update counts bit for bit; the
    port's float16 weights are their masters' casts after every step."""
    r = onp.random.RandomState(0)
    weights = {"0.weight": r.normal(0, 0.3, (8, 6)).astype("float32"),
               "0.bias": r.normal(0, 0.1, (8,)).astype("float32"),
               "1.weight": r.normal(0, 0.3, (3, 8)).astype("float32"),
               "1.bias": r.normal(0, 0.1, (3,)).astype("float32")}
    x = r.uniform(size=(5, 6)).astype("float32")
    y = r.randint(0, 3, (5,)).astype("int32")
    trainers = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            net = _mp_net(mx, weights)
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 1e-2,
                                   "multi_precision": True})
            lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            for _ in range(2):
                with mx.autograd.record():
                    loss = lf(net(mx.np.array(x).astype("float16")),
                              mx.np.array(y))
                loss.backward()
                tr.step(5)
                if mx is tmx:
                    for (n, p), st in zip(sorted(
                            net.collect_params().items()), tr._states):
                        assert torch.equal(p.data()._data,
                                           st[0].half()), n
            trainers[mx] = (tr, net)
    for src, dst in ((tmx, jmx), (jmx, tmx)):
        f = str(tmp_path / f"{src.__name__}.states")
        trainers[src][0].save_states(f)
        with tmx.cpu():
            other = dst.gluon.Trainer(
                _mp_net(dst, weights).collect_params(), "adam",
                {"multi_precision": True})
            other.load_states(f)
        assert other._optimizer._index_update_count == \
            trainers[src][0]._optimizer._index_update_count
        for a, b in zip(trainers[src][0]._states, other._states):
            assert isinstance(b, tuple) and len(b) == 2
            pairs = [(a[0], b[0])] + list(zip(a[1], b[1]))
            for u, v in pairs:
                onp.testing.assert_array_equal(_host(u), _host(v))


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return onp.asarray(a)


# -- the mp_* optimizer ops --------------------------------------------------

def _mp_arrays(mx, seed, n_states):
    r = onp.random.RandomState(seed)
    w32 = r.normal(0, 1, (4, 6)).astype("float32")
    g = r.normal(0, 1, (4, 6)).astype("float32")
    states = [onp.abs(r.normal(0, 0.5, (4, 6))).astype("float32")
              for _ in range(n_states)]
    return (mx.np.array(w32).astype("float16"),
            mx.np.array(g).astype("float16"),
            [mx.np.array(s) for s in states], mx.np.array(w32))


MP_OPS = {
    "mp_sgd_update": (0, lambda nd, w, g, s, w32: nd.mp_sgd_update(
        w, g, w32, 0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.8,
        out=w)),
    "mp_sgd_mom_update": (1, lambda nd, w, g, s, w32: nd.mp_sgd_mom_update(
        w, g, s[0], w32, 0.1, momentum=0.9, wd=0.01, out=w)),
    "mp_nag_mom_update": (1, lambda nd, w, g, s, w32: nd.mp_nag_mom_update(
        w, g, s[0], w32, 0.1, momentum=0.9, wd=0.01, out=w)),
    "mp_adamw_update": (2, lambda nd, w, g, s, w32: nd.mp_adamw_update(
        w, g, s[0], s[1], w32, 0.5, 0.01, 1.0, wd=0.01, out=w)),
    "mp_adabelief_update": (2, lambda nd, w, g, s, w32:
                            nd.mp_adabelief_update(w, g, s[0], s[1], w32,
                                                   0.01, wd=0.01, out=w)),
    "mp_lamb": (2, lambda nd, w, g, s, w32: nd.mp_lamb_update_phase2(
        w, nd.mp_lamb_update_phase1(w, g, s[0], s[1], w32, t=2, wd=0.01),
        nd.norm(w32), nd.norm(g), w32, 0.01, out=w)),
    "multi_mp_sgd_update": (0, lambda nd, w, g, s, w32:
                            nd.multi_mp_sgd_update(w, g, w32, lrs=[0.1],
                                                   wds=[0.01], out=[w])),
    "multi_mp_sgd_mom_update": (1, lambda nd, w, g, s, w32:
                                nd.multi_mp_sgd_mom_update(
                                    w, g, s[0], w32, lrs=[0.1], wds=[0.0],
                                    momentum=0.9, out=[w])),
    "preloaded_multi_mp_sgd_update": (0, lambda nd, w, g, s, w32:
                                      nd.preloaded_multi_mp_sgd_update(
                                          w, g, w32,
                                          nd.array(onp.asarray([0.1])),
                                          nd.array(onp.asarray([0.01])),
                                          out=[w])),
    "preloaded_multi_mp_sgd_mom_update": (
        1, lambda nd, w, g, s, w32: nd.preloaded_multi_mp_sgd_mom_update(
            w, g, s[0], w32, nd.array(onp.asarray([0.1])),
            nd.array(onp.asarray([0.0])), momentum=0.9, out=[w])),
    "multi_mp_adamw_update": (2, lambda nd, w, g, s, w32:
                              nd.multi_mp_adamw_update(
                                  w, g, s[0], s[1], w32,
                                  nd.array(onp.asarray(0.5)),
                                  learning_rates=[0.01], wds=[0.01],
                                  etas=[1.0], out=[w])),
    "multi_mp_adabelief_update": (2, lambda nd, w, g, s, w32:
                                  nd.multi_mp_adabelief_update(
                                      w, g, s[0], s[1], w32,
                                      learning_rates=[0.01], wds=[0.01],
                                      out=[w])),
    "multi_mp_lamb_update": (2, lambda nd, w, g, s, w32:
                             nd.multi_mp_lamb_update(
                                 w, g, s[0], s[1], w32,
                                 learning_rates=[0.01], wds=[0.01],
                                 step_count=[2], out=[w])),
    "multi_mp_lans_update": (2, lambda nd, w, g, s, w32:
                             nd.multi_mp_lans_update(
                                 w, g, s[0], s[1], w32,
                                 learning_rates=[0.01], wds=[0.01],
                                 step_count=[2], out=[w])),
}


@pytest.mark.parametrize("name", sorted(MP_OPS))
def test_mp_op_matches_the_reference(name):
    n_states, call = MP_OPS[name]
    outs = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            w, g, s, w32 = _mp_arrays(mx, 3, n_states)
            call(mx.nd, w, g, s, w32)
            outs.append((w.asnumpy(), w32.asnumpy(),
                         [a.asnumpy() for a in s]))
    (jw, jw32, js), (tw, tw32, ts) = outs
    assert tw.dtype == onp.float16
    scale = float(onp.abs(jw32).max())
    onp.testing.assert_allclose(tw32, jw32, rtol=1e-6, atol=1e-6 * scale)
    for a, b in zip(ts, js):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    onp.testing.assert_array_equal(tw, tw32.astype(onp.float16))
    onp.testing.assert_allclose(tw.astype("float32"),
                                onp.asarray(jw, "float32"),
                                rtol=F16_SPACING, atol=1e-6)
    r = onp.random.RandomState(3)
    assert not onp.array_equal(tw32, r.normal(0, 1, (4, 6))
                               .astype("float32"))
