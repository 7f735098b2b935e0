"""The optimizers and schedulers of the port against the JAX package:
every rule over three updates of the same weight, gradients and state,
with ``rescale_grad``, ``clip_gradient``, weight decay, a Parameter's
``lr_mult``/``wd_mult``, ``set_lr_mult``/``set_wd_mult`` and a learning
rate scheduler; the rules' device-scalar form (`DataParallel`'s) against
their host form; the schedulers number for number.

Tolerance: 1e-6 relative to the weight's largest magnitude in float32;
1e-5 where the rule takes a norm (LAMB, LANS, LARS). SGLD's noise comes
from another generator, so it is held to its law.
"""
import types

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

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
    "lamb_nobc": ("LAMB", dict(bias_correction=False)),
    "lans": ("LANS", {}),
    "lars": ("LARS", {}),
    "nadam": ("Nadam", {}),
    "rmsprop": ("RMSProp", {}),
    "rmsprop_centered": ("RMSProp", dict(centered=True, clip_weights=0.6)),
    "signum": ("Signum", {}),
    "signum_plain": ("Signum", dict(momentum=0.0, wd_lh=0.01)),
    "groupadagrad": ("GroupAdaGrad", {}),
}
NORMED = ("LAMB", "LANS", "LARS")
SHAPE = (7, 5)


def _make(mx, cls, kw):
    sched = mx.lr_scheduler.FactorScheduler(step=1, factor=0.9,
                                            base_lr=0.05)
    opt = getattr(mx.optimizer, cls)(learning_rate=0.05, rescale_grad=0.5,
                                     clip_gradient=0.8, wd=0.01,
                                     lr_scheduler=sched, **kw)
    opt.idx2name = {0: "w"}
    opt.param_dict = {"w": types.SimpleNamespace(lr_mult=0.7, wd_mult=1.5)}
    opt.set_lr_mult({"w": 0.9})
    opt.set_wd_mult({"w": 2.0})
    return opt


def _run(mx, cls, kw, w0, grads):
    opt = _make(mx, cls, kw)
    ctx = tmx.cpu() if mx is tmx else None
    if ctx is not None:
        ctx.__enter__()
    try:
        w = mx.np.array(w0)
        state = opt.create_state_multi_precision(0, w)
        for g in grads:
            opt.update(0, w, mx.np.array(g), state)
        return w.asnumpy(), opt
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


def _inputs(seed=0):
    r = onp.random.RandomState(seed)
    w0 = r.normal(0, 1.0, SHAPE).astype("float32")
    grads = [r.normal(0, 1.0, SHAPE).astype("float32") for _ in range(3)]
    return w0, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_matches_the_reference_over_three_updates(case):
    cls, kw = CASES[case]
    w0, grads = _inputs()
    want, jopt = _run(jmx, cls, kw, w0, grads)
    got, topt = _run(tmx, cls, kw, w0, grads)
    tol = 1e-5 if cls in NORMED else 1e-6
    scale = float(onp.abs(want).max())
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)
    assert not onp.array_equal(got, w0)
    assert topt.num_update == jopt.num_update == 3
    assert topt.learning_rate == pytest.approx(jopt.learning_rate)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c][0] != "Nadam"))
def test_device_scalars_give_the_host_numbers(case):
    """`DataParallel` passes lr, wd (float64) and t (int64) as 0-dim
    tensors; every replayable rule gives the numbers of its host form."""
    cls, kw = CASES[case]
    w0, grads = _inputs(1)
    outs = []
    for dev in (False, True):
        opt = getattr(tmx.optimizer, cls)(learning_rate=0.05,
                                          rescale_grad=0.5, wd=0.01, **kw)
        w = torch.from_numpy(w0.copy())
        state = opt.create_state(0, w)
        for t, g in enumerate(grads, 1):
            lr, wd, tt = 0.05, 0.01, t
            if dev:
                lr = torch.tensor(lr, dtype=torch.float64)
                wd = torch.tensor(wd, dtype=torch.float64)
                tt = torch.tensor(t, dtype=torch.int64)
            with torch.no_grad():
                opt.step(w, torch.from_numpy(g), state, lr, wd, tt)
        outs.append(w.numpy())
    onp.testing.assert_allclose(outs[1], outs[0], rtol=1e-6,
                                atol=1e-6 * float(onp.abs(outs[0]).max()))


def test_unreplayable_rules_raise_for_a_device_t():
    w = torch.zeros(3)
    t = torch.tensor(1)
    for cls in ("Nadam", "SGLD"):
        opt = getattr(tmx.optimizer, cls)()
        with pytest.raises(MXNetError):
            opt.step(w, torch.ones(3), opt.create_state(0, w), 0.1, 0.0, t)


def test_sgld_noise_holds_its_law():
    lr = 0.01
    w0 = onp.zeros((256, 256), "float32")
    g = onp.full((256, 256), 2.0, "float32")
    opt = tmx.optimizer.SGLD(learning_rate=lr)
    tmx.random.seed(1)
    w = torch.from_numpy(w0.copy())
    opt.update(0, w, torch.from_numpy(g), None)
    noise = (w.numpy() - (w0 - lr / 2 * g)) / lr ** 0.5
    assert abs(noise.mean()) < 0.02 and abs(noise.std() - 1.0) < 0.02


def test_registry_updater_and_what_raises():
    assert isinstance(tmx.optimizer.create("adamw"), tmx.optimizer.AdamW)
    assert isinstance(tmx.optimizer.create("ftrl"), tmx.optimizer.Ftrl)
    with pytest.raises(ValueError):
        tmx.optimizer.create("nope")
    opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.5)
    up = tmx.optimizer.get_updater(opt)
    w = torch.ones(4)
    up(0, torch.ones(4), w)
    onp.testing.assert_allclose(w.numpy(), 0.9 * onp.ones(4), rtol=1e-6)
    blob = up.get_states()
    up2 = tmx.optimizer.get_updater(opt)
    up2.set_states(blob)
    assert torch.equal(up2.states[0][0], up.states[0][0])
    sched = tmx.lr_scheduler.FactorScheduler(step=2)
    with pytest.raises(UserWarning):
        tmx.optimizer.Adam(lr_scheduler=sched).set_learning_rate(0.1)
    with pytest.raises(MXNetError):
        tmx.optimizer.Adam()._sparse_update(w, w, None, 0.1, 0.0, 1)


SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=7, factor=0.5,
                                       stop_factor_lr=1e-3, base_lr=0.1,
                                       warmup_steps=5, warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(step=[10, 20, 35],
                                                 factor=0.3, base_lr=0.2,
                                                 warmup_steps=4,
                                                 warmup_mode="constant")),
    "poly": ("PolyScheduler", dict(max_update=40, base_lr=0.3, pwr=2,
                                   final_lr=0.01, warmup_steps=6)),
    "cosine": ("CosineScheduler", dict(max_update=45, base_lr=0.25,
                                       final_lr=0.02, warmup_steps=3,
                                       warmup_begin_lr=0.001)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_matches_the_reference(case):
    cls, kw = SCHEDULERS[case]
    a = getattr(jmx.lr_scheduler, cls)(**kw)
    b = getattr(tmx.lr_scheduler, cls)(**kw)
    assert [b(n) for n in range(60)] == [a(n) for n in range(60)]


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c not in ("nadam",)))
def test_step_multi_equals_the_per_parameter_step(case):
    """`DataParallel`'s small-parameter segment (`step_multi`) gives each
    rule's own per-parameter numbers (Adam's fused form included), with
    device scalars."""
    cls, kw = CASES[case]
    r = onp.random.RandomState(4)
    ws = [r.normal(size=s).astype("float32") for s in ((5, 3), (4,), (7,))]
    gs = [r.normal(size=w.shape).astype("float32") for w in ws]
    lr = torch.tensor(0.05, dtype=torch.float64)
    wd = torch.tensor(0.01, dtype=torch.float64)
    t = torch.tensor(2, dtype=torch.int64)
    outs = []
    for multi in (False, True):
        opt = getattr(tmx.optimizer, cls)(learning_rate=0.05,
                                          rescale_grad=0.5,
                                          clip_gradient=0.8, **kw)
        w = [torch.from_numpy(x.copy()) for x in ws]
        st = [opt.create_state(i, x) for i, x in enumerate(w)]
        g = [torch.from_numpy(x) for x in gs]
        with torch.no_grad():
            if multi:
                opt.step_multi(w, g, st, lr, wd, t)
            else:
                for a, b, c in zip(w, g, st):
                    opt.step(a, b, c, lr, wd, t)
        outs.append(w)
    for a, b in zip(*outs):
        onp.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                    atol=1e-7)


# nd.optim_ops: (op, array names, kwargs, the states it rebinds)
OPS = {
    "sgd_update": (["w", "g"], dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                                    clip_gradient=0.8), 0),
    "sgd_mom_update": (["w", "g", "s0"], dict(lr=0.1, momentum=0.9,
                                              wd=0.01), 1),
    "nag_mom_update": (["w", "g", "s0"], dict(lr=0.1, momentum=0.9,
                                              wd=0.01), 1),
    "signsgd_update": (["w", "g"], dict(lr=0.1, wd=0.01), 0),
    "signum_update": (["w", "g", "s0"], dict(lr=0.1, momentum=0.9,
                                             wd=0.01, wd_lh=0.01), 1),
    "adam_update": (["w", "g", "s0", "p1"], dict(lr=0.01, wd=0.01,
                                                 clip_gradient=1.0), 2),
    "adamw_update": (["w", "g", "s0", "p1"], dict(rescale_grad=0.5,
                                                  lr=0.01, eta=0.9,
                                                  wd=0.01), 2),
    "adabelief_update": (["w", "g", "s0", "p1"], dict(lr=0.01, wd=0.01),
                         2),
    "ftml_update": (["w", "g", "s0", "p1", "s2"], dict(lr=0.01, t=2,
                                                       wd=0.01), 3),
    "ftrl_update": (["w", "g", "s0", "p1"], dict(lr=0.1, wd=0.01), 2),
    "rmsprop_update": (["w", "g", "p1"], dict(lr=0.01, wd=0.01,
                                              clip_weights=0.9), 1),
    "rmspropalex_update": (["w", "g", "p1", "s0", "s2"], dict(lr=0.01,
                                                               wd=0.01), 3),
    "lamb_update_phase1": (["w", "g", "s0", "p1"], dict(t=3, wd=0.01), 2),
    "group_adagrad_update": (["w", "g", "h"], dict(lr=0.1), 1),
    "sparse_adagrad_update": (["w", "g", "p1"], dict(lr=0.1, wd=0.01), 1),
}


def _op_arrays(seed):
    r = onp.random.RandomState(seed)
    return {"w": r.normal(size=(6, 4)).astype("float32"),
            "g": r.normal(size=(6, 4)).astype("float32"),
            "s0": r.normal(0, 0.1, (6, 4)).astype("float32"),
            "s2": r.normal(0, 0.1, (6, 4)).astype("float32"),
            "p1": r.uniform(0.1, 1.0, (6, 4)).astype("float32"),
            "h": r.uniform(0.1, 1.0, (6,)).astype("float32")}


def _op_run(mx, op, a):
    names, kw, n_states = OPS[op]
    arrs = [mx.nd.array(a[n]) for n in names]
    res = getattr(mx.nd, op)(*arrs, out=arrs[0], **kw)
    assert res is arrs[0]
    return [x.asnumpy() for x in arrs[:1] + arrs[2:2 + n_states]]


@pytest.mark.parametrize("op", sorted(OPS))
def test_nd_optim_op_matches_the_reference(op):
    """`nd.<op>(..., out=weight)`: the weight and every state array the op
    rebinds, against the reference's op on the same arrays."""
    a = _op_arrays(sorted(OPS).index(op))
    want = _op_run(jmx, op, a)
    with tmx.cpu():
        got = _op_run(tmx, op, a)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_nd_optim_multi_forms_match_the_reference():
    a = _op_arrays(7)
    b = _op_arrays(8)

    def run(mx):
        ws = [mx.nd.array(a["w"]), mx.nd.array(b["w"])]
        gs = [mx.nd.array(a["g"]), mx.nd.array(b["g"])]
        ms = [mx.nd.array(a["s0"]), mx.nd.array(b["s0"])]
        vs = [mx.nd.array(a["p1"]), mx.nd.array(b["p1"])]
        mx.nd.multi_sgd_mom_update(ws[0], gs[0], ms[0], ws[1], gs[1], ms[1],
                                   lrs=[0.1, 0.2], wds=[0.0, 0.01],
                                   momentum=0.9, num_weights=2, out=ws)
        mx.nd.preloaded_multi_sgd_update(
            ws[0], gs[0], ws[1], gs[1], mx.nd.array([0.05, 0.1]),
            mx.nd.array([0.01, 0.0]), num_weights=2, out=ws)
        mx.nd.multi_lamb_update(ws[0], gs[0], ms[0], vs[0], ws[1], gs[1],
                                ms[1], vs[1], learning_rates=[0.01, 0.02],
                                wds=[0.01, 0.0], step_count=[1, 2],
                                num_tensors=2, out=ws)
        mx.nd.multi_lans_update(ws[0], gs[0], ms[0], vs[0], ws[1], gs[1],
                                ms[1], vs[1], learning_rates=[0.01, 0.02],
                                wds=[0.01, 0.0], step_count=[2, 3],
                                num_tensors=2, out=ws)
        mx.nd.multi_adamw_update(ws[0], gs[0], ms[0], vs[0], ws[1], gs[1],
                                 ms[1], vs[1], mx.nd.array(0.5),
                                 learning_rates=[0.01, 0.02],
                                 wds=[0.01, 0.0], etas=[1.0, 0.5],
                                 num_weights=2, out=ws)
        ss = mx.nd.multi_sum_sq(ws[0], gs[0], num_arrays=2)
        lrs = mx.nd.multi_lars(mx.nd.array([0.1, 0.2]), ss[:1].reshape(1)
                               * mx.nd.array([1.0, 1.0]),
                               ss[1:].reshape(1) * mx.nd.array([1.0, 2.0]),
                               mx.nd.array([0.0, 0.01]))
        sq = mx.nd.square_sum(gs[1], axis=1, keepdims=True)
        mx.nd.reset_arrays(gs[0], gs[1], num_arrays=2)
        return [x.asnumpy() for x in ws + ms + vs + [ss, lrs, sq] + gs]

    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_nd_optim_multi_precision_forms_raise():
    """The multi-precision forms are ported (they raised before float16
    came): each takes a float16 weight and its f32 master, updates the
    master and writes its cast into ``out``
    (`tests/test_torch_amp16.py` holds them to the reference's)."""
    with tmx.cpu():
        w32 = tmx.nd.array(onp.full((2, 2), 0.5, "float32"))
        g = tmx.nd.array(onp.ones((2, 2), "float16"))
        m = tmx.nd.array(onp.zeros((2, 2), "float32"))
        lrs = tmx.nd.array(onp.asarray([0.1]))
        wds = tmx.nd.array(onp.asarray([0.0]))
        calls = (lambda w: tmx.nd.mp_sgd_update(w, g, w32, 0.1, out=w),
                 lambda w: tmx.nd.multi_mp_sgd_update(w, g, w32, lrs=[0.1],
                                                      wds=[0.0], out=[w]),
                 lambda w: tmx.nd.mp_adamw_update(w, g, m, m, w32, 1.0, 0.1,
                                                  1.0, out=w),
                 lambda w: tmx.nd.preloaded_multi_mp_sgd_mom_update(
                     w, g, m, w32, lrs, wds, out=[w]),
                 lambda w: tmx.nd.mp_lamb_update_phase2(w, g, w32, w32, w32,
                                                        0.1, out=w))
        for call in calls:
            w = w32.astype("float16")
            before = w32.asnumpy()
            call(w)
            assert w.dtype == onp.float16
            assert not onp.array_equal(w32.asnumpy(), before)
            onp.testing.assert_array_equal(
                w.asnumpy(), w32.asnumpy().astype(onp.float16))
