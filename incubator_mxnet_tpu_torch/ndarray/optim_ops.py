"""Functional optimizer-update ops (port of
`incubator_mxnet_tpu/ndarray/optim_ops.py`; reference
`src/operator/optimizer_op.cc` + `contrib/optimizer_op.cc` +
`contrib/multi_*` / `preloaded_multi_*` / `adamw.cc` / `lamb.cc`).

The reference exposes each optimizer's update rule as an imperative op
(`nd.sgd_update(w, g, out=w, lr=...)`). Here, as there, each op is one
call through the NDArray funnel over torch tensors with the reference's
arithmetic; the state arrays (`mom`, `mean`, `var`, ...) are rebound to
their new values and the updated weight lands in `out` (conventionally
the weight itself), the reference's no-alias mutation discipline
(:58-75). These are the eager ops of scripts; `gluon.Trainer` and
`parallel.DataParallel` update through `optimizer.Optimizer.step`, in
place.

Multi-tensor variants (`multi_sgd_update`, `preloaded_*`) take the
reference's interleaved argument layout and make one call per tensor.
The multi-precision forms (``mp_*``, ``multi_mp_*``, ``preloaded_multi_mp_*``)
take a float16 weight and its f32 master ``weight32``: the rule runs on
``weight32`` with the gradient in f32, ``weight32`` is rebound to its new
value, and the weight (``out``) takes its cast to the weight's dtype.
`sparse_adagrad_update` takes dense gradients only (row-sparse storage
is ROADMAP.md §1 item 11b).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .ndarray import NDArray, apply_op, apply_op_flat, array, unwrap_arrays

__all__ = [
    "sgd_update", "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
    "nag_mom_update", "mp_nag_mom_update", "signsgd_update",
    "signum_update", "adam_update", "adamw_update", "mp_adamw_update",
    "adabelief_update", "mp_adabelief_update", "ftml_update",
    "ftrl_update", "rmsprop_update", "rmspropalex_update",
    "lamb_update_phase1", "lamb_update_phase2", "mp_lamb_update_phase1",
    "mp_lamb_update_phase2", "multi_sgd_update", "multi_sgd_mom_update",
    "multi_mp_sgd_update", "multi_mp_sgd_mom_update",
    "preloaded_multi_sgd_update", "preloaded_multi_sgd_mom_update",
    "preloaded_multi_mp_sgd_update", "preloaded_multi_mp_sgd_mom_update",
    "multi_lamb_update", "multi_mp_lamb_update", "multi_lans_update",
    "multi_mp_lans_update", "multi_adamw_update", "multi_mp_adamw_update",
    "multi_adabelief_update", "multi_mp_adabelief_update",
    "multi_sum_sq", "multi_lars", "reset_arrays",
    "sparse_adagrad_update", "group_adagrad_update", "square_sum",
]

def _pg(g, rescale, clip):
    """rescale then (optionally) clip the gradient: the preamble every
    reference update kernel shares."""
    g = g * rescale
    if clip is not None and clip > 0:
        g = g.clamp(-clip, clip)
    return g


def _finish(out, weight, new_w):  # noqa: ARG001
    """Reference out-semantics: write into `out` when given (typically
    the weight itself), else return a fresh array."""
    if out is not None:
        out._adopt(new_w if isinstance(new_w, NDArray) else NDArray(new_w))
        return out
    return new_w


def _mutate(state, new_val):
    state._set_data(new_val._data if isinstance(new_val, NDArray)
                    else new_val)


_WARNED_IGNORED: set = set()


def _ignored_arg(op, arg, value):
    """An argument accepted for the reference's API and ignored (dense
    updates have no lazy/standard split): said once per argument, and
    counted in ``mx_ignored_arg_total{arg=...}``."""
    if value is None:
        return
    from ..telemetry import registry

    registry.counter(
        "mx_ignored_arg_total",
        "explicitly-passed arguments this build accepts but ignores",
        labels={"arg": arg}).inc()
    if arg not in _WARNED_IGNORED:
        _WARNED_IGNORED.add(arg)
        import warnings

        warnings.warn(
            f"{op}: argument '{arg}={value!r}' is accepted for reference "
            "API compatibility but IGNORED by this build (dense updates "
            "have no lazy/standard split). Counted in "
            "mx_ignored_arg_total{arg=\"" + arg + "\"}.",
            stacklevel=3)


# --------------------------------------------------------------- SGD family

def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=None, out=None):
    """w ← w − lr·(rescale·clip(g) + wd·w) (optimizer_op.cc SGDUpdate)."""
    _ignored_arg("sgd_update", "lazy_update", lazy_update)

    def fn(w, g):
        return w - lr * (_pg(g, rescale_grad, clip_gradient) + wd * w)

    new_w = apply_op("sgd_update", fn, (weight, grad),
                     static_info=("h", lr, wd, rescale_grad,
                                  clip_gradient))
    return _finish(out, weight, new_w)


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0,
                   lazy_update=None, out=None):
    """m ← μ·m − lr·(g + wd·w); w ← w + m."""
    _ignored_arg("sgd_mom_update", "lazy_update", lazy_update)

    def fn(w, g, m):
        m2 = momentum * m - lr * (_pg(g, rescale_grad, clip_gradient)
                                  + wd * w)
        return w + m2, m2

    new_w, new_m = apply_op("sgd_mom_update", fn, (weight, grad, mom),
                            n_outputs=2,
                            static_info=("h", lr, momentum, wd,
                                         rescale_grad, clip_gradient))
    _mutate(mom, new_m)
    return _finish(out, weight, new_w)


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=None, out=None):
    """Mixed-precision SGD: fp32 master `weight32` updated, low-precision
    weight is its cast."""
    _ignored_arg("mp_sgd_update", "lazy_update", lazy_update)

    def fn(w, g, w32):
        g32 = _pg(g.float(), rescale_grad, clip_gradient)
        w32n = w32 - lr * (g32 + wd * w32)
        return w32n.to(w.dtype), w32n

    new_w, new_w32 = apply_op("mp_sgd_update", fn,
                              (weight, grad, weight32), n_outputs=2,
                              static_info=("h", lr, wd, rescale_grad,
                                           clip_gradient))
    _mutate(weight32, new_w32)
    return _finish(out, weight, new_w)


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=None, out=None):
    _ignored_arg("mp_sgd_mom_update", "lazy_update", lazy_update)

    def fn(w, g, m, w32):
        g32 = _pg(g.float(), rescale_grad, clip_gradient)
        m2 = momentum * m - lr * (g32 + wd * w32)
        w32n = w32 + m2
        return w32n.to(w.dtype), m2, w32n

    new_w, new_m, new_w32 = apply_op(
        "mp_sgd_mom_update", fn, (weight, grad, mom, weight32),
        n_outputs=3, static_info=("h", lr, momentum, wd, rescale_grad,
                                  clip_gradient))
    _mutate(mom, new_m)
    _mutate(weight32, new_w32)
    return _finish(out, weight, new_w)


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """Nesterov momentum (optimizer_op.cc NAGMomUpdate):
    m ← μ·m + g + wd·w; w ← w − lr·(g + μ·m)."""
    def fn(w, g, m):
        gr = _pg(g, rescale_grad, clip_gradient) + wd * w
        m2 = momentum * m + gr
        return w - lr * (gr + momentum * m2), m2

    new_w, new_m = apply_op("nag_mom_update", fn, (weight, grad, mom),
                            n_outputs=2,
                            static_info=("h", lr, momentum, wd,
                                         rescale_grad, clip_gradient))
    _mutate(mom, new_m)
    return _finish(out, weight, new_w)


def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      out=None):
    def fn(w, g, m, w32):
        gr = _pg(g.float(), rescale_grad, clip_gradient) \
            + wd * w32
        m2 = momentum * m + gr
        w32n = w32 - lr * (gr + momentum * m2)
        return w32n.to(w.dtype), m2, w32n

    new_w, new_m, new_w32 = apply_op(
        "mp_nag_mom_update", fn, (weight, grad, mom, weight32),
        n_outputs=3, static_info=("h", lr, momentum, wd, rescale_grad,
                                  clip_gradient))
    _mutate(mom, new_m)
    _mutate(weight32, new_w32)
    return _finish(out, weight, new_w)


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None):
    """w ← (1−lr·wd)·w − lr·sign(g) (optimizer_op.cc SignSGDUpdate)."""
    def fn(w, g):
        return (1 - lr * wd) * w \
            - lr * torch.sign(_pg(g, rescale_grad, clip_gradient))

    new_w = apply_op("signsgd_update", fn, (weight, grad),
                     static_info=("h", lr, wd, rescale_grad,
                                  clip_gradient))
    return _finish(out, weight, new_w)


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0,
                  out=None):
    """Signum (optimizer_op.cc SignumUpdate): momentum on the gradient,
    sign taken for the step."""
    def fn(w, g, m):
        gr = _pg(g, rescale_grad, clip_gradient) + wd * w
        m2 = momentum * m - (1 - momentum) * gr
        return (1 - lr * wd_lh) * w + lr * torch.sign(m2), m2

    new_w, new_m = apply_op("signum_update", fn, (weight, grad, mom),
                            n_outputs=2,
                            static_info=("h", lr, momentum, wd,
                                         rescale_grad, clip_gradient,
                                         wd_lh))
    _mutate(mom, new_m)
    return _finish(out, weight, new_w)


# -------------------------------------------------------------- Adam family

def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=None, out=None):
    """optimizer_op.cc AdamUpdate — bias correction is the CALLER's job
    (the Python Optimizer folds it into lr), exactly like the
    reference."""
    _ignored_arg("adam_update", "lazy_update", lazy_update)

    def fn(w, g, m, v):
        gr = _pg(g, rescale_grad, clip_gradient) + wd * w
        m2 = beta1 * m + (1 - beta1) * gr
        v2 = beta2 * v + (1 - beta2) * gr * gr
        return w - lr * m2 / (torch.sqrt(v2) + epsilon), m2, v2

    new_w, new_m, new_v = apply_op(
        "adam_update", fn, (weight, grad, mean, var), n_outputs=3,
        static_info=("h", lr, beta1, beta2, epsilon, wd, rescale_grad,
                     clip_gradient))
    _mutate(mean, new_m)
    _mutate(var, new_v)
    return _finish(out, weight, new_w)


def adamw_update(weight, grad, mean, var, rescale_grad, lr, eta,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 clip_gradient=-1.0, out=None):
    """AdamW (adamw.cc): decoupled weight decay, `rescale_grad` is a
    TENSOR (dynamic loss scale) — a NaN/Inf scale skips the update,
    matching the reference's all_finite gate."""
    def fn(w, g, m, v, rs):
        ok = torch.isfinite(rs).all()
        gr = _pg(g, rs, clip_gradient)
        m2 = beta1 * m + (1 - beta1) * gr
        v2 = beta2 * v + (1 - beta2) * gr * gr
        w2 = w - eta * (lr * m2 / (torch.sqrt(v2) + epsilon) + wd * w)
        return (torch.where(ok, w2, w), torch.where(ok, m2, m),
                torch.where(ok, v2, v))

    if not isinstance(rescale_grad, NDArray):
        rescale_grad = array(float(rescale_grad), device=weight.device)
    new_w, new_m, new_v = apply_op(
        "adamw_update", fn, (weight, grad, mean, var, rescale_grad),
        n_outputs=3, static_info=("h", lr, eta, beta1, beta2, epsilon,
                                  wd, clip_gradient))
    _mutate(mean, new_m)
    _mutate(var, new_v)
    return _finish(out, weight, new_w)


def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad,
                    lr, eta, beta1=0.9, beta2=0.999, epsilon=1e-8,
                    wd=0.0, clip_gradient=-1.0, out=None):
    def fn(w, g, m, v, w32, rs):
        ok = torch.isfinite(rs).all()
        gr = _pg(g.float(), rs, clip_gradient)
        m2 = beta1 * m + (1 - beta1) * gr
        v2 = beta2 * v + (1 - beta2) * gr * gr
        w32n = w32 - eta * (lr * m2 / (torch.sqrt(v2) + epsilon)
                            + wd * w32)
        w32n = torch.where(ok, w32n, w32)
        return (w32n.to(w.dtype), torch.where(ok, m2, m),
                torch.where(ok, v2, v), w32n)

    if not isinstance(rescale_grad, NDArray):
        rescale_grad = array(float(rescale_grad), device=weight.device)
    new_w, new_m, new_v, new_w32 = apply_op(
        "mp_adamw_update", fn,
        (weight, grad, mean, var, weight32, rescale_grad), n_outputs=4,
        static_info=("h", lr, eta, beta1, beta2, epsilon, wd,
                     clip_gradient))
    _mutate(mean, new_m)
    _mutate(var, new_v)
    _mutate(weight32, new_w32)
    return _finish(out, weight, new_w)


def adabelief_update(weight, grad, mean, var, lr, beta1=0.9,
                     beta2=0.999, epsilon=1e-8, wd=0.0,
                     rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """AdaBelief (contrib adabelief.cc): variance of (g − m) instead of
    g²."""
    def fn(w, g, m, v):
        gr = _pg(g, rescale_grad, clip_gradient) + wd * w
        m2 = beta1 * m + (1 - beta1) * gr
        diff = gr - m2
        v2 = beta2 * v + (1 - beta2) * diff * diff + epsilon
        return w - lr * m2 / (torch.sqrt(v2) + epsilon), m2, v2

    new_w, new_m, new_v = apply_op(
        "adabelief_update", fn, (weight, grad, mean, var), n_outputs=3,
        static_info=("h", lr, beta1, beta2, epsilon, wd, rescale_grad,
                     clip_gradient))
    _mutate(mean, new_m)
    _mutate(var, new_v)
    return _finish(out, weight, new_w)


def mp_adabelief_update(weight, grad, mean, var, weight32, lr,
                        beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0, out=None):
    def fn(w, g, m, v, w32):
        gr = _pg(g.float(), rescale_grad, clip_gradient) \
            + wd * w32
        m2 = beta1 * m + (1 - beta1) * gr
        diff = gr - m2
        v2 = beta2 * v + (1 - beta2) * diff * diff + epsilon
        w32n = w32 - lr * m2 / (torch.sqrt(v2) + epsilon)
        return w32n.to(w.dtype), m2, v2, w32n

    new_w, new_m, new_v, new_w32 = apply_op(
        "mp_adabelief_update", fn, (weight, grad, mean, var, weight32),
        n_outputs=4, static_info=("h", lr, beta1, beta2, epsilon, wd,
                                  rescale_grad, clip_gradient))
    _mutate(mean, new_m)
    _mutate(var, new_v)
    _mutate(weight32, new_w32)
    return _finish(out, weight, new_w)


def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0, out=None):
    """FTML (optimizer_op.cc FTMLUpdate)."""
    def fn(w, g, d0, v0, z0):
        gr = _pg(g, rescale_grad, clip_grad) + wd * w
        v2 = beta2 * v0 + (1 - beta2) * gr * gr
        d2 = (1 - beta1 ** t) / lr * (
            torch.sqrt(v2 / (1 - beta2 ** t)) + epsilon)
        sigma = d2 - beta1 * d0
        z2 = beta1 * z0 + (1 - beta1) * gr - sigma * w
        return -z2 / d2, d2, v2, z2

    new_w, new_d, new_v, new_z = apply_op(
        "ftml_update", fn, (weight, grad, d, v, z), n_outputs=4,
        static_info=("h", lr, beta1, beta2, epsilon, int(t), wd,
                     rescale_grad, clip_grad))
    _mutate(d, new_d)
    _mutate(v, new_v)
    _mutate(z, new_z)
    return _finish(out, weight, new_w)


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """FTRL (optimizer_op.cc FtrlUpdate)."""
    def fn(w, g, z0, n0):
        gr = _pg(g, rescale_grad, clip_gradient)
        n2 = n0 + gr * gr
        sigma = (torch.sqrt(n2) - torch.sqrt(n0)) / lr
        z2 = z0 + gr - sigma * w
        w2 = torch.where(
            torch.abs(z2) <= lamda1, torch.zeros_like(w),
            -(z2 - torch.sign(z2) * lamda1)
            / ((beta + torch.sqrt(n2)) / lr + wd))
        return w2, z2, n2

    new_w, new_z, new_n = apply_op(
        "ftrl_update", fn, (weight, grad, z, n), n_outputs=3,
        static_info=("h", lr, lamda1, beta, wd, rescale_grad,
                     clip_gradient))
    _mutate(z, new_z)
    _mutate(n, new_n)
    return _finish(out, weight, new_w)


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0, out=None):
    """RMSProp, uncentered (optimizer_op.cc RMSPropUpdate)."""
    def fn(w, g, n0):
        gr = _pg(g, rescale_grad, clip_gradient) + wd * w
        n2 = gamma1 * n0 + (1 - gamma1) * gr * gr
        # reference kernel: sqrt(n) + eps OUTSIDE the root
        # (optimizer_op-inl.h RMSPropUpdateKernel)
        w2 = w - lr * gr / (torch.sqrt(n2) + epsilon)
        if clip_weights is not None and clip_weights > 0:
            w2 = w2.clamp(-clip_weights, clip_weights)
        return w2, n2

    new_w, new_n = apply_op("rmsprop_update", fn, (weight, grad, n),
                            n_outputs=2,
                            static_info=("h", lr, gamma1, epsilon, wd,
                                         rescale_grad, clip_gradient,
                                         clip_weights))
    _mutate(n, new_n)
    return _finish(out, weight, new_w)


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0, out=None):
    """Graves' centered RMSProp (optimizer_op.cc RMSPropAlexUpdate)."""
    def fn(w, gr_in, n0, g0, d0):
        gr = _pg(gr_in, rescale_grad, clip_gradient) + wd * w
        n2 = gamma1 * n0 + (1 - gamma1) * gr * gr
        g2 = gamma1 * g0 + (1 - gamma1) * gr
        d2 = gamma2 * d0 - lr * gr / torch.sqrt(n2 - g2 * g2 + epsilon)
        w2 = w + d2
        if clip_weights is not None and clip_weights > 0:
            w2 = w2.clamp(-clip_weights, clip_weights)
        return w2, n2, g2, d2

    new_w, new_n, new_g, new_d = apply_op(
        "rmspropalex_update", fn, (weight, grad, n, g, delta),
        n_outputs=4, static_info=("h", lr, gamma1, gamma2, epsilon, wd,
                                  rescale_grad, clip_gradient,
                                  clip_weights))
    _mutate(n, new_n)
    _mutate(g, new_g)
    _mutate(delta, new_d)
    return _finish(out, weight, new_w)


# -------------------------------------------------------------- LAMB family

def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """LAMB phase 1 (lamb.cc): the un-trust-scaled update direction."""
    def fn(w, g, m, v):
        gr = _pg(g, rescale_grad, clip_gradient)
        m2 = beta1 * m + (1 - beta1) * gr
        v2 = beta2 * v + (1 - beta2) * gr * gr
        mh, vh = m2, v2
        if bias_correction:
            mh = m2 / (1 - beta1 ** t)
            vh = v2 / (1 - beta2 ** t)
        return mh / (torch.sqrt(vh) + epsilon) + wd * w, m2, v2

    new_g, new_m, new_v = apply_op(
        "lamb_update_phase1", fn, (weight, grad, mean, var), n_outputs=3,
        static_info=("h", beta1, beta2, epsilon, int(t),
                     bool(bias_correction), wd, rescale_grad,
                     clip_gradient))
    _mutate(mean, new_m)
    _mutate(var, new_v)
    return _finish(out, weight, new_g)


def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0, out=None):
    """LAMB phase 2 (lamb.cc): apply the trust ratio r1/r2."""
    def fn(w, gg, rr1, rr2):
        ratio = torch.where((rr1 > 0) & (rr2 > 0), rr1 / rr2, 1.0)
        if lower_bound is not None and lower_bound > 0:
            ratio = torch.clamp(ratio, min=lower_bound)
        if upper_bound is not None and upper_bound > 0:
            ratio = torch.clamp(ratio, max=upper_bound)
        return w - lr * ratio * gg

    new_w = apply_op("lamb_update_phase2", fn, (weight, g, r1, r2),
                     static_info=("h", lr, lower_bound, upper_bound))
    return _finish(out, weight, new_w)


def mp_lamb_update_phase1(weight, grad, mean, var, weight32, **kwargs):
    """Multi-precision LAMB phase 1: direction computed in fp32."""
    out = kwargs.pop("out", None)
    g32 = NDArray(grad._data.float())
    return lamb_update_phase1(NDArray(weight32._data), g32, mean, var,
                              out=out, **kwargs)


def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr,
                          lower_bound=-1.0, upper_bound=-1.0, out=None):
    new32 = lamb_update_phase2(NDArray(weight32._data), g, r1, r2, lr,
                               lower_bound, upper_bound)
    _mutate(weight32, new32)
    new_w = NDArray(new32._data.to(weight._data.dtype))
    return _finish(out, weight, new_w)


# ------------------------------------------------------ multi-tensor family

def _pairs(args, stride):
    return [args[i:i + stride] for i in range(0, len(args), stride)]


def _multi(name, args, stride, rule, num_weights, out=None):
    groups = _pairs(list(args), stride)[:num_weights]
    if isinstance(out, NDArray):     # single-output spelling
        out = [out]
    outs = out if isinstance(out, (list, tuple)) else None
    results = []
    for i, grp in enumerate(groups):
        o = outs[i] if outs else None
        results.append(rule(i, grp, o))
    return results


def multi_sgd_update(*args, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1, out=None):
    """Interleaved (w0,g0,w1,g1,…) multi-tensor SGD
    (contrib multi_sgd.cc)."""
    return _multi(
        "multi_sgd_update", args, 2,
        lambda i, grp, o: sgd_update(
            grp[0], grp[1], lrs[i], wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient, out=o),
        num_weights, out)


def multi_sgd_mom_update(*args, lrs=None, wds=None, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1, out=None):
    return _multi(
        "multi_sgd_mom_update", args, 3,
        lambda i, grp, o: sgd_mom_update(
            grp[0], grp[1], grp[2], lrs[i], momentum=momentum,
            wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient, out=o),
        num_weights, out)


def multi_mp_sgd_update(*args, lrs=None, wds=None, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1, out=None):
    return _multi(
        "multi_mp_sgd_update", args, 3,
        lambda i, grp, o: mp_sgd_update(
            grp[0], grp[1], grp[2], lrs[i], wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient,
            out=o),
        num_weights, out)


def multi_mp_sgd_mom_update(*args, lrs=None, wds=None, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1, out=None):
    return _multi(
        "multi_mp_sgd_mom_update", args, 4,
        lambda i, grp, o: mp_sgd_mom_update(
            grp[0], grp[1], grp[2], grp[3], lrs[i], momentum=momentum,
            wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient, out=o),
        num_weights, out)


def _preloaded(args, stride, num_weights):
    """Split (…tensors…, lrs, wds) trailing-array layout."""
    tensors = args[:-2]
    lrs = [float(v) for v in args[-2].asnumpy()]
    wds = [float(v) for v in args[-1].asnumpy()]
    return tensors, lrs, wds


def preloaded_multi_sgd_update(*args, num_weights=1, rescale_grad=1.0,
                               clip_gradient=-1.0, out=None):
    tensors, lrs, wds = _preloaded(args, 2, num_weights)
    return multi_sgd_update(*tensors, lrs=lrs, wds=wds,
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient,
                            num_weights=num_weights, out=out)


def preloaded_multi_sgd_mom_update(*args, num_weights=1, momentum=0.0,
                                   rescale_grad=1.0, clip_gradient=-1.0,
                                   out=None):
    tensors, lrs, wds = _preloaded(args, 3, num_weights)
    return multi_sgd_mom_update(*tensors, lrs=lrs, wds=wds,
                                momentum=momentum,
                                rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient,
                                num_weights=num_weights, out=out)


def preloaded_multi_mp_sgd_update(*args, num_weights=1, rescale_grad=1.0,
                                  clip_gradient=-1.0, out=None):
    tensors, lrs, wds = _preloaded(args, 3, num_weights)
    return multi_mp_sgd_update(*tensors, lrs=lrs, wds=wds,
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient,
                               num_weights=num_weights, out=out)


def preloaded_multi_mp_sgd_mom_update(*args, num_weights=1, momentum=0.0,
                                      rescale_grad=1.0,
                                      clip_gradient=-1.0, out=None):
    tensors, lrs, wds = _preloaded(args, 4, num_weights)
    return multi_mp_sgd_mom_update(*tensors, lrs=lrs, wds=wds,
                                   momentum=momentum,
                                   rescale_grad=rescale_grad,
                                   clip_gradient=clip_gradient,
                                   num_weights=num_weights, out=out)


def _lamb_full(weight, grad, mean, var, lr, wd, beta1, beta2, epsilon,
               t, bias_correction, rescale_grad, clip_gradient,
               lower_bound, upper_bound, out):
    g = lamb_update_phase1(weight, grad, mean, var, beta1=beta1,
                           beta2=beta2, epsilon=epsilon, t=t,
                           bias_correction=bias_correction, wd=wd,
                           rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient)
    from .. import numpy as _np

    r1 = _np.sqrt(_np.sum(_np.square(weight)))
    r2 = _np.sqrt(_np.sum(_np.square(g)))
    return lamb_update_phase2(weight, g, r1, r2, lr,
                              lower_bound=lower_bound,
                              upper_bound=upper_bound, out=out)


def multi_lamb_update(*args, learning_rates=None, wds=None, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, step_count=None,
                      bias_correction=True, rescale_grad=1.0,
                      clip_gradient=-1.0, lower_bound=-1.0,
                      upper_bound=-1.0, num_tensors=1, out=None):
    """Multi-tensor LAMB (contrib lamb.cc): (w,g,m,v) quadruples."""
    lrs = learning_rates
    steps = step_count or [1] * num_tensors
    return _multi(
        "multi_lamb_update", args, 4,
        lambda i, grp, o: _lamb_full(
            grp[0], grp[1], grp[2], grp[3], lrs[i], wds[i], beta1,
            beta2, epsilon, steps[i], bias_correction, rescale_grad,
            clip_gradient, lower_bound, upper_bound, o),
        num_tensors, out)


def multi_mp_lamb_update(*args, learning_rates=None, wds=None,
                         beta1=0.9, beta2=0.999, epsilon=1e-6,
                         step_count=None, bias_correction=True,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         lower_bound=-1.0, upper_bound=-1.0,
                         num_tensors=1, out=None):
    lrs = learning_rates
    steps = step_count or [1] * num_tensors

    def rule(i, grp, o):
        w, g, m, v, w32 = grp
        new32 = _lamb_full(NDArray(w32._data), NDArray(g._data.float()), m, v, lrs[i], wds[i], beta1, beta2, epsilon,
            steps[i], bias_correction, rescale_grad, clip_gradient,
            lower_bound, upper_bound, None)
        _mutate(w32, new32)
        return _finish(o, w, NDArray(new32._data.to(w._data.dtype)))

    return _multi("multi_mp_lamb_update", args, 5, rule, num_tensors,
                  out)


def _lans_full(weight, grad, mean, var, lr, wd, beta1, beta2, epsilon,
               t, rescale_grad, clip_gradient, out):
    """LANS (contrib lans.cc): LAMB with an extra normalized-gradient
    momentum-free term; both terms trust-scaled."""
    from .. import numpy as _np

    def fn(w, g, m, v):
        gr = _pg(g, rescale_grad, clip_gradient)
        gn = gr / (torch.sqrt(torch.sum(gr * gr)) + 1e-12)
        m2 = beta1 * m + (1 - beta1) * gn
        v2 = beta2 * v + (1 - beta2) * gn * gn
        mh = m2 / (1 - beta1 ** t)
        vh = v2 / (1 - beta2 ** t)
        d1 = mh / (torch.sqrt(vh) + epsilon) + wd * w
        d2 = gn / (torch.sqrt(vh) + epsilon) + wd * w
        return d1, d2, m2, v2

    d1, d2, new_m, new_v = apply_op(
        "lans_phase1", fn, (weight, grad, mean, var), n_outputs=4,
        static_info=("h", beta1, beta2, epsilon, int(t), wd,
                     rescale_grad, clip_gradient))
    _mutate(mean, new_m)
    _mutate(var, new_v)
    r1 = _np.sqrt(_np.sum(_np.square(weight)))
    rd1 = _np.sqrt(_np.sum(_np.square(d1)))
    rd2 = _np.sqrt(_np.sum(_np.square(d2)))
    w1 = lamb_update_phase2(weight, d1, r1, rd1, lr * beta1)
    w2 = lamb_update_phase2(w1, d2, r1, rd2, lr * (1 - beta1))
    return _finish(out, weight, w2)


def multi_lans_update(*args, learning_rates=None, wds=None, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, step_count=None,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      num_tensors=1, out=None):
    lrs = learning_rates
    steps = step_count or [1] * num_tensors
    return _multi(
        "multi_lans_update", args, 4,
        lambda i, grp, o: _lans_full(
            grp[0], grp[1], grp[2], grp[3], lrs[i], wds[i], beta1,
            beta2, epsilon, steps[i], rescale_grad, clip_gradient, o),
        num_tensors, out)


def multi_mp_lans_update(*args, learning_rates=None, wds=None,
                         beta1=0.9, beta2=0.999, epsilon=1e-6,
                         step_count=None, rescale_grad=1.0,
                         clip_gradient=-1.0, num_tensors=1, out=None):
    lrs = learning_rates
    steps = step_count or [1] * num_tensors

    def rule(i, grp, o):
        w, g, m, v, w32 = grp
        new32 = _lans_full(NDArray(w32._data),
                           NDArray(g._data.float()), m, v,
                           lrs[i], wds[i], beta1, beta2, epsilon,
                           steps[i], rescale_grad, clip_gradient, None)
        _mutate(w32, new32)
        return _finish(o, w, NDArray(new32._data.to(w._data.dtype)))

    return _multi("multi_mp_lans_update", args, 5, rule, num_tensors,
                  out)


def multi_adamw_update(*args, learning_rates=None, wds=None, etas=None,
                       beta1=0.9, beta2=0.999, epsilon=1e-8,
                       clip_gradient=-1.0, num_weights=1, out=None):
    """(w,g,m,v) quadruples + trailing rescale_grad tensor
    (contrib adamw.cc multi variant)."""
    rescale = args[-1]
    return _multi(
        "multi_adamw_update", args[:-1], 4,
        lambda i, grp, o: adamw_update(
            grp[0], grp[1], grp[2], grp[3], rescale,
            learning_rates[i], etas[i], beta1=beta1, beta2=beta2,
            epsilon=epsilon, wd=wds[i], clip_gradient=clip_gradient,
            out=o),
        num_weights, out)


def multi_mp_adamw_update(*args, learning_rates=None, wds=None,
                          etas=None, beta1=0.9, beta2=0.999,
                          epsilon=1e-8, clip_gradient=-1.0,
                          num_weights=1, out=None):
    rescale = args[-1]
    return _multi(
        "multi_mp_adamw_update", args[:-1], 5,
        lambda i, grp, o: mp_adamw_update(
            grp[0], grp[1], grp[2], grp[3], grp[4], rescale,
            learning_rates[i], etas[i], beta1=beta1, beta2=beta2,
            epsilon=epsilon, wd=wds[i], clip_gradient=clip_gradient,
            out=o),
        num_weights, out)


def multi_adabelief_update(*args, learning_rates=None, wds=None,
                           beta1=0.9, beta2=0.999, epsilon=1e-8,
                           rescale_grad=1.0, clip_gradient=-1.0,
                           num_weights=1, out=None):
    return _multi(
        "multi_adabelief_update", args, 4,
        lambda i, grp, o: adabelief_update(
            grp[0], grp[1], grp[2], grp[3], learning_rates[i],
            beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient,
            out=o),
        num_weights, out)


def multi_mp_adabelief_update(*args, learning_rates=None, wds=None,
                              beta1=0.9, beta2=0.999, epsilon=1e-8,
                              rescale_grad=1.0, clip_gradient=-1.0,
                              num_weights=1, out=None):
    return _multi(
        "multi_mp_adabelief_update", args, 5,
        lambda i, grp, o: mp_adabelief_update(
            grp[0], grp[1], grp[2], grp[3], grp[4], learning_rates[i],
            beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient,
            out=o),
        num_weights, out)


# ----------------------------------------------------------- LARS utilities

def multi_sum_sq(*arrays, num_arrays=None):  # noqa: ARG001
    """Per-tensor Σx² in one fused call (contrib multi_sum_sq.cc —
    feeds multi_lars)."""
    arrs = unwrap_arrays(arrays)

    def fn(xs):
        return torch.stack([torch.sum(x.float() * x) for x in xs])

    return apply_op_flat("multi_sum_sq", fn, (arrs,))


def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-9, rescale_grad=1.0, out=None):
    """LARS layer-wise lr scaling (contrib multi_lars.cc):
    lr·η·‖w‖ / (‖g‖·rescale + wd·‖w‖ + eps), identity when either norm
    is 0."""
    def fn(lr, w2, g2, wd):
        wn = torch.sqrt(w2)
        gn = torch.sqrt(g2) * rescale_grad
        ratio = eta * wn / (gn + wd * wn + eps)
        return torch.where((wn > 0) & (gn > 0), lr * ratio, lr)

    new = apply_op("multi_lars", fn,
                   (lrs, weights_sum_sq, grads_sum_sq, wds),
                   static_info=("h", eta, eps, rescale_grad))
    return _finish(out, lrs, new)


def reset_arrays(*arrays, num_arrays=None):  # noqa: ARG001
    """Zero every array (contrib reset_arrays.cc: gradient clearing),
    rebound to zeros as the reference does."""
    for a in unwrap_arrays(arrays):
        a._set_data(torch.zeros_like(a._data))


# ------------------------------------------------------------ sparse family

def sparse_adagrad_update(weight, grad, history, lr, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                          out=None):
    """AdaGrad (optimizer_op.cc AdagradUpdateEx) over a dense gradient;
    the row-sparse gradient of the reference is not ported (ROADMAP.md §1
    item 11b, ndarray/sparse.py)."""
    if getattr(grad, "stype", "default") != "default":
        raise MXNetError("sparse_adagrad_update: row-sparse gradients are "
                         "not ported (ROADMAP.md §1 item 11b)")

    def fn(w, h, g):
        gr = _pg(g, rescale_grad, clip_gradient) + wd * w
        h2 = h + gr * gr
        return w - lr * gr / (torch.sqrt(h2) + epsilon), h2

    new_w, new_h = apply_op(
        "sparse_adagrad_update", fn, (weight, history, grad),
        n_outputs=2, static_info=("h", lr, epsilon, wd,
                                  rescale_grad, clip_gradient))
    _mutate(history, new_h)
    return _finish(out, weight, new_w)


def group_adagrad_update(weight, grad, history, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5, out=None):
    """Row-grouped AdaGrad (contrib optimizer_op.cc
    GroupAdagradUpdate): history accumulates the per-row MEAN square."""
    def fn(w, g, h):
        gr = _pg(g, rescale_grad, clip_gradient)
        sq = gr * gr
        h2 = h + (sq.mean(dim=tuple(range(1, gr.dim()))) if gr.dim() > 1
                  else sq)
        denom = torch.sqrt(h2 + epsilon)
        shape = (-1,) + (1,) * (gr.ndim - 1)
        return w - lr * gr / denom.reshape(shape), h2

    new_w, new_h = apply_op(
        "group_adagrad_update", fn, (weight, grad, history), n_outputs=2,
        static_info=("h", lr, rescale_grad, clip_gradient, epsilon))
    _mutate(history, new_h)
    return _finish(out, weight, new_w)


def square_sum(data, axis=None, keepdims=False, out=None):
    """Σx² reduction, the reference's `_square_sum` (LARS/optimizer
    helper)."""
    ax = axis if axis is None or isinstance(axis, int) \
        else tuple(int(a) for a in axis)

    def fn(x):
        sq = x * x
        if ax is None:
            s = sq.sum()
            return s.reshape((1,) * x.dim()) if keepdims else s
        return sq.sum(dim=ax, keepdim=keepdims)

    return apply_op("square_sum", fn, (data,),
                    static_info=("h", ax, keepdims), out=out)
