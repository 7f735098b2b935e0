"""``mx.npx`` operators of the port: the ones the serving, training and
NDArray slices call.

Port of `incubator_mxnet_tpu/numpy_extension/__init__.py` (`gelu` :162,
`activation` :168, `softmax` :221, `softmin` :264, `log_softmax` :304,
`masked_softmax` :316, `masked_log_softmax` :334, `fully_connected`
:353, `layer_norm` :591, `dropout` :699, `embedding` :731,
`flash_attention` :834, `residual_dropout_ln` :860, `gelu_dropout` :902,
`batch_dot` :973, `arange_like` :1326, and the vision path's
`batch_flatten` :257, `convolution` :382, `deconvolution` :417,
`pooling` :449, `batch_norm` :539, `group_norm` :638, `instance_norm`
:659), of `softsign`, `adaptive_avg_pooling2d`, `batch_norm_with_relu`
and `pad` (`_contrib_misc.py`) and of `deformable_convolution`
(`_spatial.py`); and the np/npx remainder: the plain ops
(`reshape_like` :278, `l2_normalization` :677, `one_hot` :782, `pick`
:792, `topk` :807, `gather_nd` :995, `scatter_nd` :1005, the sequence
ops :1020-1076, the special functions :1227-1265, `cast`, `reshape`,
`shape_array`, `stop_gradient` :1272-1343, `boolean_mask` :1578,
`clip_global_norm` :1609), the fused RNN (`rnn_param_size`, `rnn`
:1086-1220), `slice_like`, `broadcast_like` and
`batch_take` (`_boxes.py` :305-345), the control flow (`foreach`
:1373, `while_loop` :1425, `cond` :1542) and the mode switches and
state (:1624-1662).

The reference computes convolution, pooling and the norms in XLA, with
no Pallas kernel; their counterpart here is PyTorch's own ops (cuDNN and
PyTorch's CUDA kernels on the card), as ``torch.matmul`` is for the
products. A CUDA input runs on the card; an input the port does not
take raises :class:`MXNetError`.

``batch_norm`` in training updates the running statistics in place,
once a call, with the biased batch variance:
``rm = rm * momentum + mean * (1 - momentum)`` (the reference's
`register_aux_update`, :562-566). The write is an ordinary in-place
op on the statistics' tensors, so a captured CUDA graph (a
`parallel.DataParallel` step, a hybridized block) replays it by address
and the statistics move once a replay.

Each op takes NDArrays, as the reference's do, and then goes through the
NDArray funnel (`ndarray.apply_op`): recorded under
``autograd.record()``, its inputs cast by AMP as the op's name says. It
also takes torch tensors, for a gluon block called with tensors (the
port's module path), and then runs on them directly (torch's own grad
mode; AMP's casts made here for the ops of AMP's lists that the port's
models call: ``fully_connected``, ``embedding``, ``flash_attention``,
``batch_dot``, ``softmax``, ``softmin``, ``masked_softmax``).

Dropout applies where the caller says it is training, or under
``autograd.is_training()`` when the caller says nothing
(``training=None``, the reference's rule, which the gluon layers
follow), or with ``mode="always"``. Each application
draws a fresh key from :func:`random.next_key`: two host words, or
inside `random.trace_key_scope` (a `parallel.DataParallel` step) the
step's next device key, which the kernels read from the card.

``impl`` ("auto" | "kernel" | "plain") is handed to the kernels'
wrappers: "auto" launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; "plain" runs the plain version on any device,
which is how a model on the card is held against its kernels.
:func:`gelu_dropout` also takes the reference's names, "pallas" for the
kernel and "xla" for its composed ops.
"""
from __future__ import annotations

import builtins
import math
import os

import torch
import torch.nn.functional as F

from .. import amp
from .. import autograd
from .. import random as _random
from ..base import MXNetError, canonical_dtype
from ..ndarray.ndarray import NDArray, apply_op
from ..ops import dropout as _dp
from ..ops.flash_attention import flash_attention as _flash_attention
from ..ops import fused_block as _fb
from ..ops import layer_norm as _ln
from ..ops import quantized as _quant

__all__ = ["sharding_constraint", "relu", "sigmoid", "gelu", "activation",
           "leaky_relu", "softmax", "softmin", "log_softmax", "masked_softmax",
           "masked_log_softmax", "batch_dot", "arange_like", "softsign",
           "fully_connected", "embedding", "layer_norm", "dropout",
           "flash_attention", "residual_dropout_ln", "gelu_dropout",
           "batch_flatten", "convolution", "deconvolution", "pooling",
           "batch_norm", "group_norm", "instance_norm",
           "adaptive_avg_pooling2d", "batch_norm_with_relu", "pad",
           "deformable_convolution", "modulated_deformable_convolution",
           "reshape_like", "l2_normalization", "one_hot", "pick", "topk",
           "gather_nd", "scatter_nd", "sequence_mask", "sequence_last",
           "sequence_reverse", "erf", "erfinv", "gamma", "gammaln",
           "digamma", "smooth_l1", "cast", "reshape", "shape_array",
           "stop_gradient", "boolean_mask", "clip_global_norm",
           "slice_like", "broadcast_like", "batch_take", "foreach",
           "while_loop", "cond", "set_np", "reset_np", "is_np_array",
           "is_np_shape", "waitall", "seed", "load", "save",
           "quadratic", "index_copy", "index_array", "gradientmultiplier",
           "dynamic_reshape", "round_ste", "sign_ste", "all_finite",
           "multi_all_finite", "norm", "slice", "slice_channel", "add_n",
           "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk",
           "interleaved_matmul_encdec_valatt", "div_sqrt_dim",
           "sldwin_atten_score", "sldwin_atten_context",
           "sldwin_atten_mask_like", "rnn", "rnn_param_size"]

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid,
    "mish": F.mish,
    # the reference calls jax.nn.gelu, whose default is the tanh
    # approximation; PyTorch's default is the exact erf form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


def _nd(*args):
    """Whether the call takes the NDArray path."""
    return any(isinstance(a, NDArray) for a in args)


def _training(training):
    return autograd.is_training() if training is None else training


def _op(name, fn, *args):
    """``fn`` of the tensors of ``args``: through the funnel (recorded,
    cast by AMP as ``name`` says) when any is an NDArray, else directly on
    the tensors (None positions pass as they are)."""
    if _nd(*args):
        return apply_op(name, fn, args)
    return fn(*args)


def _amp_op(name, fn, *args):
    """:func:`_op` with AMP's cast of ``name`` made here on the tensor
    path too (the funnel makes it for NDArrays)."""
    if _nd(*args):
        return apply_op(name, fn, args)
    return fn(*amp.cast_inputs(name, *args))


def _safe_accumulation():
    """``MXNET_SAFE_ACCUMULATION=1``: softmax reduces a bf16 or f16 input
    in f32 and casts back (the reference's :119-126)."""
    return os.environ.get("MXNET_SAFE_ACCUMULATION") == "1"


def sharding_constraint(data, spec):
    """Lay an activation out over the active mesh as ``spec`` says
    (reference `numpy_extension/__init__.py:937`): the identity with no
    active mesh; under one, this rank's block of each dimension the spec
    cuts (`parallel._layout`), whose gradient is gathered back. Axes the
    mesh lacks are dropped, as in the reference, and so are the axes the
    tensors are already local along (a `DataParallel` step's batch
    axis)."""
    from ..parallel import _layout
    from ..parallel.mesh import _world, current_mesh

    mesh = current_mesh()
    if mesh is None or not _world()[0]:
        return data

    def f(x):
        cspec = _layout.clean_spec(spec, x.dim(), mesh)
        done = _layout.laid_out_axes()
        for d, axes in enumerate(cspec):
            axes = tuple(a for a in axes if a not in done)
            if axes:
                x = _layout.scatter(x, mesh, axes, d)
        return x

    return _op("sharding_constraint", f, data)


def relu(data):
    return _op("relu", torch.relu, data)


def sigmoid(data):
    return _op("sigmoid", torch.sigmoid, data)


def gelu(data, approximate=True):
    """GELU: the tanh approximation by default, as the reference's
    (``jax.nn.gelu``); ``approximate=False`` is the exact erf form. The
    reference has no kernel for it."""
    mode = "tanh" if approximate else "none"
    if _nd(data):
        return apply_op("gelu", lambda x: F.gelu(x, approximate=mode),
                        (data,))
    return F.gelu(data, approximate=mode)


def activation(data, act_type="relu", **kwargs):  # noqa: ARG001
    """The reference's activation types: relu, sigmoid, tanh, softrelu,
    softsign, log_sigmoid, mish, gelu (the tanh approximation, as the
    reference's ``jax.nn.gelu``) and silu."""
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {act_type!r}")
    return _op(f"activation.{act_type}", _ACTIVATIONS[act_type], data)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kwargs):  # noqa: ARG001
    """The reference's leaky_relu family: "leaky" (``slope`` below 0),
    "elu" (alpha ``slope``), "selu", "gelu" (the erf form), "prelu"
    (learned ``gamma``, broadcast over axis 1) and "rrelu" (a slope drawn
    uniformly from [lower_bound, upper_bound] per element in training,
    their mean otherwise)."""
    if act_type == "leaky":
        return _op("leaky_relu",
                      lambda x: torch.where(x >= 0, x, slope * x), data)
    if act_type == "elu":
        return _op("elu", lambda x: F.elu(x, alpha=slope), data)
    if act_type == "selu":
        return _op("selu", F.selu, data)
    if act_type == "gelu":
        return _op("gelu", lambda x: F.gelu(x, approximate="none"), data)
    if act_type == "prelu":
        def f(x, g):
            if g.dim() == 1 and x.dim() > 2:
                g = g.reshape((1, -1) + (1,) * (x.dim() - 2))
            return torch.where(x >= 0, x, g * x)

        return _op("prelu", f, data, gamma)
    if act_type == "rrelu":
        if autograd.is_training():
            seed = _random.host_seed()

            def f(x):
                gen = torch.Generator(device=x.device)
                gen.manual_seed(seed)
                u = torch.empty(x.shape, dtype=x.dtype, device=x.device)
                u.uniform_(lower_bound, upper_bound, generator=gen)
                return torch.where(x >= 0, x, u * x)

            return _op("rrelu", f, data)
        mid = (lower_bound + upper_bound) / 2.0
        return _op("rrelu", lambda x: torch.where(x >= 0, x, mid * x),
                      data)
    raise ValueError(f"unknown leaky_relu act_type {act_type!r}")


def softmax(data, axis=-1, length=None, temperature=None, use_length=False,
            dtype=None, **kwargs):  # noqa: ARG001
    """Softmax over ``axis``; with ``length`` (or ``use_length``) the
    entries at or past each row's length are masked out (probability 0).
    ``temperature`` divides the input first; ``dtype`` casts the output.
    Under AMP it runs in float32 ("softmax"). Under
    ``MXNET_SAFE_ACCUMULATION=1`` a bf16 or f16 input reduces in f32 and
    the output takes the input's dtype back unless ``dtype`` says
    otherwise."""
    safe = _safe_accumulation()

    def f(x, ln):
        in_dt = x.dtype
        if safe and in_dt in (torch.float16, torch.bfloat16):
            x = x.float()
        if temperature is not None and temperature != 1.0:
            x = x / temperature
        if ln is not None:
            ax = axis % x.dim()
            shape = [1] * x.dim()
            shape[ax] = -1
            idx = torch.arange(x.shape[ax], device=x.device).reshape(shape)
            mask = idx < ln.unsqueeze(ax)
            out = torch.softmax(x.masked_fill(~mask, float("-inf")),
                                dim=axis)
            out = torch.where(mask, out, 0.0)
        else:
            out = torch.softmax(x, dim=axis)
        if dtype:
            return out.to(canonical_dtype(dtype))
        return out.to(in_dt) if safe else out

    ln = length if (use_length or length is not None) else None
    return _amp_op("softmax", f, data, ln)


def softmin(data, axis=-1, temperature=None, dtype=None, **kwargs):  # noqa: ARG001
    """Softmax of the negated input (float32 under AMP)."""
    def f(x):
        if temperature is not None and temperature != 1.0:
            x = x / temperature
        out = torch.softmax(-x, dim=axis)
        return out.to(canonical_dtype(dtype)) if dtype else out

    return _amp_op("softmin", f, data)


def log_softmax(data, axis=-1, temperature=None, dtype=None, **kwargs):  # noqa: ARG001
    def f(x):
        if temperature is not None and temperature != 1.0:
            x = x / temperature
        out = torch.log_softmax(x, dim=axis)
        return out.to(canonical_dtype(dtype)) if dtype else out

    return _op("log_softmax", f, data)


def masked_softmax(data, mask=None, axis=-1, temperature=1.0, **kwargs):  # noqa: ARG001
    """Softmax over ``axis`` of the entries where ``mask`` is nonzero;
    masked entries (and rows with none left) are 0. Float32 under AMP."""
    def f(x, m):
        if temperature != 1.0:
            x = x / temperature
        if m is None:
            return torch.softmax(x, dim=axis)
        keep = m.bool()
        out = torch.softmax(x.masked_fill(~keep, float("-inf")), dim=axis)
        return torch.where(keep, out, 0.0)

    return _amp_op("masked_softmax", f, data, mask)


def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0):
    """Log-softmax over ``axis`` of the entries where ``mask`` is nonzero;
    masked entries are -inf."""
    def f(x, m):
        if temperature != 1.0:
            x = x / temperature
        if m is not None:
            x = x.masked_fill(~m.bool(), float("-inf"))
        return torch.log_softmax(x, dim=axis)

    return _amp_op("masked_log_softmax", f, data, mask)


def batch_dot(a, b, transpose_a=False, transpose_b=False, **kwargs):  # noqa: ARG001
    """Batched matrix product over the last two axes, either operand
    transposed first. A plain product: the reference leaves it to XLA
    (no kernel), the port to ``torch.matmul``. Under AMP float32 operands
    take the target dtype ("batch_dot")."""
    def f(x, y):
        if transpose_a:
            x = x.transpose(-1, -2)
        if transpose_b:
            y = y.transpose(-1, -2)
        return torch.matmul(x, y)

    return _amp_op("batch_dot", f, a, b)


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):  # noqa: ARG001
    """``start + step * i`` in ``data``'s dtype and device: over every
    element in ``data``'s shape, or along ``axis`` (a vector of that
    axis's length). ``repeat`` is taken and unused, as in the
    reference."""
    t = data._data if isinstance(data, NDArray) else data
    n = t.numel() if axis is None else t.shape[axis]
    out = start + step * torch.arange(n, dtype=torch.float64,
                                      device=t.device)
    out = out.to(t.dtype)
    if axis is None:
        out = out.reshape(t.shape)
    return NDArray(out) if isinstance(data, NDArray) else out


def _fc(x, w, b, flatten):
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, w, b)


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kwargs):  # noqa: ARG001
    """``x @ weight.T + bias`` (``F.linear``, the product of the port's
    `gluon.nn.Dense`); ``flatten`` collapses all but the first axis of x.
    Under AMP x, weight and bias take bfloat16 ("fully_connected")."""
    b = None if no_bias else bias
    if _nd(x, weight, b):
        return apply_op("fully_connected",
                        lambda xv, w, bv: _fc(xv, w, bv, flatten),
                        (x, weight, b))
    return _fc(*amp.cast_inputs("fully_connected", x, weight, b), flatten)


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False, **kwargs):  # noqa: ARG001
    """Rows of ``weight`` at the indices ``data`` (the lookup of the port's
    `gluon.nn.Embedding`). Under AMP the weight takes bfloat16
    ("embedding"). ``sparse_grad`` is not ported."""
    if sparse_grad:
        raise MXNetError("npx.embedding: sparse_grad is not ported")

    def f(idx, w):
        out = w[idx.long()]
        return out if dtype is None else out.to(canonical_dtype(dtype))

    if _nd(data, weight):
        return apply_op("embedding", f, (data, weight))
    (w,) = amp.cast_inputs("embedding", weight)
    return f(data, w)


def _layer_norm(data, gamma, beta, axis, eps, impl):
    last = axis in (-1, data.dim() - 1)
    if data.device.type == "cuda" and not last and impl != "plain":
        raise MXNetError(f"npx.layer_norm: the kernel normalises the "
                         f"last axis, got axis={axis} of a "
                         f"{data.dim()}-d tensor")
    if last:
        c = data.shape[-1]
        if gamma is None:
            gamma = torch.ones(c, dtype=data.dtype, device=data.device)
        if beta is None:
            beta = torch.zeros(c, dtype=data.dtype, device=data.device)
        return _ln.layer_norm(data, gamma, beta, eps=eps, impl=impl)

    xd = data.dtype
    x = data.float()
    axis = axis % x.dim()
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    bshape = [1] * x.dim()
    bshape[axis] = -1
    if gamma is not None:
        g = gamma.float()
        out = out * (g.reshape(bshape) if g.dim() == 1 and x.dim() > 1
                     else g)
    if beta is not None:
        b = beta.float()
        out = out + (b.reshape(bshape) if b.dim() == 1 and x.dim() > 1
                     else b)
    return out.to(xd)


def layer_norm(data, gamma=None, beta=None, axis=-1, eps=1e-5, impl="auto",
               **kwargs):  # noqa: ARG001
    """Layer norm over ``axis`` with f32 statistics, output in the input
    dtype; differentiable.

    Over the last axis it is `ops.layer_norm` (forward and backward): a
    CUDA tensor goes to the LayerNorm kernels (the gate of the reference,
    re-keyed from "the backend is a TPU" to "the tensor is on the card"),
    which launch or raise :class:`MXNetError` for a feature size they do
    not take (:func:`ops.layer_norm.supports`) or gamma/beta of another
    dtype; a CPU tensor takes the plain versions. A CUDA tensor over
    another axis raises. A CPU tensor over another axis takes the composed
    ops, as the reference does off the TPU. A missing gamma or beta is
    ones or zeros."""
    if _nd(data, gamma, beta):
        return apply_op("layer_norm",
                        lambda x, g, b: _layer_norm(x, g, b, axis, eps, impl),
                        (data, gamma, beta))
    return _layer_norm(data, gamma, beta, axis, eps, impl)


def _applies(p, mode, training):
    if mode not in ("training", "always"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    return p > 0 and (mode == "always" or _training(training))


def _broadcast_dropout(x, key, p, axes, impl):
    """Dropout with one mask for every index along ``axes``: the mask is
    K5 applied to ones of x's shape with those axes set to 1 (f32: the
    values 1/(1-p) or 0), drawn on the card for a CUDA tensor, and the
    product is rounded once to x's dtype."""
    shape = list(x.shape)
    for ax in axes:
        shape[ax] = 1
    ones = torch.ones(shape, dtype=torch.float32, device=x.device)
    mask = _dp.dropout_fwd(ones, key, p, impl=impl)
    return (x.float() * mask).to(x.dtype)


def dropout(data, p=0.5, axes=(), mode="training", training=None,
            impl="auto", **kwargs):  # noqa: ARG001
    """Dropout with drop probability ``p`` where it applies (training, see
    the module's docstring, or ``mode="always"``), else the identity. A
    CUDA tensor goes to the dropout kernel (`ops/dropout.py`), which
    launches or raises; a CPU tensor takes its plain version. With
    ``axes`` the mask is drawn once over the shape with those axes set to
    1 and broadcast along them (the reference's :720-727), through the
    same kernel on a ones tensor of that shape."""
    if not _applies(p, mode, training):
        return data
    key = _random.next_key()
    p = float(p)
    if axes:
        axes = (axes,) if isinstance(axes, int) else tuple(axes)

        def f(x):
            return _broadcast_dropout(x, key, p, axes, impl)
    else:
        def f(x):
            return _dp.dropout(x, key, p, impl=impl)
    if _nd(data):
        return apply_op("dropout", f, (data,))
    return f(data)


def _flash(q, k, v, vl, causal, sm_scale, impl, layout):
    return _flash_attention(q, k, v, lengths=vl, causal=causal,
                            sm_scale=sm_scale, impl=impl, layout=layout)


def flash_attention(query, key, value, valid_length=None, causal=False,
                    sm_scale=None, layout="bhtd", impl="auto"):
    """Fused memory-linear attention, differentiable: the kernels in
    `ops/flash_attention.py` for CUDA tensors, their plain versions for
    CPU tensors. ``valid_length``: (B,) valid sequence lengths. Under AMP
    float32 q, k, v are cast to the target dtype (bf16 or f16)."""
    if _nd(query, key, value, valid_length):
        return apply_op(
            "flash_attention",
            lambda q, k, v, vl: _flash(q, k, v, vl, causal, sm_scale, impl,
                                       layout),
            (query, key, value, valid_length))
    query, key, value = amp.cast_inputs("flash_attention", query, key,
                                        value)
    return _flash(query, key, value, valid_length, causal, sm_scale, impl,
                  layout)


def residual_dropout_ln(x, h, gamma, beta, p=0.0, eps=1e-5, axis=-1,
                        training=None, impl="auto"):
    """``layer_norm(x + dropout_p(h))``, the post-LN transformer's residual
    site, through the fused kernels of `ops/fused_block.py` (forward and
    backward) for CUDA tensors and their plain versions for CPU tensors.

    As on the TPU, the fused op runs whether or not dropout applies: out
    of training, or at p = 0, it adds h without drawing a key. It takes
    the last axis only and same-shape x and h; a CUDA tensor it cannot
    take raises :class:`MXNetError`."""
    if axis not in (-1, len(x.shape) - 1):
        raise MXNetError(f"npx.residual_dropout_ln: the kernel normalises "
                         f"the last axis, got axis={axis}")
    p_eff = float(p) if _training(training) else 0.0
    key = _random.next_key() if 0 < p_eff < 1 else (0, 0)
    if _nd(x, h, gamma, beta):
        return apply_op(
            "residual_dropout_ln",
            lambda xv, hv, g, b: _fb.residual_dropout_ln(
                xv, hv, g, b, p_eff, key, eps=eps, impl=impl),
            (x, h, gamma, beta))
    return _fb.residual_dropout_ln(x, h, gamma, beta, p_eff, key, eps=eps,
                                   impl=impl)


# the reference's impl names: "pallas" is its kernel, "xla" its composed ops
_GD_IMPLS = {"auto": "auto", "kernel": "kernel", "pallas": "kernel",
             "plain": "plain"}


def gelu_dropout(data, p=0.0, impl="auto", training=None):
    """``dropout_p(gelu(data))`` with the exact erf gelu, differentiable.

    Dropout applies only in training (see the module's docstring), as in
    the reference. Where it does not, or at p = 0, this is
    ``gelu(data, approximate=False)`` and no key is drawn. Otherwise one
    key is drawn from :func:`random.next_key` and ``impl`` picks the
    route: "auto" launches the fused kernel of `ops/fused_block.py` (K6)
    for a CUDA tensor and runs its plain version for a CPU tensor;
    "kernel" (or the reference's "pallas") requires a CUDA tensor;
    "plain" forces the plain version; "xla" is the reference's
    composition, ``F.gelu`` then :func:`dropout`'s kernel (K5), which
    drops the same elements for the same key. A CUDA tensor the kernel
    cannot take raises :class:`MXNetError`."""
    if impl != "xla" and impl not in _GD_IMPLS:
        raise ValueError(f"gelu_dropout: unknown impl {impl!r}")
    p_eff = float(p) if _training(training) else 0.0
    if p_eff == 0:
        return gelu(data, approximate=False)
    key = _random.next_key()
    if impl == "xla":
        def f(u):
            return _dp.dropout(F.gelu(u, approximate="none"), key, p_eff)
    else:
        def f(u):
            return _fb.gelu_dropout(u, p_eff, key, impl=_GD_IMPLS[impl])
    if _nd(data):
        return apply_op("gelu_dropout", f, (data,))
    return f(data)


# ---------------------------------------------------------------------------
# the vision path: convolution, pooling, normalisation
# ---------------------------------------------------------------------------

_NC_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_LAST_LAYOUTS = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _tuple(x, n):
    if x is None:
        return (1,) * n
    if isinstance(x, int):
        return (x,) * n
    return tuple(x)


def _channels_last(ndim, layout):
    """Whether ``layout`` puts the channels last (N...C) rather than
    second (NC...); the reference's layouts only."""
    if layout is None or layout == _NC_LAYOUTS.get(ndim):
        return False
    if layout == _LAST_LAYOUTS.get(ndim):
        return True
    raise MXNetError(f"layout {layout!r} is not a {ndim}-d spatial layout "
                     f"(NC... or N...C)")


def batch_flatten(data, **kwargs):  # noqa: ARG001
    """Collapse all non-batch axes: (batch, -1)."""
    return _op("batch_flatten", lambda x: x.reshape(x.shape[0], -1), data)


def _conv(x, w, b, stride, pad, dilate, groups, last):
    nd = x.dim() - 2
    if last:
        # N...C data and the reference's ...IO kernel, as NC... and OI...
        x = x.movedim(-1, 1)
        w = w.permute(nd + 1, nd, *range(nd))
    if b is not None:
        b = b.to(x.dtype)
    y = _CONV[nd](x, w, b, stride, pad, dilate, groups)
    return y.movedim(1, -1) if last else y


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **kwargs):  # noqa: ARG001
    """N-d convolution (1-, 2- or 3-d) with stride, dilation, padding and
    ``num_group`` groups (depthwise at ``num_group`` = channels). NC...
    layouts take an (O, I/g, *k) weight; N...C layouts the reference's
    (*k, I/g, O). Under AMP data, weight and bias take the target dtype
    ("convolution"); the bias is added in the product's epilogue (one
    rounding, where the reference rounds the product and the sum)."""
    nd = len(kernel) if kernel is not None else data.ndim - 2
    stride, dilate = _tuple(stride, nd), _tuple(dilate, nd)
    pad = _tuple(pad, nd) if pad is not None else (0,) * nd
    last = _channels_last(nd, layout)
    b = None if no_bias else bias

    def f(x, w, bv):
        return _conv(x, w, bv, stride, pad, dilate, num_group, last)

    return _amp_op("convolution", f, data, weight, b)


def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, layout=None, target_shape=None,  # noqa: ARG001
                  **kwargs):  # noqa: ARG001
    """Transposed convolution, MXNet's: weight (in, out/g, *k), output
    size (in - 1)·stride − 2·pad + dilate·(k − 1) + 1 + adj, ``num_group``
    groups. The reference reads the weight as (out, in, *k) (its
    ``conv_transpose`` with ``transpose_kernel``) and drops ``adj`` and
    ``num_group``; where it runs (in = out, one group, adj 0) the port's
    output is the reference's for the weight with its first two axes
    swapped (`ROADMAP.md` §3, accepted divergences). N...C layouts take a
    (*k, in, out/g) weight. Under AMP: the target dtype
    ("deconvolution")."""
    nd = len(kernel) if kernel is not None else data.ndim - 2
    stride, dilate = _tuple(stride, nd), _tuple(dilate, nd)
    pad = _tuple(pad, nd) if pad is not None else (0,) * nd
    adj = _tuple(adj, nd) if adj is not None else (0,) * nd
    last = _channels_last(nd, layout)
    b = None if no_bias else bias

    def f(x, w, bv):
        if last:
            x = x.movedim(-1, 1)
            w = w.permute(nd, nd + 1, *range(nd))
        if bv is not None:
            bv = bv.to(x.dtype)
        y = _CONV_T[nd](x, w, bv, stride, pad, adj, num_group, dilate)
        return y.movedim(1, -1) if last else y

    return _amp_op("deconvolution", f, data, weight, b)


def _sum_pool(x, k, s):
    """Window sums with no padding (``avg_pool`` with divisor 1)."""
    if len(k) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + k, (1,) + s,
                            divisor_override=1).squeeze(2)
    return _AVG_POOL[len(k)](x, k, s, divisor_override=1)


def _pool_nc(x, k, s, p, kind, include_pad, full):
    """The reference's windowed pooling of an NC... tensor: "valid"
    (floor) or "full" (ceil: the high side padded so that a partial last
    window is emitted); "avg" divides by the window's size (with
    ``include_pad``; in "full", the size clipped to the input plus its
    padding) or by its count of input elements. torch's own pooling
    where its windows are the reference's (padding at most half the
    window, and in "full" the same output size: torch drops a last window
    that starts in the high padding, the reference keeps it), else the
    reference's arithmetic on an explicitly padded tensor."""
    nd = len(k)
    size = x.shape[2:]
    extra = []
    for n, kk, ss, pp in zip(size, k, s, p):
        rem = (n + 2 * pp - kk) % ss
        extra.append(ss - rem if full and rem else 0)
    if not x.is_floating_point():
        if kind != "max":
            raise MXNetError(f"npx.pooling: {kind} pooling of {x.dtype} "
                             f"(the reference pools integer codes by max "
                             f"only)")
        # integer codes (quantize_net's int8 chain): the padding is the
        # type's minimum, Q2 on the card
        return _quant.max_pool_int(x, k, s, p, extra)
    native = all(pp <= kk // 2 for kk, pp in zip(k, p)) and kind != "sum"
    if native and full:
        # torch's ceil mode keeps a last window only if it starts inside
        # the input or its low padding
        native = all((n + 2 * pp + e - kk) // ss * ss < n + pp
                     for n, kk, ss, pp, e in zip(size, k, s, p, extra))
    if native:
        if kind == "max":
            return _MAX_POOL[nd](x, k, s, p, ceil_mode=full)
        return _AVG_POOL[nd](x, k, s, p, ceil_mode=full,
                             count_include_pad=include_pad)
    pads = []
    for pp, e in zip(reversed(p), reversed(extra)):
        pads += [pp, pp + e]
    if kind == "max":
        return _MAX_POOL[nd](F.pad(x, pads, value=float("-inf")), k, s)
    total = _sum_pool(F.pad(x, pads), k, s)
    if kind == "sum":
        return total
    if include_pad and not full:
        return total / float(math.prod(k))
    ones = torch.ones((1, 1) + tuple(size), dtype=x.dtype, device=x.device)
    if include_pad:
        # the padding counts, the ceil extension does not
        ones = F.pad(ones, [q for pp in reversed(p) for q in (pp, pp)],
                     value=1.0)
        ones = F.pad(ones, [q for e in reversed(extra) for q in (0, e)])
    else:
        ones = F.pad(ones, pads)
    return total / _sum_pool(ones, k, s)


def pooling(data, kernel=None, stride=None, pad=None, pool_type="max",
            global_pool=False, layout=None, count_include_pad=True,
            pooling_convention="valid", **kwargs):  # noqa: ARG001
    """Max, average or sum pooling over the spatial axes (1-, 2- or 3-d),
    windowed (``pooling_convention`` "valid" or "full") or global
    (``global_pool``: also "lp", the L2 norm of each map, as in the
    reference, where "lp" is global only). Integer codes (the int8 chain
    of `contrib.quantization`) pool by max only, the padding their type's
    minimum, through the Q2 kernel on the card (`ops.quantized`). See
    :func:`_pool_nc`."""
    nd = data.ndim - 2
    last = _channels_last(nd, layout)
    if global_pool:
        reduce = {"max": lambda x, a: x.amax(dim=a, keepdim=True),
                  "avg": lambda x, a: x.mean(dim=a, keepdim=True),
                  "sum": lambda x, a: x.sum(dim=a, keepdim=True),
                  "lp": lambda x, a: x.abs().square().sum(
                      dim=a, keepdim=True).sqrt()}
        if pool_type not in reduce:
            raise ValueError(f"unsupported pool_type {pool_type!r}")

        def g(x):
            axes = tuple(i for i in range(1, x.dim() - 1)) if last \
                else tuple(range(2, x.dim()))
            return reduce[pool_type](x, axes)

        return _op("global_pool", g, data)
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(f"unsupported pool_type {pool_type!r}")
    kernel, stride = _tuple(kernel, nd), _tuple(stride, nd)
    pad = _tuple(pad, nd) if pad is not None else (0,) * nd
    full = pooling_convention == "full"

    def f(x):
        if last:
            x = x.movedim(-1, 1)
        y = _pool_nc(x, kernel, stride, pad, pool_type, count_include_pad,
                     full)
        return y.movedim(1, -1) if last else y

    return _op(f"pooling.{pool_type}", f, data)


def _bn_batch(x, g, b, eps, axis, composed):
    """Training-mode batch norm of ``x`` over every axis but ``axis``:
    (out, batch mean, biased batch variance). ``g`` None is gamma fixed
    at one. One fused op (``torch.native_batch_norm`` with no running
    buffers: the statistics come back with the output) unless
    ``composed`` (the statistics differentiable, for
    ``output_mean_var``)."""
    ax = axis % x.dim()
    if composed:
        red = [i for i in range(x.dim()) if i != ax]
        var, mean = torch.var_mean(x, dim=red, correction=0)
        shape = [1] * x.dim()
        shape[ax] = -1
        inv = torch.rsqrt(var + eps)
        if g is not None:
            inv = g * inv
        out = (x - mean.reshape(shape)) * inv.reshape(shape) \
            + b.reshape(shape)
        return out, mean, var
    xc = x if ax == 1 else x.movedim(ax, 1)
    out, mean, invstd = torch.native_batch_norm(xc, g, b, None, None, True,
                                                0.0, eps)
    if ax != 1:
        out = out.movedim(1, ax)
    return out, mean, invstd.pow(-2) - eps


@torch.no_grad()
def _bn_update(rm, rv, mean, var, momentum):
    """The running statistics' update, in place (one a call)."""
    m = momentum
    rm.copy_(rm * m + mean.detach().to(rm.dtype) * (1 - m))
    rv.copy_(rv * m + var.detach().to(rv.dtype) * (1 - m))


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, **kwargs):  # noqa: ARG001
    """Batch normalisation over every axis but ``axis``. In training
    (``autograd.is_training() and not use_global_stats``) it normalises
    with the batch statistics and updates ``running_mean`` and
    ``running_var`` in place with the biased batch variance; otherwise
    it normalises with the running statistics. ``fix_gamma``: gamma is
    taken as ones (and gets no gradient). A float32 op under AMP."""
    training = autograd.is_training() and not use_global_stats
    rm = running_mean._data if isinstance(running_mean, NDArray) \
        else running_mean
    rv = running_var._data if isinstance(running_var, NDArray) \
        else running_var
    if training:
        def f(xv, g, b):
            out, mean, var = _bn_batch(xv, None if fix_gamma else g, b, eps,
                                       axis, output_mean_var)
            _bn_update(rm, rv, mean, var, momentum)
            return (out, mean, var) if output_mean_var else out

        out = _amp_op("batch_norm", f, x, gamma, beta)
        for a in (running_mean, running_var):
            if isinstance(a, NDArray):
                a._version += 1
        return out

    def f(xv, g, b, m, v):
        ax = axis % xv.dim()
        xc = xv if ax == 1 else xv.movedim(ax, 1)
        out = F.batch_norm(xc, m, v, None if fix_gamma else g, b, False,
                           0.0, eps)
        return out if ax == 1 else out.movedim(1, ax)

    out = _amp_op("batch_norm", f, x, gamma, beta, running_mean, running_var)
    if output_mean_var:
        return out, running_mean, running_var
    return out


def group_norm(data, gamma=None, beta=None, num_groups=1, eps=1e-5,
               **kwargs):  # noqa: ARG001
    """Normalisation over each group of ``C / num_groups`` channels and
    the spatial axes of each sample, then gamma and beta a channel. A
    float32 op under AMP."""
    def f(x, g, b):
        return F.group_norm(x, num_groups, g, b, eps)

    return _amp_op("group_norm", f, data, gamma, beta)


def instance_norm(data, gamma=None, beta=None, eps=1e-5, **kwargs):  # noqa: ARG001
    """Normalisation over the spatial axes of each sample and channel,
    then gamma and beta a channel. A float32 op under AMP."""
    def f(x, g, b):
        return F.group_norm(x, x.shape[1], g, b, eps)

    return _amp_op("instance_norm", f, data, gamma, beta)


# ---------------------------------------------------------------------------
# the np/npx remainder: plain ops (no kernel: the reference composes them
# in jnp)
# ---------------------------------------------------------------------------

def _capturing():
    """Whether the current CUDA stream is capturing a graph (a
    `parallel.DataParallel` step or a hybridized block being captured)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _no_capture(what):
    """Raise for an op that must read device values on the host (a
    data-dependent shape, a Python result): inside a capture that read
    would be a synchronisation the graph cannot hold."""
    if _capturing():
        raise MXNetError(f"npx.{what} reads device values on the host (a "
                         f"data-dependent result), which a CUDA-graph "
                         f"capture cannot hold; call it outside the "
                         f"hybridized block or DataParallel step")


def _take_along(x, idx, axis):
    """``take_along_axis(x, idx, axis)`` with numpy's broadcasting of the
    other axes and its wrap of negative indices (``torch.gather`` does
    neither)."""
    ax = axis % x.dim()
    idx = torch.where(idx < 0, idx + x.shape[ax], idx)
    shape = list(torch.broadcast_shapes(
        tuple(1 if d == ax else n for d, n in enumerate(x.shape)),
        tuple(1 if d == ax else n for d, n in enumerate(idx.shape))))
    xs = list(shape)
    xs[ax] = x.shape[ax]
    shape[ax] = idx.shape[ax]
    return torch.gather(x.expand(xs), ax, idx.expand(shape))


def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None, **kwargs):  # noqa: ARG001
    """Reshape ``lhs`` to ``rhs``'s shape; the range form replaces
    ``lhs.shape[lhs_begin:lhs_end]`` by ``rhs.shape[rhs_begin:rhs_end]``."""
    lshape, rshape = tuple(lhs.shape), tuple(rhs.shape)
    lb = 0 if lhs_begin is None else lhs_begin
    le = len(lshape) if lhs_end is None else lhs_end
    rb = 0 if rhs_begin is None else rhs_begin
    re_ = len(rshape) if rhs_end is None else rhs_end
    lb += len(lshape) if lb < 0 else 0
    le += len(lshape) if le < 0 else 0
    rb += len(rshape) if rb < 0 else 0
    re_ += len(rshape) if re_ < 0 else 0
    shape = lshape[:lb] + rshape[rb:re_] + lshape[le:]
    if math.prod(shape) != math.prod(lshape):
        raise ValueError(
            f"reshape_like: target shape {shape} has {math.prod(shape)} "
            f"elements, lhs has {math.prod(lshape)}")
    return _op("reshape_like", lambda x: x.reshape(shape), lhs)


def l2_normalization(data, eps=1e-10, mode="instance"):
    """``x / sqrt(sum(x²) + eps)`` over every axis but the first
    ("instance"), over axis 1 ("channel") or over the spatial axes
    ("spatial")."""
    if mode not in ("instance", "channel", "spatial"):
        raise ValueError(mode)

    def f(x):
        axes = {"instance": tuple(range(1, x.dim())), "channel": (1,),
                "spatial": tuple(range(2, x.dim()))}[mode]
        return x / torch.sqrt((x * x).sum(dim=axes, keepdim=True) + eps)

    return _op("l2_normalization", f, data)


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of ``depth`` entries, ``on_value`` at each index and
    ``off_value`` elsewhere; an index outside [0, depth) gives a row of
    ``off_value`` (the reference's ``jax.nn.one_hot``). The indices are
    truncated to integers first."""
    dt = canonical_dtype(dtype)

    def f(idx):
        i = idx.to(torch.int32).unsqueeze(-1)
        oh = (i == torch.arange(depth, device=idx.device,
                                dtype=torch.int32)).to(dt)
        return oh * (on_value - off_value) + off_value

    return _op("one_hot", f, data)


def pick(data, index, axis=-1, mode="clip", keepdims=False):
    """``data``'s entry at ``index`` along ``axis`` (an index array of
    data's shape without that axis); "clip" clamps an index into range,
    any other mode wraps it."""
    def f(x, idx):
        ax = axis % x.dim()
        n = x.shape[ax]
        i = idx.to(torch.int64)
        i = i.clamp(0, n - 1) if mode == "clip" else i.remainder(n)
        out = _take_along(x, i.unsqueeze(ax), ax)
        return out if keepdims else out.squeeze(ax)

    if not isinstance(index, (NDArray, torch.Tensor)):
        dev = (data._data if isinstance(data, NDArray) else data).device
        index = torch.as_tensor(index, device=dev)
    return _op("pick", f, data, index)


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) entries along ``axis``,
    ties taken in index order, lower index first (as ``lax.top_k``): a
    stable sort, so the order holds on the card too. ``ret_typ``:
    "value", "indices" (in ``dtype``, float32 by default), "both" or
    "mask" (``dtype`` ones at each row's k positions)."""
    if ret_typ not in ("value", "indices", "both", "mask"):
        raise ValueError(ret_typ)
    dt = canonical_dtype(dtype)

    def f(x):
        xm = x.movedim(axis, -1)
        vals, idx = torch.sort(xm, dim=-1, descending=not is_ascend,
                               stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        if ret_typ == "mask":
            m = torch.zeros(xm.shape, dtype=dt, device=x.device)
            return m.scatter(-1, idx, 1).movedim(-1, axis)
        vals, idx = vals.movedim(-1, axis), idx.movedim(-1, axis).to(dt)
        if ret_typ == "value":
            return vals
        if ret_typ == "indices":
            return idx
        return vals, idx

    return _op("topk", f, data)


def _index_tuple(idx):
    idx = idx.to(torch.int64)
    return tuple(idx[i] for i in range(idx.shape[0]))


def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``: the first axis of
    ``indices`` indexes data's first M axes."""
    return _op("gather_nd", lambda x, i: x[_index_tuple(i)], data, indices)


def scatter_nd(data, indices, shape):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (the inverse
    of :func:`gather_nd`; repeated indices add up)."""
    def f(d, i):
        out = torch.zeros(shape, dtype=d.dtype, device=d.device)
        return out.index_put(_index_tuple(i), d, accumulate=True)

    return _op("scatter_nd", f, data, indices)


# ---------------------------------------------------------------------------
# sequence ops: (T, N, ...) at axis 0, (N, T, ...) at axis 1
# ---------------------------------------------------------------------------

def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """``value`` at every step at or past each sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data

    def f(x, ln):
        shape = [1] * x.dim()
        shape[axis] = -1
        lshape = [1] * x.dim()
        lshape[1 - axis] = -1
        steps = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        return torch.where(steps < ln.reshape(lshape), x, value)

    return _op("sequence_mask", f, data, sequence_length)


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step (the last step without lengths)."""
    def f(x, ln):
        if ln is None:
            return x.select(axis, -1)
        idx = (ln - 1).to(torch.int64)
        idx = idx.reshape((1, -1) + (1,) * (x.dim() - 2)) if axis == 0 \
            else idx.reshape((-1, 1) + (1,) * (x.dim() - 2))
        return _take_along(x, idx, axis).squeeze(axis)

    ln = sequence_length if use_sequence_length else None
    return _op("sequence_last", f, data, ln)


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's valid prefix reversed in place, the padding after it
    kept (all steps reversed without lengths)."""
    def f(x, ln):
        if ln is None:
            return x.flip(axis)
        t = x.shape[axis]
        steps = torch.arange(t, device=x.device)
        ln_i = ln.to(torch.int64)
        rev = torch.where(steps[None, :] < ln_i[:, None],
                          ln_i[:, None] - 1 - steps[None, :], steps[None, :])
        xm = x.movedim(axis, 0)
        ind = rev.movedim(-1, 0).reshape((t, -1) + (1,) * (xm.dim() - 2))
        return _take_along(xm, ind, 0).movedim(0, axis)

    ln = sequence_length if use_sequence_length else None
    return _op("sequence_reverse", f, data, ln)


# ---------------------------------------------------------------------------
# the fused RNN (reference :1080-1220, over `src/operator/rnn.cc:296`)
# ---------------------------------------------------------------------------

def _rnn_gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def _unpack_rnn_params(params, mode, num_layers, input_size, state_size,
                       bidirectional, projection_size=None):  # noqa: ARG001
    """[w_i2h, w_h2h, b_i2h, b_h2h] a (layer, direction) from the flat
    vector in cuDNN's layout: every weight first (layer by layer, the
    forward direction before the reverse, i2h before h2h), then every
    bias in the same order; the gates stacked i f g o (LSTM) and r z n
    (GRU), so checkpoints of either package load bit-compatibly."""
    ngates = _rnn_gates(mode)
    dirs = 2 if bidirectional else 1
    gh = ngates * state_size
    layers = []
    pos = 0
    for layer in range(num_layers):
        lsize = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            w_i2h = params[pos:pos + gh * lsize].reshape(gh, lsize)
            pos += gh * lsize
            w_h2h = params[pos:pos + gh * state_size].reshape(gh, state_size)
            pos += gh * state_size
            layers.append([w_i2h, w_h2h, None, None])
    for entry in layers:
        entry[2] = params[pos:pos + gh]
        entry[3] = params[pos + gh:pos + 2 * gh]
        pos += 2 * gh
    return layers


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    """The flat parameter vector's length for :func:`rnn`."""
    ngates = _rnn_gates(mode)
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        lsize = input_size if layer == 0 else state_size * dirs
        total += dirs * ngates * state_size * (lsize + state_size + 2)
    return total


def _cell_step(mode, xw, h, c, w_h2h, b_h2h):
    """One time step of the reference's cell (`_cell_step` :1138) given
    ``xw`` = x_t @ w_i2h.T + b_i2h (the whole sequence's in one product):
    the new h and c, in the reference's order of additions."""
    hw = torch.matmul(h, w_h2h.t())
    if mode == "lstm":
        gates = xw + hw + b_h2h
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    if mode == "gru":
        # cuDNN's gru: r, z from the sums; n uses r * (h W_hn + b_hn)
        xr, xz, xn = xw.chunk(3, dim=-1)
        hr, hz, hn = (hw + b_h2h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    gates = xw + hw + b_h2h
    return (torch.tanh(gates) if mode == "rnn_tanh"
            else torch.clamp_min(gates, 0)), c


def rnn(data=None, parameters=None, state=None, state_cell=None, mode="lstm",
        state_size=None, num_layers=1, bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, sequence_length=None,  # noqa: ARG001
        use_sequence_length=False, **kwargs):  # noqa: ARG001
    """Fused multi-layer RNN over time-major input (T, N, C): "rnn_relu",
    "rnn_tanh", "lstm" or "gru", one or two directions, the parameters
    one flat vector in cuDNN's layout (:func:`rnn_param_size`), ``state``
    (and for an LSTM ``state_cell``, zeros when None) of (layers *
    directions, N, state_size). The time loop is the reference's cell step
    in torch ops (the reference's is a ``lax.scan``, not a kernel), each
    layer's input product one ``torch.matmul`` over the whole sequence;
    an LSTM's cell state is clipped to ``[lstm_state_clip_min,
    lstm_state_clip_max]`` after each step where a minimum is given.
    Between layers in training, dropout at ``p`` through :func:`dropout`
    (the K5 kernel on the card). ``sequence_length`` is accepted and, as
    in the reference, not used. Returns the output (T, N, dirs *
    state_size), with ``state_outputs`` also the final h (and c)."""
    dirs = 2 if bidirectional else 1
    input_size = data.shape[-1]
    clip = mode == "lstm" and lstm_state_clip_min is not None

    def f(x, params, h0, c0):
        layers = _unpack_rnn_params(params, mode, num_layers, input_size,
                                    state_size, bidirectional)
        out = x
        h_finals, c_finals = [], []
        for layer in range(num_layers):
            layer_outs = []
            for d in range(dirs):
                li = layer * dirs + d
                w_i2h, w_h2h, b_i2h, b_h2h = layers[li]
                h = h0[li]
                c = c0[li] if c0 is not None else torch.zeros_like(h)
                seq = out if d == 0 else torch.flip(out, (0,))
                xw = torch.matmul(seq, w_i2h.t()) + b_i2h
                ys = []
                for t in range(seq.shape[0]):
                    h, c = _cell_step(mode, xw[t], h, c, w_h2h, b_h2h)
                    if clip:
                        c = torch.clamp(c, lstm_state_clip_min,
                                        lstm_state_clip_max)
                    ys.append(h)
                ys = torch.stack(ys)
                layer_outs.append(ys if d == 0 else torch.flip(ys, (0,)))
                h_finals.append(h)
                c_finals.append(c)
            out = layer_outs[0] if dirs == 1 else torch.cat(layer_outs, -1)
            if p > 0 and layer < num_layers - 1:
                out = dropout(out, p=p)
        if mode == "lstm":
            return out, torch.stack(h_finals), torch.stack(c_finals)
        return out, torch.stack(h_finals)

    outs = _op("rnn", f, data, parameters, state, state_cell)
    return outs if state_outputs else outs[0]


# ---------------------------------------------------------------------------
# special functions
# ---------------------------------------------------------------------------

def erf(data):
    return _op("erf", torch.special.erf, data)


def erfinv(data):
    return _op("erfinv", torch.special.erfinv, data)


def gamma(data):
    """``exp(gammaln(x))``, the reference's form: |Γ(x)|, so a negative
    non-integer gives a positive value where Γ(x) is negative."""
    return _op("gamma", lambda x: torch.exp(torch.lgamma(x)), data)


def gammaln(data):
    """log |Γ(x)|."""
    return _op("gammaln", torch.lgamma, data)


def digamma(data):
    return _op("digamma", torch.special.digamma, data)


def smooth_l1(data, scalar=1.0):
    """``0.5 (σx)²`` where ``|x| < 1/σ²``, else ``|x| - 0.5/σ²``."""
    s2 = scalar * scalar

    def f(x):
        return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                           x.abs() - 0.5 / s2)

    return _op("smooth_l1", f, data)


# ---------------------------------------------------------------------------
# shape utilities
# ---------------------------------------------------------------------------

def cast(data, dtype):
    if isinstance(data, NDArray):
        return data.astype(dtype)
    return data.to(canonical_dtype(dtype))


def _reshape_codes(in_shape, newshape):
    """The target shape of MXNet's reshape codes, as the reference reads
    them: 0 copies the input's axis, -1 infers, -2 copies the remaining
    axes, -3 merges two, -4 splits one into the next two entries (either
    may be -1), -5 merges the remaining axes; any other negative entry
    goes to the reshape as it is (which rejects it)."""
    shape = list(newshape) if isinstance(newshape, (list, tuple)) \
        else [newshape]
    if all(isinstance(s, int) and s >= -1 for s in shape):
        return tuple(in_shape[i] if s == 0 and i < len(in_shape) else s
                     for i, s in enumerate(shape))
    out = []
    i = 0
    it = iter(range(len(shape)))
    for si in it:
        s = shape[si]
        if s == -2:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif s == -3:
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif s == -5:
            out.append(math.prod(in_shape[i:]))
            i = len(in_shape)
        elif s == -4:
            d1, d2 = shape[si + 1], shape[si + 2]
            next(it)
            next(it)
            if d1 == -1:
                d1 = in_shape[i] // d2
            if d2 == -1:
                d2 = in_shape[i] // d1
            out.extend([d1, d2])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == 0:
            out.append(in_shape[i])
            i += 1
        else:
            out.append(s)
            i += 1
    return tuple(out)


def reshape(data, newshape, reverse=False, **kwargs):  # noqa: ARG001
    """Reshape with MXNet's codes (see :func:`_reshape_codes`); the
    all-nonnegative fast path reads 0 as "copy this input axis" by
    position. ``reverse`` is taken and ignored, as in the reference."""
    shape = _reshape_codes(list(data.shape), newshape)
    return data.reshape(shape)


def shape_array(data):
    """The shape as an int32 vector on data's device."""
    t = data._data if isinstance(data, NDArray) else data
    out = torch.tensor(tuple(t.shape), dtype=torch.int32, device=t.device)
    return NDArray(out) if isinstance(data, NDArray) else out


def stop_gradient(data):
    return data.detach()


def slice_like(data, shape_like, axes=None):
    """``data`` sliced from 0 to ``shape_like``'s size on ``axes`` (every
    axis by default)."""
    target = tuple(shape_like.shape)

    def f(d):
        sl = [builtins.slice(None)] * d.dim()
        for a in (range(d.dim()) if axes is None else axes):
            sl[a] = builtins.slice(0, target[a])
        return d[tuple(sl)]

    return _op("slice_like", f, data)


def broadcast_like(data, other, lhs_axes=None, rhs_axes=None):
    """``data`` broadcast to ``other``'s shape (only on ``lhs_axes``, to
    ``other``'s sizes on ``rhs_axes``, when given)."""
    target = tuple(other.shape)

    def f(d):
        if lhs_axes is None:
            return torch.broadcast_to(d, target)
        shape = list(d.shape)
        for la, ra in zip(lhs_axes, rhs_axes):
            shape[la] = target[ra]
        return torch.broadcast_to(d, tuple(shape))

    return _op("broadcast_like", f, data)


def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]`` over the last axis."""
    def f(x, idx):
        return _take_along(x, idx.to(torch.int64).unsqueeze(-1),
                           -1).squeeze(-1)

    return _op("batch_take", f, a, indices)


def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    The output's shape depends on the mask's values, so the mask is read
    on the host (a synchronisation, as the reference resolves it
    eagerly); inside a CUDA-graph capture that raises
    :class:`MXNetError`. The selection is a differentiable gather."""
    _no_capture("boolean_mask")
    m = index._data if isinstance(index, NDArray) else index
    m = torch.as_tensor(m).detach()
    if m.shape[0] != data.shape[axis]:
        raise ValueError(f"boolean_mask: mask length {m.shape[0]} != "
                         f"data.shape[{axis}] = {data.shape[axis]}")
    keep = torch.nonzero(m.reshape(-1).cpu() != 0).reshape(-1)

    def f(v):
        return v.index_select(axis, keep.to(v.device))

    return _op("boolean_mask", f, data)


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (rebound, as the reference's ``_set_data``) so that
    their global L2 norm is at most ``max_norm``; returns that norm
    before scaling as a Python float, which reads it on the host once
    (one synchronisation, the reference's contract; raises
    :class:`MXNetError` inside a CUDA-graph capture). ``check_isfinite``:
    a norm that is not finite raises ValueError."""
    _no_capture("clip_global_norm")
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    with torch.no_grad():
        sums = torch.stack([(t.detach().float() ** 2).sum()
                            for t in tensors])
        total = float(sums.double().sum())
    total_norm = math.sqrt(total)
    if check_isfinite and not math.isfinite(total_norm):
        raise ValueError("global norm is not finite")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            if isinstance(a, NDArray):
                a._set_data(a._data * scale)
            else:
                with torch.no_grad():
                    a.mul_(scale)
    return total_norm


# ---------------------------------------------------------------------------
# control flow: eager Python loops; inside a CUDA-graph capture (a
# hybridized block, a DataParallel step) the traced form of the reference
# (lax.scan / lax.while_loop / lax.cond), with no value read on the host
# ---------------------------------------------------------------------------

def _stack(outputs):
    if isinstance(outputs[0], NDArray):
        from .. import numpy as _np

        return _np.stack(outputs)
    return torch.stack(outputs)


def foreach(body, data, init_states):
    """``body(x_i, states) -> (out, states)`` over axis-0 slices of
    ``data`` (an array or a list of arrays), the outputs stacked. A
    Python loop of the data's static length: it reads no value on the
    host, so it runs inside a capture as it does eagerly."""
    multi_data = isinstance(data, (list, tuple))
    multi_state = isinstance(init_states, (list, tuple))
    states = list(init_states) if multi_state else [init_states]
    outputs = []
    n = data[0].shape[0] if multi_data else data.shape[0]
    for i in range(n):
        x_i = [d[i] for d in data] if multi_data else data[i]
        out, states = body(x_i, states if multi_state else states[0])
        states = list(states) if isinstance(states, (list, tuple)) \
            else [states]
        outputs.append(out)
    if outputs and isinstance(outputs[0], (list, tuple)):
        stacked = [_stack([o[j] for o in outputs])
                   for j in range(len(outputs[0]))]
    else:
        stacked = _stack(outputs)
    return stacked, (states if multi_state else states[0])


def _where(active, new, old):
    """``new`` where ``active`` (a device bool scalar), else ``old``,
    recorded through the funnel for NDArrays."""
    return _op("where", lambda n, o: torch.where(active, n, o), new, old)


def _zeros_like(o):
    return _op("zeros_like", torch.zeros_like, o)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _while_loop_captured(cond, func, loop_vars, max_iterations):
    """The traced ``while_loop`` (the reference's ``lax.while_loop`` with
    its output buffers): ``max_iterations`` steps predicated on a device
    flag, ``active = active & cond(vars)``; an inactive step keeps the
    loop variables and writes zeros to the outputs, which come stacked
    to length ``max_iterations``. No value is read on the host, so a
    CUDA graph can hold it; ``func`` runs every step and must be pure,
    as the reference requires."""
    if max_iterations is None:
        raise MXNetError("npx.while_loop inside a CUDA-graph capture needs "
                         "max_iterations (the loop cannot stop on a value "
                         "read on the host)")
    loop_vars = list(loop_vars)
    first = loop_vars[0]
    t = first._data if isinstance(first, NDArray) else first
    active = torch.ones((), dtype=torch.bool, device=t.device)
    outputs = []
    tuple_out = False
    for _ in range(max_iterations):
        c = cond(*loop_vars)
        c = c._data if isinstance(c, NDArray) else torch.as_tensor(
            c, device=t.device)
        active = active & c.detach().reshape(()).bool()
        out, new_vars = func(*loop_vars)
        loop_vars = [_where(active, nv, v)
                     for nv, v in zip(_as_list(new_vars), loop_vars)]
        if out is not None:
            tuple_out = isinstance(out, (list, tuple))
            outputs.append([_where(active, o, _zeros_like(o))
                            for o in _as_list(out)])
    if not outputs:
        return None, loop_vars
    stacked = [_stack([o[j] for o in outputs])
               for j in range(len(outputs[0]))]
    return (stacked if tuple_out else stacked[0]), loop_vars


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``func(*vars) -> (out, vars)`` while ``cond(*vars)`` holds, at most
    ``max_iterations`` times; the per-step outputs stacked, padded with
    zeros to ``max_iterations`` when it is given (the reference's
    contract). Eagerly the condition is read on the host each step;
    inside a CUDA-graph capture the loop is :func:`_while_loop_captured`
    (``max_iterations`` required)."""
    if _capturing():
        return _while_loop_captured(cond, func, loop_vars, max_iterations)
    loop_vars = list(loop_vars)
    steps = 0
    outputs = []
    while bool(cond(*loop_vars)):
        if max_iterations is not None and steps >= max_iterations:
            break
        out, loop_vars = func(*loop_vars)
        loop_vars = list(loop_vars)
        if out is not None:
            outputs.append(out)
        steps += 1
    if not outputs:
        if max_iterations is None:
            return None, loop_vars
        # the padded-output contract with no step run: func (pure) probes
        # the outputs' structure
        probe, _ = func(*loop_vars)
        if probe is None:
            return None, loop_vars
        zeros = [_op("zeros", lambda o: o.new_zeros(
            (max_iterations,) + tuple(o.shape)), o) for o in _as_list(probe)]
        return (zeros if isinstance(probe, (list, tuple)) else zeros[0]), \
            loop_vars
    tuple_out = isinstance(outputs[0], (list, tuple))
    stacked = [_stack([_as_list(o)[j] for o in outputs])
               for j in range(len(_as_list(outputs[0])))]
    if max_iterations is not None and len(outputs) < max_iterations:
        pad = max_iterations - len(outputs)
        stacked = [_op("pad", lambda s: torch.cat(
            [s, s.new_zeros((pad,) + tuple(s.shape[1:]))]), s)
            for s in stacked]
    return (stacked if tuple_out else stacked[0]), loop_vars


def _cond_captured(pred, then_func, else_func):
    """The traced ``cond`` (``lax.cond`` as it runs traced): both branches
    evaluated, each output selected on the device by ``pred``."""
    p = pred._data if isinstance(pred, NDArray) else torch.as_tensor(pred)
    p = p.detach().reshape(()).bool()
    a, b = then_func(), else_func()
    if isinstance(a, (list, tuple)):
        return type(a)(_where(p, x, y) for x, y in zip(a, b))
    return _where(p, a, b)


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` else ``else_func()``: eagerly ``pred``
    is read on the host; inside a CUDA-graph capture both branches run
    and the result is selected on the device (:func:`_cond_captured`)."""
    if _capturing():
        return _cond_captured(pred, then_func, else_func)
    return then_func() if bool(pred) else else_func()


# ---------------------------------------------------------------------------
# mode switches and state
# ---------------------------------------------------------------------------

def set_np(shape=True, array=True, dtype=False):  # noqa: ARG001
    """NumPy semantics are always on in the port, as in the reference:
    returns True."""
    return True


def reset_np():
    return True


def is_np_array():
    return True


def is_np_shape():
    return True


def waitall():
    from ..ndarray.ndarray import waitall as _waitall

    _waitall()


def seed(s):
    _random.seed(s)


def load(fname):
    from ..ndarray import load as _load

    return _load(fname)


def save(fname, data):
    from ..ndarray import save as _save

    return _save(fname, data)


from ._contrib_misc import (adaptive_avg_pooling2d,  # noqa: E402
                            add_n, all_finite, batch_norm_with_relu,
                            dynamic_reshape, gradientmultiplier,
                            index_array, index_copy, multi_all_finite, norm,
                            pad, quadratic, round_ste, sign_ste, slice,
                            slice_channel, softsign)
from ._spatial import (deformable_convolution,  # noqa: E402
                       modulated_deformable_convolution)
from ._transformer import (div_sqrt_dim,  # noqa: E402
                           interleaved_matmul_encdec_qk,
                           interleaved_matmul_encdec_valatt,
                           interleaved_matmul_selfatt_qk,
                           interleaved_matmul_selfatt_valatt,
                           sldwin_atten_context, sldwin_atten_mask_like,
                           sldwin_atten_score)
