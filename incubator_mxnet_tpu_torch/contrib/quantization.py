"""INT8 post-training quantization (port of `incubator_mxnet_tpu/contrib/
quantization.py`: calibration :43-205, `_quantize_weight` :212,
`quantize_symmetric` :221, `dequantize_symmetric` :243, `QuantizedDense`
:293, `QuantizedConv2D` :367, `fold_conv_bn` :443, `_chain_requantize`
:516, `QuantizedResidualBlock` :569, `chain_residual_blocks` :679,
`chain_boundaries` :865, `quantize_net` :933, `quantize_model` :991).

As in the reference, calibrated Dense/Conv2D blocks are REPLACED with
quantized blocks whose forward is

    xq = clip(round(x / s_x))  ->  int8 x int8 product, int32 sums
                               ->  y = acc * (s_x * s_w[oc]) + bias

with symmetric per-output-channel weight scales and one calibrated
symmetric activation scale (minmax or KL-entropy). The product and its
epilogue are the Q1 kernel on the card (`ops.quantized`: the reference's
XLA contraction at ``preferred_element_type=int32``); no float emulation
of the int8 product runs there. Quantizing a float input, the residual
add on int8 codes and the relu/Identity glue between chained layers are
plain torch ops, as they are XLA's in the reference (each division a true
division, `ops.quantized._true_div`). Integer max pooling is Q2
(`npx.pooling`). Quantized weights, scales and thresholds live in
registered `Constant` parameters under the reference's names
(``qweight``, ``qscale``, ``qthreshold``, ``qbias``,
``qadd_threshold``), on the device of the layer they replace, so a net
quantized and saved by either package loads into the other's with
``load_parameters``. A chained producer reads its consumer's threshold
Parameter itself (never a copy of its value): ``load_parameters``
updates it in place and the producer's emit scale follows, in a replayed
CUDA graph too.

The int8 serving KV pool (`serve.SlotDecoder`, ``kv_dtype="int8"``)
quantizes each page with :func:`quantize_symmetric`; its convention is
the reference's, one f32 scale a group, ``max(absmax, 1e-8) / 127``, and
codes ``clip(round(x / scale), -127, 127)``, where `torch.round` rounds
half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import re

import numpy as onp
import torch

from .. import numpy_extension as npx
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Constant, Parameter
from ..ndarray.ndarray import NDArray, apply_op
from ..ops import quantized as _quant
from ..ops.quantized import _true_div

__all__ = ["quantize_net", "quantize_model", "QuantizedDense",
           "QuantizedConv2D", "optimal_threshold_entropy",
           "collect_thresholds", "fold_conv_bn",
           "quantize_symmetric", "dequantize_symmetric"]


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _smooth_distribution(p, eps=1e-4):
    """Redistribute a little mass from nonzero to zero entries so the KL
    term is defined everywhere (reference: the calibration smoothing in
    `src/operator/quantization/calibrate.cc`). Returns None when the
    distribution can't absorb the smoothing."""
    is_zero = p == 0
    n_nonzero = p.size - is_zero.sum()
    if n_nonzero == 0:
        return None
    eps1 = eps * is_zero.sum() / n_nonzero
    out = p.astype(onp.float64).copy()
    out[is_zero] = eps
    out[~is_zero] -= eps1
    if (out[~is_zero] <= 0).any():
        return None
    return out


def optimal_threshold_entropy(hist, bin_edges, num_quantized_bins=255):
    """KL-divergence-optimal clip threshold over an |activation| histogram
    (reference: `src/operator/quantization/calibrate.cc` GetOptimalThreshold
    — the TensorRT-style entropy calibration). For each candidate clip bin
    `i`, the first `i` bins (outlier mass folded into bin i-1) are merged
    into `num_quantized_bins` equal-width groups; each nonzero position
    gets its group's nonzero-average; both distributions are eps-smoothed
    and the KL(P||Q)-minimizing threshold wins."""
    hist = onp.asarray(hist, dtype=onp.float64)
    num_bins = hist.size
    if num_bins <= num_quantized_bins:
        return float(bin_edges[-1])
    total = hist.sum()
    if total == 0:
        return float(bin_edges[-1])
    # suffix[i] = hist[i:].sum(); csum/cnz give O(1) range sums below
    suffix = onp.concatenate([hist[::-1].cumsum()[::-1], [0.0]])
    csum = onp.concatenate([[0.0], hist.cumsum()])
    cnz = onp.concatenate([[0], (hist > 0).cumsum()])
    best_kl = onp.inf
    best_i = num_bins
    for i in range(num_quantized_bins, num_bins + 1):
        p = hist[:i].copy()
        p[i - 1] += suffix[i]            # clip outliers into last bin
        nm = i // num_quantized_bins     # merged bins per quantized bin
        starts = onp.arange(num_quantized_bins) * nm
        stops = onp.concatenate([starts[1:], [i]])  # last absorbs remainder
        sums = csum[stops] - csum[starts]
        norms = cnz[stops] - cnz[starts]
        nzp = hist[:i] > 0
        if suffix[i] > 0 and hist[i - 1] == 0:
            # folding outliers made position i-1 (in the last group) nonzero
            nzp = nzp.copy()
            nzp[i - 1] = True
            norms[-1] += 1
        vals = onp.where(norms > 0, sums / onp.maximum(norms, 1), 0.0)
        owner = onp.minimum(onp.arange(i) // nm, num_quantized_bins - 1)
        q = vals[owner] * nzp
        ps = _smooth_distribution(p)
        qs = _smooth_distribution(q)
        if ps is None or qs is None:
            continue
        ps /= ps.sum()
        qs /= qs.sum()
        kl = float((ps * onp.log(ps / qs)).sum())
        if kl < best_kl:
            best_kl = kl
            best_i = i
    return float(bin_edges[best_i])


class _ActivationStats:
    """Two-pass activation collector: absmax, then histogram for entropy."""

    def __init__(self, num_bins=2048):
        self.num_bins = num_bins
        self.absmax = 0.0
        self.hist = None
        self.bin_edges = None

    def update_minmax(self, x):
        self.absmax = max(self.absmax, float(onp.abs(x).max()))

    def update_hist(self, x):
        if self.absmax == 0.0:
            return
        h, edges = onp.histogram(onp.abs(x), bins=self.num_bins,
                                 range=(0.0, self.absmax))
        if self.hist is None:
            self.hist = h.astype(onp.float64)
            self.bin_edges = edges
        else:
            self.hist += h

    def threshold(self, mode):
        if mode == "naive" or self.hist is None:
            return self.absmax if self.absmax > 0 else 1.0
        return optimal_threshold_entropy(self.hist, self.bin_edges)


def _iter_calib(calib_data, num_batches):
    n = 0
    for batch in calib_data:
        if n >= num_batches:
            break
        x = batch[0] if isinstance(batch, (list, tuple)) else batch
        yield x
        n += 1


def _hybrid_blocks(block, out=None):
    if out is None:
        out = []
    if hasattr(block, "_active"):
        out.append(block)
    for child in block._children.values():
        _hybrid_blocks(child, out)
    return out


def _host(x):
    """A calibration activation on the host (an NDArray or a tensor)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return onp.asarray(x)


def _as_input(x):
    return x if isinstance(x, (NDArray, torch.Tensor)) else NDArray(x)


def collect_thresholds(net, layers, calib_data, calib_mode="entropy",
                       num_calib_batches=10, num_bins=2048):
    """Run calibration forwards, recording each target layer's INPUT
    activation distribution; returns {layer_id: threshold}.

    Calibration must execute eagerly — a captured graph would bypass the
    per-layer hooks (and their host copies would not run inside it) — so
    hybridization is suspended for the duration and restored after.
    """
    stats = {id(layer): _ActivationStats(num_bins) for _, _, layer in layers}

    def _hook(layer, phase):
        orig = layer.forward

        def wrapped(x, *args, **kwargs):
            xv = _host(x)
            if phase == "minmax":
                stats[id(layer)].update_minmax(xv)
            else:
                stats[id(layer)].update_hist(xv)
            return orig(x, *args, **kwargs)

        return wrapped

    phases = ["minmax"] + (["hist"] if calib_mode == "entropy" else [])
    batches = list(_iter_calib(calib_data, num_calib_batches))
    hybrids = _hybrid_blocks(net)
    was_active = [(b, b._active) for b in hybrids]
    try:
        for b in hybrids:
            b._active = False
            b._cached_graph = None
        for phase in phases:
            try:
                for _, _, layer in layers:
                    layer.forward = _hook(layer, phase)
                for x in batches:
                    net(_as_input(x))
            finally:
                for _, _, layer in layers:
                    layer.__dict__.pop("forward", None)
    finally:
        for b, active in was_active:
            b._active = active
    return {lid: s.threshold(calib_mode) for lid, s in stats.items()}


# ---------------------------------------------------------------------------
# quantized blocks
# ---------------------------------------------------------------------------

def _quantize_weight(w, axes):
    """Symmetric per-output-channel int8 weights. `axes` = reduction axes
    (all but the output-channel axis 0)."""
    absmax = onp.maximum(onp.abs(w).max(axis=axes, keepdims=True), 1e-8)
    scale = absmax / 127.0
    wq = onp.clip(onp.round(w / scale), -127, 127).astype(onp.int8)
    return wq, scale.astype(onp.float32)


def quantize_symmetric(x, axes, scale=None):
    """Symmetric int8 quantization of ``x``.

    ``axes`` are the reduction axes of the absmax group (a KV page's
    token x head-dim block is ``(2, 3)``); ``scale`` overrides the derived
    ``absmax / 127`` (re-quantizing into an existing page's scale), and
    then ``axes`` is unused. Returns ``(q_int8, scale)`` with ``scale``
    keeping the reduced axes as size-1 dims, so ``q * scale`` dequantizes
    by broadcast."""
    if scale is None:
        absmax = x.abs()
        if axes:
            absmax = absmax.amax(dim=tuple(axes), keepdim=True)
        scale = torch.clamp_min(absmax, 1e-8).float() / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_symmetric(q, scale, dtype=None):
    """Inverse of `quantize_symmetric`: ``q * scale`` in the scale's dtype
    (or ``dtype``)."""
    x = q.to(scale.dtype) * scale
    return x if dtype is None else x.to(dtype)


def _device_of(param):
    return param._data._data.device


def _apply(name, fn, *args):
    """``fn`` through the NDArray funnel (`apply_op`) for a call with
    NDArrays, else on the tensors directly (a block called with torch
    tensors)."""
    if any(isinstance(a, NDArray) for a in args):
        return apply_op(name, fn, args)
    return fn(*args)


def _constant(value, device, channels_last=False):
    """A Constant holding the numpy ``value`` on ``device`` (a 4-d value
    stored channels-last where asked: ``set_data`` and ``load_parameters``
    copy into the tensor and keep its strides)."""
    t = torch.from_numpy(onp.array(value, copy=True))
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return Constant(NDArray(t, device=device))


def _chain_dtype(layer, x):
    """Activation dtype carried across an int8 requantize chain: an int8
    input can't say what the net's float dtype is, so each producer
    records it on its consumer before that consumer runs. Returns the
    dtype this layer's output should restore to."""
    x_dt = (x._data if isinstance(x, NDArray) else x).dtype
    if x_dt == torch.int8:
        chain_dt = layer.__dict__.get("_chain_in_dt", torch.float32)
    else:
        chain_dt = x_dt
    consumer = layer.__dict__.get("_chain_consumer")
    if layer._out_threshold is not None and consumer is not None:
        # a producer may feed SEVERAL decoders of the same codes (a
        # residual block's body[0] AND its downsample both consume the
        # boundary producer's emit): seed every one, or the later branch
        # would clobber the dtype with the float32 default
        consumers = consumer if isinstance(consumer, (tuple, list)) \
            else (consumer,)
        for c in consumers:
            c.__dict__["_chain_in_dt"] = chain_dt
    return chain_dt


def _quantize_input(xv, thresh):
    """``clip(round(x / s_x), -127, 127)`` as int8, s_x = thresh / 127
    (the reference's order, both divisions true divisions). 4-d codes come
    out channels-last, the int8 chain's layout (the cast writes them
    there: no extra pass)."""
    s_x = _true_div(thresh.float().reshape(()), 127.0)
    q = torch.clamp(torch.round(xv.float() / s_x), -127, 127)
    if q.dim() == 4:
        return torch.empty_like(q, dtype=torch.int8,
                                memory_format=torch.channels_last).copy_(q)
    return q.to(torch.int8)


class QuantizedDense(HybridBlock):
    """INT8 Dense (reference: quantized_fully_connected.cc). Holds int8
    weights + per-channel scales in Constant parameters; forward quantizes
    the activation with the calibrated threshold and runs the int8 product
    and its epilogue on Q1 (`ops.quantized.dense_int8`)."""

    def __init__(self, dense, threshold):
        super().__init__()
        dev = _device_of(dense.weight)
        w = dense.weight.data().asnumpy()
        wq, w_scale = _quantize_weight(w, axes=1)   # (units, in), scale (units,1)
        self.qweight = _constant(wq, dev)
        self.qscale = _constant(w_scale[:, 0], dev)
        self.qthreshold = _constant(onp.float32(threshold), dev)
        self.qbias = (Constant(NDArray(dense.bias._data._data.detach()
                                       .clone()))
                      if dense.bias is not None else None)
        self._units = dense._units
        self._flatten = dense._flatten
        self._out_threshold = None   # set by requantize chaining
        self.act = dense.act
        if self.act is not None:
            self.register_child(self.act, "act")

    def forward(self, x):
        flatten = self._flatten
        has_bias = self.qbias is not None
        has_out = self._out_threshold is not None
        chain_dt = _chain_dtype(self, x)

        def f(xv, wq, w_scale, thresh, *rest):
            if flatten and xv.dim() > 2:
                xv = xv.reshape(xv.shape[0], -1)
            if xv.dtype == torch.int8:
                # requantize-chained producer already emitted at our scale
                xq, out_dt = xv, chain_dt
            else:
                xq, out_dt = _quantize_input(xv, thresh), xv.dtype
            rest = list(rest)
            bias = rest.pop(0) if has_bias else None
            # emit int8 at the CONSUMER'S calibrated scale; relu / identity
            # glue in between is monotonic so it commutes with the rounding
            out_t = rest.pop(0) if has_out else None
            return _quant.dense_int8(xq, wq, thresh, w_scale, bias, out_t,
                                     torch.int8 if has_out else out_dt)

        args = (x, self.qweight.data(), self.qscale.data(),
                self.qthreshold.data())
        if has_bias:
            args = args + (self.qbias.data(),)
        if has_out:
            args = args + (self._out_threshold.data(),)
        out = _apply("quantized_dense", f, *args)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        t = float(self.qthreshold.data().asnumpy())
        return f"QuantizedDense({self._units}, threshold={t:.4g})"


class QuantizedConv2D(HybridBlock):
    """INT8 2D convolution (reference: quantized_conv.cc), NCHW layout, on
    Q1 (`ops.quantized.conv_int8`). The int8 weight is stored
    channels-last ((O, kh, kw, C/g) in memory, Q1's K-major B), its shape
    and checkpoint key the reference's. Called by its residual block with
    ``residual=`` (the block's other branch), it runs the block's add,
    relu and requantize in Q1's epilogue."""

    def __init__(self, conv, threshold):
        super().__init__()
        dev = _device_of(conv.weight)
        w = conv.weight.data().asnumpy()            # (O, I, kh, kw)
        wq, w_scale = _quantize_weight(w, axes=(1, 2, 3))
        self.qweight = _constant(wq, dev, channels_last=True)
        self.qscale = _constant(w_scale.reshape(-1), dev)  # (O,)
        self.qthreshold = _constant(onp.float32(threshold), dev)
        self.qbias = (Constant(NDArray(conv.bias._data._data.detach()
                                       .clone()))
                      if conv.bias is not None else None)
        self._stride = conv._stride
        self._pad = conv._pad
        self._dilate = conv._dilate
        self._groups = conv._groups
        self._out_threshold = None   # set by requantize chaining
        self.act = conv.act
        if self.act is not None:
            self.register_child(self.act, "act")

    def forward(self, x, residual=None, residual_mode="same",
                residual_t=None, block_out_t=None, out_dtype=None,
                relu=False):
        """``residual``: the int8 codes of the other branch of the residual
        block this conv ends, added in the epilogue with ``residual_mode``,
        ``residual_t`` and ``block_out_t`` into ``out_dtype``, as
        `ops.quantized.conv_int8` takes them (the block resolves them).
        ``relu``: relu on the int8 codes this conv emits (the relu glue
        that follows it in the block's body, which the block then
        skips)."""
        stride, pad, dilate, groups = (self._stride, self._pad,
                                       self._dilate, self._groups)
        has_bias = self.qbias is not None
        has_out = self._out_threshold is not None
        chain_dt = _chain_dtype(self, x)
        extra = {k: v for k, v in (("residual", residual),
                                   ("residual_t", residual_t),
                                   ("block_out_t", block_out_t))
                 if v is not None}

        def f(xv, wq, w_scale, thresh, *rest):
            if xv.dtype == torch.int8:
                xq, out_dt = xv, chain_dt
            else:
                xq, out_dt = _quantize_input(xv, thresh), xv.dtype
            rest = list(rest)
            bias = rest.pop(0) if has_bias else None
            out_t = rest.pop(0) if has_out else None
            if out_dtype is not None:
                out_dt = out_dtype
            elif has_out:
                out_dt = torch.int8
            return _quant.conv_int8(xq, wq, thresh, w_scale, bias, out_t,
                                    out_dt, stride, pad, dilate, groups,
                                    residual_mode=residual_mode, relu=relu,
                                    **dict(zip(extra, rest)))

        args = (x, self.qweight.data(), self.qscale.data(),
                self.qthreshold.data())
        if has_bias:
            args = args + (self.qbias.data(),)
        if has_out:
            args = args + (self._out_threshold.data(),)
        args = args + tuple(extra.values())
        out = _apply("quantized_conv", f, *args)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        t = float(self.qthreshold.data().asnumpy())
        return f"QuantizedConv2D(threshold={t:.4g})"


# ---------------------------------------------------------------------------
# net rewrite
# ---------------------------------------------------------------------------

def fold_conv_bn(net, logger=None):
    """Fold inference-mode BatchNorm into the preceding Conv2D/Dense
    wherever the two are ADJACENT children of the same block (the
    HybridSequential conv→bn idiom of every model_zoo CNN). The BN becomes
    `nn.Identity`, and the conv's weights/bias absorb the affine:

        w' = w * (gamma/sqrt(var+eps))[oc],  b' = beta - mean*gamma/sqrt(..)

    Reference: the oneDNN quantize pass does the same fold before emitting
    int8 kernels (`src/operator/subgraph/dnnl/dnnl_conv_property.h` — conv
    +bn fusion), which is why its int8 chains have no f32 BN in between.
    Safe only for inference: running stats are frozen into the weights.
    The weight is written in place (`Parameter.set_data`); a new bias is a
    Parameter on the weight's device in its dtype. Returns the number of
    folds performed."""
    n_folds = 0
    stack = [net]
    while stack:
        block = stack.pop()
        # declaration order equals dataflow order ONLY inside
        # HybridSequential — arbitrary blocks may declare parallel branches
        # as adjacent attributes, so only sequential containers are folded
        if isinstance(block, nn.HybridSequential):
            names = list(block._children)
        else:
            names = []
        for a, b in zip(names, names[1:]):
            ca, cb = block._children[a], block._children[b]
            # exact type: BatchNormReLU is a subclass whose fused relu
            # must survive the fold as an explicit Activation
            bn_relu = type(cb).__name__ == "BatchNormReLU"
            if not (type(cb) is nn.BatchNorm or bn_relu):
                continue
            if not isinstance(ca, (nn.Conv2D, nn.Dense)):
                continue
            # a fused activation runs BETWEEN the conv output and the BN:
            # folding would move the BN affine to before the relu, changing
            # results. The reference oneDNN pass only folds bare conv->BN.
            if getattr(ca, "act", None) is not None:
                if logger:
                    logger.info("skip BN fold into %s: fused activation", a)
                continue
            gamma = (cb.gamma.data().asnumpy() if cb._scale
                     else onp.ones(cb.running_var.shape, onp.float32))
            beta = cb.beta.data().asnumpy()
            mean = cb.running_mean.data().asnumpy()
            var = cb.running_var.data().asnumpy()
            inv = gamma / onp.sqrt(var + cb._epsilon)
            w = ca.weight.data().asnumpy()
            w_shape = (-1,) + (1,) * (w.ndim - 1)
            # keep the conv's declared dtype: set_data writes into the
            # weight's own tensor, rounding to it once
            ca.weight.set_data(w * inv.reshape(w_shape))
            bias = beta - mean * inv
            if ca.bias is not None:
                bias = bias + ca.bias.data().asnumpy() * inv
                ca.bias.set_data(bias)
            else:
                wt = ca.weight._data._data
                p = Parameter(shape=bias.shape, dtype=ca.weight.dtype)
                p.set_data(torch.from_numpy(onp.asarray(bias)).to(
                    device=wt.device, dtype=wt.dtype))
                ca.bias = p
            _replace_child(block, b, cb,
                           nn.Activation("relu") if bn_relu else nn.Identity())
            n_folds += 1
            if logger:
                logger.info("folded BatchNorm %s into %s", b, a)
        stack.extend(c for c in block._children.values()
                     if isinstance(c, HybridBlock))
    for blk in _hybrid_blocks(net):
        blk._cached_graph = None
    return n_folds


def _chain_requantize(net, logger=None):
    """Where quantized layers follow each other through only monotonic
    elementwise glue (relu Activations / Identity) inside one container,
    make the producer emit int8 AT THE CONSUMER'S SCALE so no f32
    activation materializes between int8 products (reference:
    `src/operator/quantization/requantize-inl.h` chained through the
    quantize_graph_pass). Returns the number of chained pairs."""
    n_chained = 0
    stack = [net]
    while stack:
        block = stack.pop()
        # same restriction as fold_conv_bn: only HybridSequential children
        # are guaranteed to run in declaration order
        kids = ([block._children[n] for n in block._children]
                if isinstance(block, nn.HybridSequential) else [])
        for i, prod in enumerate(kids):
            if not isinstance(prod, (QuantizedConv2D, QuantizedDense)):
                continue
            # the int8 emit happens BEFORE the producer's own fused
            # activation; only a monotonic non-saturating act (relu) or
            # none commutes with the rounding — sigmoid/tanh/gelu applied
            # to int8 CODES would be nonsense
            if prod.act is not None and getattr(
                    prod.act, "_act_type", None) != "relu":
                continue
            j = i + 1
            while j < len(kids) and (
                    isinstance(kids[j], nn.Identity)
                    or (isinstance(kids[j], nn.Activation)
                        and kids[j]._act_type == "relu")):
                j += 1
            if j < len(kids) and isinstance(
                    kids[j], (QuantizedConv2D, QuantizedDense)):
                # share the consumer's qthreshold PARAMETER (not a baked
                # float): load_parameters updates it in place and the
                # producer's emit scale follows. __dict__ assignment on
                # purpose — Block.__setattr__ would REGISTER the shared
                # Parameter under the producer (duplicate checkpoint key,
                # renamed parameter)
                prod.__dict__["_out_threshold"] = kids[j].qthreshold
                # back-ref so the producer can forward its activation
                # dtype to the chain consumer (last layer of an int8
                # chain must emit the NET'S dtype, not hardcoded f32)
                prod.__dict__["_chain_consumer"] = kids[j]
                n_chained += 1
                if logger:
                    logger.info("requantize-chained %s -> %s",
                                type(prod).__name__, type(kids[j]).__name__)
        stack.extend(c for c in block._children.values()
                     if isinstance(c, HybridBlock))
    return n_chained


def _residual_add(av, rv, t_add, t_in, out_t, ds_chained, chain_dt):
    """The residual block's add, relu and requantize in torch ops, as the
    reference's block computes them (`incubator_mxnet_tpu/contrib/
    quantization.py:618-647`): ``av`` the body's output (int8 at t_add, or
    float), ``rv`` the other branch (int8 at t_add where the downsample is
    chained, the block's input at ``t_in``, or float); int8 at ``out_t``
    (the next block's threshold) or ``chain_dt``. Q1's epilogue runs the
    same steps where both branches are int8 (`ops.quantized.
    plain_epilogue`)."""
    i8 = torch.int8
    s_add = _true_div(t_add.float(), 127.0)
    if av.dtype == i8 and rv.dtype == i8 and ds_chained:
        # both branches int8 AT THE SAME SCALE: integer add
        y = (av.to(torch.int32) + rv.to(torch.int32)).float() * s_add
        out_dt = chain_dt
    else:
        ya = av.float() * s_add if av.dtype == i8 else av.float()
        if rv.dtype == i8 and t_in is not None:
            s_in = _true_div(t_in.float(), 127.0)
            yr = rv.float() * s_in
        else:
            if rv.dtype == i8:
                raise TypeError("int8 identity without scale")
            yr = rv.float()
        y = ya + yr
        out_dt = chain_dt if (av.dtype == i8 or rv.dtype == i8) \
            else av.dtype
    y = torch.relu(y)
    if out_t is not None:
        return torch.clamp(torch.round(y * _true_div(127.0, out_t.float())),
                           -127, 127).to(i8)
    return y.to(out_dt)


class QuantizedResidualBlock(HybridBlock):
    """INT8 residual block (reference: the oneDNN subgraph pass fuses
    conv+sum+relu into one int8 primitive, `src/operator/subgraph/dnnl/
    dnnl_conv_property.h` sum fusion).

    Wraps a quantized BottleneckV1/BasicBlockV1: the body's LAST conv and
    the downsample's last conv both emit int8 at a SHARED add-scale
    (T_add), so the residual add is int8+int8 — add, relu, and the
    requantize to the NEXT block's input scale never materialize an f32
    activation between blocks. The identity branch arrives as int8 at this
    block's own input scale (the previous block emitted it there). The
    add, relu and requantize are torch ops on the card, as they are one
    XLA fusion in the reference. Where both branches arrive as int8
    (every block of a chained ResNet v1) the port runs the add, relu and
    requantize in the epilogue of the body's last conv (Q1, its residual
    operand): the downsample first, then the body up to that conv, which
    takes the other branch; on the way, a body conv that emits int8 codes
    followed by relu glue applies the relu to its codes in its epilogue
    and the glue is skipped. Otherwise they are torch ops, as the
    reference's function computes them.
    """

    def __init__(self, block, t_add):
        super().__init__()
        self.body = block.body
        self.downsample = block.downsample
        body_last = _last_quantized(self.body)
        self.qadd_threshold = _constant(onp.float32(t_add),
                                        _device_of(body_last.qweight))
        body_last.__dict__["_out_threshold"] = self.qadd_threshold
        body_last.__dict__["_chain_consumer"] = self
        self._ds_chained = False
        if self.downsample is not None:
            ds_last = _last_quantized(self.downsample)
            if ds_last is not None:
                ds_last.__dict__["_out_threshold"] = self.qadd_threshold
                ds_last.__dict__["_chain_consumer"] = self
                self._ds_chained = True
        # input scale of the identity branch = the first body conv's
        # calibrated input threshold (the previous block emits there).
        # __dict__ writes on purpose: Block.__setattr__ would RE-REGISTER
        # (and rename) the shared Parameter under this wrapper — the
        # duplicate-checkpoint-key hazard _chain_requantize documents
        first = self.body._children[list(self.body._children)[0]]
        self.__dict__["_in_threshold"] = getattr(first, "qthreshold", None)
        self.__dict__["_out_threshold"] = None  # set when NEXT block chains
        self.__dict__["_chain_consumer"] = None

    def _fused_site(self):
        """(body's children, index of its last conv) where that conv can
        take the add in its epilogue: it emits at the add's threshold, has
        no activation of its own, and only Identity follows it."""
        if not isinstance(self.body, nn.HybridSequential):
            return None
        kids = list(self.body._children.values())
        i = len(kids) - 1
        while i >= 0 and isinstance(kids[i], nn.Identity):
            i -= 1
        last = kids[i] if i >= 0 else None
        if isinstance(last, QuantizedConv2D) and last.act is None and \
                last.__dict__.get("_out_threshold") is self.qadd_threshold:
            return kids, i
        return None

    def forward(self, x):
        if self.downsample is not None:
            res = self.downsample(x)
        else:
            res = x
        site = self._fused_site()
        r_dt = (res._data if isinstance(res, NDArray) else res).dtype
        if site is not None and r_dt == torch.int8 and (
                self._ds_chained or self._in_threshold is not None):
            kids, i = site
            h, j = x, 0
            while j < i:
                child, k = kids[j], j + 1
                # the Identity/relu glue after this child
                while k < i and _is_relu_glue(kids[k]):
                    k += 1
                if isinstance(child, QuantizedConv2D) and child.act is None \
                        and child._out_threshold is not None and any(
                            isinstance(c, nn.Activation)
                            for c in kids[j + 1:k]):
                    h, j = child(h, relu=True), k
                else:
                    h, j = child(h), j + 1
            last, has_out = kids[i], self._out_threshold is not None
            # the dtype bookkeeping in the unfused forward's order: the
            # body's last conv seeds this block's carried dtype, which the
            # block then reads
            _chain_dtype(last, h)
            chain_dt = _chain_dtype(self, x)
            return last(
                h, residual=res,
                residual_mode="same" if self._ds_chained else "identity",
                residual_t=(None if self._ds_chained
                            else self._in_threshold.data()),
                block_out_t=self._out_threshold.data() if has_out else None,
                out_dtype=torch.int8 if has_out else chain_dt)
        a = self.body(x)
        has_out = self._out_threshold is not None
        chain_dt = _chain_dtype(self, x)
        has_in_t = self._in_threshold is not None
        ds_chained = self._ds_chained

        def f(av, rv, t_add, *rest):
            rest = list(rest)
            t_in = rest.pop(0) if has_in_t else None
            out_t = rest.pop(0) if has_out else None
            return _residual_add(av, rv, t_add, t_in, out_t, ds_chained,
                                 chain_dt)

        args = (a, res, self.qadd_threshold.data())
        if has_in_t:
            args = args + (self._in_threshold.data(),)
        if has_out:
            args = args + (self._out_threshold.data(),)
        return _apply("quantized_residual_add", f, *args)

    def __repr__(self):
        t = float(self.qadd_threshold.data().asnumpy())
        return f"QuantizedResidualBlock(t_add={t:.4g})"


def _is_relu_glue(block):
    """Identity or a relu Activation: glue that passes int8 codes
    through monotonically."""
    return isinstance(block, nn.Identity) or (
        isinstance(block, nn.Activation)
        and getattr(block, "_act_type", None) == "relu")


def _last_quantized(seq):
    """Last QuantizedConv2D/Dense of a Sequential, skipping trailing glue
    (Identity from BN folds, relu Activations — both pass int8 codes
    through monotonically)."""
    for child in reversed(list(seq._children.values())):
        if isinstance(child, (QuantizedConv2D, QuantizedDense)):
            return child
        if isinstance(child, nn.Identity):
            continue
        if isinstance(child, nn.Activation) and \
                getattr(child, "_act_type", None) == "relu":
            continue
        return None
    return None


_RESIDUAL_V1_NAMES = frozenset({"BottleneckV1", "BasicBlockV1"})


def chain_residual_blocks(net, calib_data=None, num_calib_batches=10,
                          logger=None):
    """Chain int8 through V1 residual blocks: calibrate each block's
    add-domain range (one eager pass over `calib_data` recording
    max|body out| and max|shortcut out|), wrap the blocks, and link
    consecutive blocks so each add emits int8 at the NEXT block's input
    scale. Returns the number of blocks chained."""
    # find candidate blocks: V1 residual blocks whose body convs were
    # quantized (the stages are HybridSequential in the model zoo)
    candidates = []     # (parent, name, block)

    def walk(block):
        for name, child in list(block._children.items()):
            if type(child).__name__ in _RESIDUAL_V1_NAMES:
                if _last_quantized(child.body) is not None:
                    candidates.append((block, name, child))
                continue
            if isinstance(child, HybridBlock):
                walk(child)

    walk(net)
    if not candidates or calib_data is None:
        return 0

    # one eager calibration pass on the already-quantized net: record the
    # add-domain minmax per block (|body out| and |shortcut|)
    ranges = {id(b): 0.0 for _, _, b in candidates}
    n_batches = 0

    def _make_recorder(b):
        def wrapped(x):
            a = b.body(x)
            r = b.downsample(x) if b.downsample is not None else x
            m = max(float(onp.abs(_host(a)).max()),
                    float(onp.abs(_host(r)).max()))
            ranges[id(b)] = max(ranges[id(b)], m)
            return npx.activation(a + r, act_type="relu")

        return wrapped

    for _, _, b in candidates:
        b.forward = _make_recorder(b)
    # suspend hybridization: the recorder's host copies would not run
    # inside a captured graph (same guard as collect_thresholds)
    hybrids = _hybrid_blocks(net)
    was_active = [(hb, hb._active) for hb in hybrids]
    try:
        for hb in hybrids:
            hb._active = False
        for batch in _iter_calib(calib_data, num_calib_batches):
            net(_as_input(batch))
            n_batches += 1
    finally:
        for _, _, b in candidates:
            b.__dict__.pop("forward", None)
        for hb, act in was_active:
            hb._active = act
    if n_batches == 0 or all(v == 0.0 for v in ranges.values()):
        # calib_data was a one-shot iterable already drained by
        # collect_thresholds: without add-domain ranges, chaining would
        # bake garbage scales — skip it (documented: pass a re-iterable)
        if logger:
            logger.warning("chain_residual_blocks: no calibration batches "
                           "(one-shot calib_data?); residual chaining "
                           "skipped")
        return 0

    # wrap the blocks
    for parent, name, b in candidates:
        t_add = max(ranges[id(b)], 1e-6)
        w = QuantizedResidualBlock(b, t_add)
        _replace_child(parent, name, b, w)
        if logger:
            logger.info("residual-chained %s (t_add=%.5g)", name, t_add)

    # link consecutive wrapped blocks WITHIN each stage: block[i] emits
    # int8 at block[i+1]'s input scale
    def link(block):
        kids = ([block._children[n] for n in block._children]
                if isinstance(block, nn.HybridSequential) else [])
        for i in range(len(kids) - 1):
            prod, cons = kids[i], kids[i + 1]
            if not (isinstance(prod, QuantizedResidualBlock)
                    and isinstance(cons, QuantizedResidualBlock)
                    and cons._in_threshold is not None):
                continue
            # EVERY consumer of the emitted int8 codes must decode them:
            # body[0] (the _in_threshold check) AND, when present, the
            # downsample's first layer — with AGREEING scales (shared
            # check: _res_in_threshold)
            t_in = _res_in_threshold(cons)
            if t_in is None:
                if logger:
                    logger.warning(
                        "residual chain skipped at %s: downsample cannot "
                        "decode at the body scale", type(cons).__name__)
                continue
            prod.__dict__["_out_threshold"] = t_in
            prod.__dict__["_chain_consumer"] = tuple(_res_decoders(cons))
        for c in block._children.values():
            if isinstance(c, HybridBlock):
                link(c)

    link(net)
    for blk in _hybrid_blocks(net):
        blk._cached_graph = None
    return len(candidates)


def _find_target_layers(block, prefix="", exclude=None):
    """(parent, child_name, layer) for every quantizable layer."""
    out = []
    for name, child in list(block._children.items()):
        path = f"{prefix}.{name}" if prefix else name
        if isinstance(child, (nn.Dense, nn.Conv2D)):
            if not (exclude and any(re.search(p, path) for p in exclude)):
                out.append((block, name, child))
        else:
            out.extend(_find_target_layers(child, path, exclude))
    return out


def _replace_child(parent, name, old, new):
    """Put ``new`` in ``old``'s place among ``parent``'s children: its
    submodule of that name (what attribute access reaches) and the
    container lists that hold it (Sequential._layers)."""
    parent._modules[name] = new
    for attr, val in list(parent.__dict__.items()):
        if val is old:
            parent.__dict__[attr] = new
        elif isinstance(val, list):
            for i, item in enumerate(val):
                if item is old:
                    val[i] = new


def _first_resblock(b):
    if isinstance(b, QuantizedResidualBlock):
        return b
    if isinstance(b, nn.HybridSequential) and b._children:
        return _first_resblock(b._children[next(iter(b._children))])
    return None


def _last_resblock(b):
    if isinstance(b, QuantizedResidualBlock):
        return b
    if isinstance(b, nn.HybridSequential) and b._children:
        return _last_resblock(b._children[list(b._children)[-1]])
    return None


def _res_decoders(cons):
    """Every layer that decodes a producer's int8 codes when chaining
    INTO a residual block: body[0] and, when present, the downsample's
    first layer. Single source of truth for 'who consumes the emit' —
    used by both chaining passes and the scale-agreement check."""
    decoders = [cons.body._children[list(cons.body._children)[0]]]
    if cons.downsample is not None:
        decoders.append(cons.downsample._children[
            list(cons.downsample._children)[0]])
    return decoders


def _res_in_threshold(cons):
    """The shared decode threshold a producer may emit at, or None when
    the block's body and downsample would decode at diverging scales
    (the same agreement check `chain_residual_blocks.link` applies)."""
    t = cons.__dict__.get("_in_threshold")
    if t is None:
        return None
    decoders = _res_decoders(cons)
    if len(decoders) > 1:
        ds_first = decoders[1]
        if not isinstance(ds_first, (QuantizedConv2D, QuantizedDense)):
            return None
        t_in = float(t.data().asnumpy())
        t_ds = float(ds_first.qthreshold.data().asnumpy())
        if abs(t_in - t_ds) > 1e-5 * max(t_in, t_ds, 1e-6):
            return None
    return t


def chain_boundaries(net, logger=None):
    """Extend int8 requantize chains across the edges the per-container
    passes can't see (reference analogue: the oneDNN subgraph pass
    rewrites the WHOLE graph so its int8 chains cross pooling and stage
    boundaries naturally, `src/operator/subgraph/dnnl/`):

    - producer -> [MaxPool2D / Identity / relu Activation]* -> consumer:
      max pooling on int8 CODES commutes with the monotone per-tensor
      quantization, so the stem conv can emit int8 straight through the
      pool (the stem activations are the largest tensors in the net —
      (64, 64, 112, 112) f32 is a 205 MB round trip per inference).
    - stage_i[-1] residual block -> stage_{i+1}[0] residual block, where
      the stages are ADJACENT nested sequentials.

    Producers: QuantizedConv2D/Dense (fused act relu/None only) or a
    QuantizedResidualBlock; consumers: a residual block whose body and
    downsample agree on the decode scale. Existing chains are never
    overwritten. Returns the number of new links."""
    n_linked = 0
    stack = [net]
    while stack:
        block = stack.pop()
        if isinstance(block, nn.HybridSequential):
            kids = [block._children[n] for n in block._children]
            for i, holder in enumerate(kids):
                if isinstance(holder, (QuantizedConv2D, QuantizedDense)):
                    prod = holder
                    if prod.act is not None and getattr(
                            prod.act, "_act_type", None) != "relu":
                        continue
                else:
                    prod = _last_resblock(holder)
                if prod is None \
                        or prod.__dict__.get("_out_threshold") is not None:
                    continue
                j = i + 1
                while j < len(kids) and (
                        isinstance(kids[j], (nn.Identity, nn.MaxPool2D))
                        or (isinstance(kids[j], nn.Activation)
                            and kids[j]._act_type == "relu")):
                    j += 1
                if j >= len(kids):
                    continue
                cons = _first_resblock(kids[j])
                if cons is None or cons is prod:
                    continue
                t_in = _res_in_threshold(cons)
                if t_in is None:
                    continue
                prod.__dict__["_out_threshold"] = t_in
                # BOTH decoders of the emitted codes need the chain dtype
                # seeded (see _chain_dtype / _res_decoders)
                prod.__dict__["_chain_consumer"] = tuple(_res_decoders(cons))
                n_linked += 1
                if logger:
                    logger.info("boundary-chained %s -> %s",
                                type(prod).__name__, type(cons).__name__)
        stack.extend(c for c in block._children.values()
                     if isinstance(c, HybridBlock))
    if n_linked:
        # a new link changes what the producer emits: graphs captured
        # before it would keep emitting f32 there
        for b in _hybrid_blocks(net):
            b._cached_graph = None
    return n_linked


def quantize_net(net, calib_data=None, calib_mode="entropy",
                 quantized_dtype="int8", exclude_layers_match=None,
                 num_calib_batches=10, fold_bn=True, requantize=True,
                 chain_residual=True, logger=None):
    """Post-training INT8 quantization of a gluon net, in place.

    - `calib_data`: iterable of batches (or (data, label) pairs) for
      activation calibration. Required for calib_mode 'naive'/'entropy';
      with calib_mode='none' a fixed threshold of 1.0 is used (testing).
    - `calib_mode`: 'naive' (minmax) or 'entropy' (KL-optimal clip), per
      the reference's quantize_model modes.
    - `exclude_layers_match`: list of regexes of layer paths to keep fp32.
    - `fold_bn`: fold adjacent Conv→BatchNorm pairs into the conv before
      calibrating, so no f32 BN pass interrupts the int8 chain.
    - `requantize`: chain consecutive quantized layers through int8 at the
      consumer's scale instead of round-tripping f32.
    Returns the mutated net (the layers are swapped in place, so
    hybridize and save/load keep working)."""
    if quantized_dtype != "int8":
        raise ValueError("only int8 is supported on the TPU build")
    if fold_bn:
        fold_conv_bn(net, logger=logger)
    layers = _find_target_layers(net, exclude=exclude_layers_match)
    if not layers:
        return net
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise ValueError(f"calib_mode={calib_mode!r} requires calib_data")
        thresholds = collect_thresholds(net, layers, calib_data, calib_mode,
                                        num_calib_batches)
    else:
        thresholds = {id(layer): 1.0 for _, _, layer in layers}
    for parent, name, layer in layers:
        t = thresholds[id(layer)]
        q = (QuantizedDense(layer, t) if isinstance(layer, nn.Dense)
             else QuantizedConv2D(layer, t))
        _replace_child(parent, name, layer, q)
        if logger:
            logger.info("quantized %s (threshold=%.5g)", name, t)
    if requantize:
        _chain_requantize(net, logger=logger)
    if chain_residual and requantize and calib_data is not None:
        # V1 residual blocks: int8 through the add (no f32 activations
        # between blocks)
        chain_residual_blocks(net, calib_data,
                              num_calib_batches=num_calib_batches,
                              logger=logger)
        # stem->stage and stage->stage boundaries: int8 codes flow THROUGH
        # max pools (max commutes with the monotone quantization) and
        # across nested-sequential edges — the biggest remaining f32 round
        # trips sit on the early 200 MB activations
        chain_boundaries(net, logger=logger)
    # graphs captured before the rewrite still run the fp32 layers
    for b in _hybrid_blocks(net):
        b._cached_graph = None
    return net


def quantize_model(net, **kwargs):
    """Reference-API alias (`contrib.quantization.quantize_model`)."""
    return quantize_net(net, **kwargs)
