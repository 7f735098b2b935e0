"""The int8 path's hand-written kernels and their plain versions (Q1, Q2).

Neither replaces a Pallas kernel. The reference contracts int8 codes with
XLA's ``dot_general`` and ``conv_general_dilated`` at
``preferred_element_type=int32`` (`incubator_mxnet_tpu/contrib/
quantization.py:334-336`, `:405-410`) and max-pools int8 codes with
``reduce_window`` (`numpy_extension/__init__.py:492-498`). PyTorch has
neither an int8 convolution with int32 sums nor an integer max pooling on
CUDA, so these are what the card needs to run the reference's int8 path.

- **Q1** (``csrc/int8_conv.cu``): the implicit-GEMM convolution on
  ``wgmma`` s8 tensor cores with the quantized layers' epilogue fused:
  :func:`conv_int8` (NCHW codes, OIHW weight, stride, padding, dilation,
  groups) and :func:`dense_int8` ((rows, K) x (O, K)^T, the same kernel at
  H = W = kh = kw = 1, split along K across the SMs). The epilogue is the
  reference's, in its order: ``s_x = thresh / 127``; ``y = float(acc) *
  (s_x * w_scale[o])``; ``+ bias[o]``; then int8 codes at the consumer's
  threshold ``out_t`` (``clip(round(y * (127 / out_t)), -127, 127)``), or
  y in the net's float type, or (``out_dtype=torch.int32``) the raw sums.
  With a ``residual`` (int8 codes of the output's shape) it goes on as the
  reference's ``QuantizedResidualBlock`` does after the add's code
  (:func:`plain_epilogue`): the add, relu, and the block's requantize or
  float type.
- **Q2** (``csrc/int8_pool.cu``): :func:`max_pool_int`, integer max
  pooling over 1-, 2- and 3-d windows of an NC... tensor, the padding the
  type's minimum; 2-d windows over int8/uint8 codes run channels-last.

The int8 chain runs channels-last: 4-d int8 codes between quantized
layers carry ``torch.channels_last`` strides (NHWC in memory, the logical
shape NCHW), and so do Q1's 4-d outputs and Q2's int8/uint8 ones, on the
kernel and the plain path alike. ``QuantizedConv2D`` keeps its weight
channels-last, (O, kh, kw, C/g) in memory: both of the product's operands
K-major, as int8 ``wgmma`` takes them. A wrapper takes such tensors as they
are and copies any other layout (or a tensor not 16-byte aligned) once
into it, counted in ``layout_conversions``.

The plain versions run the same arithmetic in torch ops: Q1's product as a
float64 convolution of the codes cast to int32 (exact: every sum is far
below 2^53) and its epilogue as separate ops, each division a true
division of two tensors (torch computes ``x / python_float`` on CUDA as a
multiplication by the reciprocal, which can differ in the last bit); Q2
as the window maximum of the input padded with the type's minimum
(``unfold`` and ``amax``). A wrapper runs the plain version for a CPU
tensor (or ``impl="plain"``); for a CUDA tensor it launches its kernel or
raises. The kernel and the plain version agree bit for bit.

Thresholds, scales and biases are tensors on the input's device, read by
the kernel when it runs: the chain shares its consumer's threshold
Parameter, which ``load_parameters`` updates in place, and a replayed CUDA
graph would keep a host value baked into its launch.

``conv_launches`` and ``pool_launches`` count launches; each launch
appends ``(kernel, bytes, operations)`` to `_build.LAUNCH_LOG` when a
profiler or a capture holds it.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build

__all__ = ["conv_int8", "dense_int8", "max_pool_int", "plain_conv_acc",
           "plain_epilogue", "plain_max_pool", "conv_cost", "pool_cost",
           "conv_launches", "pool_launches", "layout_conversions",
           "pool_out_shape", "CONV_KERNEL", "POOL_KERNEL",
           "POOL_NHWC_KERNEL", "RESIDUAL_MODES"]

#: the kernels' names as the CUDA sources spell them
CONV_KERNEL = "int8_conv_kernel"
POOL_KERNEL = "int8_max_pool_kernel"
POOL_NHWC_KERNEL = "int8_max_pool_nhwc_kernel"
#: the residual's cases: both branches at the add's threshold ("same",
#: a chained downsample) or the block's input at its own ("identity")
RESIDUAL_MODES = {"same": 1, "identity": 2}

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3, torch.int32: 4}
_BIAS_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_POOL_DTYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2,
                torch.int32: 3, torch.int64: 4}

conv_launches = 0
pool_launches = 0
layout_conversions = 0
_CONV_LIB = None
_POOL_LIB = None


def _conv_lib():
    global _CONV_LIB
    if _CONV_LIB is None:
        lib = _build.load("int8_conv")
        fn = lib.mx_int8_conv
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 16
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        ws = lib.mx_int8_conv_workspace
        ws.argtypes = [ctypes.c_int] * 16
        ws.restype = ctypes.c_longlong
        _CONV_LIB = lib
    return _CONV_LIB


def _pool_lib():
    global _POOL_LIB
    if _POOL_LIB is None:
        lib = _build.load("int8_pool")
        fn = lib.mx_int8_max_pool
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong] + [ctypes.c_void_p] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        nhwc = lib.mx_int8_max_pool_nhwc
        nhwc.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                         + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        nhwc.restype = ctypes.c_int
        _POOL_LIB = lib
    return _POOL_LIB


def _channels_last(t):
    """``t`` (4-d) channels-last and 16-byte aligned: itself when it is,
    else one copy, counted in ``layout_conversions``."""
    global layout_conversions
    if t.is_contiguous(memory_format=torch.channels_last) \
            and t.data_ptr() % 16 == 0:
        return t
    layout_conversions += 1
    return t.clone(memory_format=torch.channels_last)


def _as_channels_last(y):
    """A plain version's 4-d result in the layout its kernel writes."""
    return y.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# Q1
# ---------------------------------------------------------------------------

def _out_size(n, k, s, p, d):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def conv_cost(x_shape, w_shape, out_shape, out_dtype, residual=False):
    """``(bytes, operations)`` of one Q1 launch: the int8 input and weight
    read once, the output written once (the scales, biases and thresholds
    too: O floats each), an int8 residual of the output's shape read once,
    2 operations a multiply-add."""
    n_in = math.prod(x_shape)
    n_w = math.prod(w_shape)
    n_out = math.prod(out_shape)
    o = w_shape[0]
    per_out = math.prod(w_shape[1:])
    nbytes = n_in + n_w + n_out * _build.item_size(out_dtype) + 8 * o + 8
    if residual:
        nbytes += n_out + 8
    return nbytes, 2 * n_out * per_out


def _args_on(what, x, *tensors):
    for t in tensors:
        if t is not None and t.device != x.device:
            raise MXNetError(f"{what}: every operand must lie on "
                             f"{x.device}, got one on {t.device}")


def _check_residual(what, residual, mode, residual_t, block_out_t,
                    out_t, out_dtype, out_shape):
    if residual is None:
        return
    if residual.dtype != torch.int8 or tuple(residual.shape) != out_shape:
        raise MXNetError(f"{what}: the residual is int8 codes of the "
                         f"output's shape {out_shape}, got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    if mode not in RESIDUAL_MODES:
        raise MXNetError(f"{what}: residual_mode is one of "
                         f"{sorted(RESIDUAL_MODES)}, got {mode!r}")
    if out_t is None or out_dtype == torch.int32:
        raise MXNetError(f"{what}: a residual needs the add's threshold "
                         f"(out_t) and a float or int8 output")
    if mode == "identity" and residual_t is None:
        raise MXNetError(f"{what}: the identity residual needs its "
                         f"threshold (residual_t)")
    if out_dtype == torch.int8 and block_out_t is None:
        raise MXNetError(f"{what}: an int8 output after the residual add "
                         f"needs the block's output threshold (block_out_t)")
    _args_on(what, residual, residual_t, block_out_t)


def _check_conv(what, xq, wq, thresh, wscale, bias, out_t, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise MXNetError(f"{what}: int8 codes and weight, got {xq.dtype} and "
                         f"{wq.dtype}")
    if out_dtype not in _OUT_KINDS:
        raise MXNetError(f"{what}: output dtype {out_dtype} is not one of "
                         f"{sorted(map(str, _OUT_KINDS))}")
    if out_dtype == torch.int8 and out_t is None:
        raise MXNetError(f"{what}: int8 output needs the consumer's "
                         f"threshold (out_t)")
    if thresh.numel() != 1 or wscale.numel() != wq.shape[0]:
        raise MXNetError(f"{what}: one threshold and {wq.shape[0]} weight "
                         f"scales, got {thresh.numel()} and {wscale.numel()}")
    if bias is not None and (bias.dtype not in _BIAS_KINDS
                             or bias.numel() != wq.shape[0]):
        raise MXNetError(f"{what}: a float bias of {wq.shape[0]}, got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    _args_on(what, xq, wq, thresh, wscale, bias, out_t)


def plain_conv_acc(xq, wq, stride, pad, dilate, groups):
    """The int32 sums of the int8 convolution: a float64 convolution of
    the codes (exact), cast to int32."""
    acc = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), None, stride,
                   pad, dilate, groups)
    return acc.to(torch.int32)


def _true_div(a, b):
    """a / b as a true division of two tensors on b's device (never the
    reciprocal multiply torch uses for a Python-float divisor on CUDA)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def plain_epilogue(acc, thresh, wscale, bias, out_t, out_dtype, axis=1,
                   residual=None, residual_mode="same", residual_t=None,
                   block_out_t=None):
    """Q1's epilogue on the int32 sums ``acc`` (channels on ``axis``) in
    the reference's order, as separate torch ops. With a ``residual``
    (int8 codes of acc's shape), the code made at ``out_t`` (the add's
    threshold t_add) goes on as the reference's QuantizedResidualBlock
    (`incubator_mxnet_tpu/contrib/quantization.py:618-647`): "same"
    (both branches at t_add) ``float(a + r) * (t_add / 127)``, "identity"
    ``a * (t_add / 127) + r * (residual_t / 127)``; relu; then int8 at
    ``block_out_t`` or ``out_dtype``."""
    if out_dtype == torch.int32:
        return acc
    shape = [1] * acc.dim()
    shape[axis] = -1
    s_x = _true_div(thresh.float().reshape(()), 127.0)
    y = acc.float() * (s_x * wscale.float()).reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    if residual is None and out_dtype != torch.int8:
        return y.to(out_dtype)
    q_mul = _true_div(127.0, out_t.float().reshape(()))
    a = torch.clamp(torch.round(y * q_mul), -127, 127).to(torch.int8)
    if residual is None:
        return a
    s_add = _true_div(out_t.float().reshape(()), 127.0)
    if residual_mode == "same":
        y = (a.to(torch.int32) + residual.to(torch.int32)).float() * s_add
    else:
        s_in = _true_div(residual_t.float().reshape(()), 127.0)
        y = a.float() * s_add + residual.float() * s_in
    y = torch.relu(y)
    if out_dtype == torch.int8:
        q_out = _true_div(127.0, block_out_t.float().reshape(()))
        return torch.clamp(torch.round(y * q_out), -127, 127).to(torch.int8)
    return y.to(out_dtype)


def _conv_kernel(xq, wq, thresh, wscale, bias, out_t, out_dtype, stride, pad,
                 dilate, groups, out_shape, residual=None, residual_mode=None,
                 residual_t=None, block_out_t=None, relu=False):
    """One Q1 launch on codes ``xq`` and weight ``wq``, both already in
    the kernel's memory layout (NHWC and (O, kh, kw, C/g); a (rows, K)
    matrix is both at H = W = kh = kw = 1), into a new NHWC ``y``."""
    global conv_launches
    thresh = thresh.float().contiguous()
    wscale = wscale.float().contiguous()
    out_t = None if out_t is None else out_t.float().contiguous()
    bias = None if bias is None else bias.contiguous()
    residual_t = None if residual_t is None else residual_t.float().contiguous()
    block_out_t = None if block_out_t is None \
        else block_out_t.float().contiguous()
    four = len(out_shape) == 4
    y = torch.empty(out_shape, dtype=out_dtype, device=xq.device,
                    memory_format=torch.channels_last if four
                    else torch.contiguous_format)
    n, c, h, w = xq.shape if xq.dim() == 4 else (*xq.shape, 1, 1)
    o = wq.shape[0]
    kh, kw = wq.shape[2:] if wq.dim() == 4 else (1, 1)
    ho, wo = out_shape[2:] if four else (1, 1)
    shape = (n, c, h, w, o, kh, kw, stride[0], stride[1], pad[0], pad[1],
             dilate[0], dilate[1], groups, ho, wo)
    lib = _conv_lib()
    stream = _build.stream_of(xq.device)
    with _build.on_device(xq.device):
        words = lib.mx_int8_conv_workspace(*shape)
        if words < 0:
            raise MXNetError(f"int8_conv: the kernel refuses the shape "
                             f"{tuple(xq.shape)} x {tuple(wq.shape)}")
        # the split-K sums and tile counters, zeroed on the stream
        ws = torch.zeros(words, dtype=torch.int32, device=xq.device) \
            if words else None
        err = lib.mx_int8_conv(
            xq.data_ptr(), wq.data_ptr(), *shape, thresh.data_ptr(),
            wscale.data_ptr(), None if bias is None else bias.data_ptr(),
            -1 if bias is None else _BIAS_KINDS[bias.dtype],
            None if out_t is None else out_t.data_ptr(),
            None if residual is None else residual.data_ptr(),
            0 if residual is None else RESIDUAL_MODES[residual_mode],
            None if residual_t is None else residual_t.data_ptr(),
            None if block_out_t is None else block_out_t.data_ptr(),
            int(relu), y.data_ptr(), _OUT_KINDS[out_dtype],
            None if ws is None else ws.data_ptr(), stream)
    _build.check(lib, err, "int8_conv")
    conv_launches += 1
    if _build.LAUNCH_LOG is not None:
        _build.LAUNCH_LOG.append((CONV_KERNEL, *conv_cost(
            tuple(xq.shape), tuple(wq.shape), out_shape, out_dtype,
            residual is not None)))
    return y


def conv_int8(xq, wq, thresh, wscale, bias=None, out_t=None,
              out_dtype=torch.float32, stride=(1, 1), pad=(0, 0),
              dilate=(1, 1), groups=1, impl="auto", residual=None,
              residual_mode="same", residual_t=None, block_out_t=None,
              relu=False):
    """The quantized 2-d convolution of int8 codes ``xq`` (N, C, H, W)
    with the int8 weight ``wq`` (O, C/groups, kh, kw): the int32 sums and
    Q1's epilogue (see the module docstring) into (N, O, Ho, Wo) of
    ``out_dtype``, channels-last. ``thresh`` (one value) is the layer's
    input threshold, ``wscale`` (O,) the weight's scales, ``bias`` (O,) or
    None, ``out_t`` the consumer's threshold for an int8 output. A
    ``residual`` (int8 codes of the output's shape) is added after the
    code at ``out_t`` as :func:`plain_epilogue` says (``residual_mode``
    "same" or "identity" with its threshold ``residual_t``; relu; int8 at
    ``block_out_t`` or ``out_dtype``). ``relu``: relu on the int8 output
    codes (``torch.relu`` of them: the chain's relu glue after the code),
    no residual. ``impl`` as the other wrappers': "auto" launches the
    kernel for a CUDA tensor and runs the plain version for a CPU one."""
    _check_conv("int8_conv", xq, wq, thresh, wscale, bias, out_t, out_dtype)
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[1] * groups \
            or wq.shape[0] % groups:
        raise MXNetError(f"int8_conv: NCHW codes and an (O, C/g, kh, kw) "
                         f"weight over {groups} groups, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    stride, pad, dilate = tuple(stride), tuple(pad), tuple(dilate)
    ho = _out_size(xq.shape[2], wq.shape[2], stride[0], pad[0], dilate[0])
    wo = _out_size(xq.shape[3], wq.shape[3], stride[1], pad[1], dilate[1])
    if ho <= 0 or wo <= 0:
        raise MXNetError(f"int8_conv: the window does not fit "
                         f"{tuple(xq.shape)}")
    out_shape = (xq.shape[0], wq.shape[0], ho, wo)
    _check_residual("int8_conv", residual, residual_mode, residual_t,
                    block_out_t, out_t, out_dtype, out_shape)
    if relu and (out_dtype != torch.int8 or residual is not None):
        raise MXNetError("int8_conv: relu is on the int8 codes of an "
                         "output without a residual")
    if _build.use_plain("int8_conv", xq, impl):
        acc = plain_conv_acc(xq, wq, stride, pad, dilate, groups)
        y = plain_epilogue(
            acc, thresh, wscale, bias, out_t, out_dtype, residual=residual,
            residual_mode=residual_mode, residual_t=residual_t,
            block_out_t=block_out_t)
        return _as_channels_last(torch.relu(y) if relu else y)
    if xq.numel() == 0:
        return torch.empty(out_shape, dtype=out_dtype, device=xq.device,
                           memory_format=torch.channels_last)
    return _conv_kernel(
        _channels_last(xq), _channels_last(wq), thresh, wscale, bias, out_t,
        out_dtype, stride, pad, dilate, groups, out_shape,
        None if residual is None else _channels_last(residual),
        residual_mode, residual_t, block_out_t, relu)


def dense_int8(xq, wq, thresh, wscale, bias=None, out_t=None,
               out_dtype=torch.float32, impl="auto"):
    """The quantized Dense: int8 codes ``xq`` (..., K) times the int8
    weight ``wq`` (O, K) transposed, int32 sums, Q1's epilogue, into
    (..., O) of ``out_dtype``; Q1 at H = W = kh = kw = 1."""
    _check_conv("int8_dense", xq, wq, thresh, wscale, bias, out_t, out_dtype)
    if wq.dim() != 2 or xq.shape[-1] != wq.shape[1]:
        raise MXNetError(f"int8_dense: (..., K) codes and an (O, K) weight, "
                         f"got {tuple(xq.shape)} and {tuple(wq.shape)}")
    lead = tuple(xq.shape[:-1])
    rows = xq.reshape(-1, xq.shape[-1])
    if _build.use_plain("int8_dense", xq, impl):
        acc = (rows.to(torch.float64) @ wq.to(torch.float64).t()).to(
            torch.int32)
        y = plain_epilogue(acc, thresh, wscale, bias, out_t, out_dtype)
    elif rows.numel() == 0:
        y = torch.empty((rows.shape[0], wq.shape[0]), dtype=out_dtype,
                        device=xq.device)
    else:
        # (rows, K) and (O, K) row-major are the kernel's NHWC and
        # (O, kh, kw, C) at H = W = kh = kw = 1
        y = _conv_kernel(_build.aligned(rows), _build.aligned(wq), thresh,
                         wscale, bias, out_t, out_dtype, (1, 1), (0, 0),
                         (1, 1), 1, (rows.shape[0], wq.shape[0]))
    return y.reshape(*lead, wq.shape[0])


# ---------------------------------------------------------------------------
# Q2
# ---------------------------------------------------------------------------

def pool_out_shape(size, kernel, stride, pad, extra=None):
    """Each spatial axis's output size: ``(n + 2p + e - k) // s + 1`` with
    ``extra`` the high padding's extension ("full")."""
    extra = extra or (0,) * len(size)
    return tuple((n + 2 * p + e - k) // s + 1
                 for n, k, s, p, e in zip(size, kernel, stride, pad, extra))


def pool_cost(x, out_shape, kernel):
    """``(bytes, operations)`` of one Q2 launch: the input read once, the
    output written once; one comparison a window position an output."""
    n_out = math.prod(out_shape)
    return (x.numel() + n_out) * x.element_size(), n_out * math.prod(kernel)


def plain_max_pool(x, kernel, stride, pad, extra=None):
    """The window maxima of ``x`` (NC...) padded with its type's minimum
    (``pad`` low and high, plus ``extra`` on the high side)."""
    nd = len(kernel)
    extra = extra or (0,) * nd
    low = torch.iinfo(x.dtype).min
    pads = []
    for p, e in zip(reversed(pad), reversed(extra)):
        pads += [p, p + e]
    y = F.pad(x, pads, value=low) if any(pads) else x
    for i, (k, s) in enumerate(zip(kernel, stride)):
        y = y.unfold(2 + i, k, s)
    return y.amax(dim=tuple(range(-nd, 0)))


def _pool_kernel(x, kernel, stride, pad, out_shape):
    global pool_launches
    if x.dtype not in _POOL_DTYPES:
        raise MXNetError(f"int8_max_pool: an integer type of "
                         f"{sorted(map(str, _POOL_DTYPES))}, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    nd = len(kernel)
    lead = 3 - nd

    def three(v, fill):
        return (ctypes.c_int * 3)(*((fill,) * lead + tuple(v)))

    lib = _pool_lib()
    stream = _build.stream_of(x.device)
    with _build.on_device(x.device):
        err = lib.mx_int8_max_pool(
            _POOL_DTYPES[x.dtype], x.data_ptr(), y.data_ptr(),
            x.shape[0] * x.shape[1], three(x.shape[2:], 1),
            three(out_shape[2:], 1), three(kernel, 1), three(stride, 1),
            three(pad, 0), stream)
    _build.check(lib, err, "int8_max_pool")
    pool_launches += 1
    if _build.LAUNCH_LOG is not None:
        _build.LAUNCH_LOG.append((POOL_KERNEL,
                                    *pool_cost(x, out_shape, kernel)))
    return y


def _pool_nhwc_kernel(x, kernel, stride, pad, out_shape):
    """Q2's channels-last kernel: a 2-d window over int8/uint8 codes."""
    global pool_launches
    x = _channels_last(x)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    n, c, h, w = x.shape
    lib = _pool_lib()
    stream = _build.stream_of(x.device)
    with _build.on_device(x.device):
        err = lib.mx_int8_max_pool_nhwc(
            _POOL_DTYPES[x.dtype], x.data_ptr(), y.data_ptr(), n, h, w, c,
            out_shape[2], out_shape[3], kernel[0], kernel[1], stride[0],
            stride[1], pad[0], pad[1], stream)
    _build.check(lib, err, "int8_max_pool")
    pool_launches += 1
    if _build.LAUNCH_LOG is not None:
        _build.LAUNCH_LOG.append((POOL_NHWC_KERNEL,
                                  *pool_cost(x, out_shape, kernel)))
    return y


def max_pool_int(x, kernel, stride, pad, extra=None, impl="auto"):
    """Max pooling of the integer tensor ``x`` (N, C, *spatial; 1-, 2- or
    3-d) over ``kernel`` windows at ``stride``, ``pad`` on both sides and
    ``extra`` more on the high side ("full"), the padding the type's
    minimum: Q2 for a CUDA tensor, :func:`plain_max_pool` for a CPU one.
    A 2-d window over int8 or uint8 codes runs channels-last (Q2's
    channels-last kernel; the output channels-last); every other case on
    NC... contiguous tensors."""
    nd = len(kernel)
    if x.is_floating_point() or x.dim() != nd + 2 or not 1 <= nd <= 3:
        raise MXNetError(f"int8_max_pool: an integer NC... tensor with "
                         f"{nd} spatial axes (1 to 3), got {x.dtype} "
                         f"{tuple(x.shape)}")
    extra = tuple(extra) if extra is not None else (0,) * nd
    out_shape = tuple(x.shape[:2]) + pool_out_shape(
        x.shape[2:], kernel, stride, pad, extra)
    if min(out_shape[2:]) <= 0:
        raise MXNetError(f"int8_max_pool: the window does not fit "
                         f"{tuple(x.shape)}")
    nhwc = nd == 2 and x.dtype in (torch.int8, torch.uint8)
    if _build.use_plain("int8_max_pool", x, impl):
        y = plain_max_pool(x, kernel, stride, pad, extra)
        return _as_channels_last(y) if nhwc else y
    if x.numel() == 0:
        return torch.empty(out_shape, dtype=x.dtype, device=x.device,
                           memory_format=torch.channels_last if nhwc
                           else torch.contiguous_format)
    if nhwc:
        return _pool_nhwc_kernel(x, tuple(kernel), tuple(stride), tuple(pad),
                                 out_shape)
    return _pool_kernel(x, tuple(kernel), tuple(stride), tuple(pad),
                        out_shape)
