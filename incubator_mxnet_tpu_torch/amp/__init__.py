"""AMP: automatic mixed precision, bfloat16 target (port of
`incubator_mxnet_tpu/amp/__init__.py`; reference: `python/mxnet/amp/amp.py`,
the lists of `amp/lists/symbol_bf16.py`).

Under :func:`init` the inputs of the matmul-class ops in
:data:`TARGET_DTYPE_OPS` are cast from float32 to bfloat16, so the products
run on the tensor cores in bf16, and the ops of :data:`FP32_OPS` take
float32; every other op computes in the dtypes it is given, with PyTorch's
promotion, which is JAX's for two tensors (a bf16 product added to an f32
tensor is f32). So BERT's residual stream stays float32 and only its
products are bf16: the fused residual + dropout + LayerNorm kernels take
an f32 x with a bf16 h, and the MLM head's LayerNorm a bf16 x, both with
f32 gamma/beta (`ops/layer_norm.py` ``LAYOUTS``, ``RESIDUAL_LAYOUTS``).
Parameters stay float32: the casts are differentiable, so gradients come
back float32.

The reference applies the lists inside its op funnel (`apply_op`); the
port has no funnel yet, so the casts sit where the ported layers call the
listed ops, through :func:`cast_inputs`: ``gluon.nn.Dense``
("fully_connected"), ``gluon.nn.Embedding`` ("embedding") and
``npx.flash_attention``. A list entry whose op is not ported yet has no
call site. ``torch.autocast`` is not used: its lists are not the
reference's (it runs layer_norm in f32) and it does not reach the port's
kernels.

The float16 target needs float16 kernels and master weights
(``multi_precision``), which are not ported: :func:`init` raises for it.
Loss scaling (:class:`scale_loss`, :class:`LossScaler`) is the
reference's, optional for bf16.
"""
from __future__ import annotations

import threading

import torch
from torch import nn

from ..base import MXNetError
from .loss_scaler import LossScaler

__all__ = ["init", "deinit", "scale_loss", "unscale", "convert_model",
           "convert_hybrid_block", "LossScaler", "amp_active", "amp_dtype",
           "lists", "op_cast_mode", "cast_vals", "cast_inputs",
           "cast_for_matmul", "TARGET_DTYPE_OPS", "FP32_OPS"]


class _State(threading.local):
    def __init__(self):
        self.active = False
        self.dtype = None


_STATE = _State()

# Op-name lists mirroring the reference's amp/lists/symbol_bf16.py roles.
TARGET_DTYPE_OPS = ["fully_connected", "convolution", "deconvolution",
                    "batch_dot", "matmul", "dot", "rnn", "embedding",
                    "einsum", "tensordot", "inner", "vdot",
                    "linalg_gemm2", "linalg_trmm", "linalg_syrk",
                    "flash_attention", "interleaved_matmul_selfatt_qk",
                    "interleaved_matmul_selfatt_valatt"]
# layer_norm is NOT in FP32_OPS: the op itself computes statistics in f32
# and writes back in the input dtype, so an up-cast would only add memory
# traffic under bf16 AMP.
FP32_OPS = ["softmax", "log_softmax", "masked_softmax", "softmin",
            "batch_norm", "group_norm", "instance_norm",
            "l2_normalization", "norm", "mean", "sum", "prod", "cumsum",
            "exp", "expm1", "log", "log1p", "log2", "log10", "erf",
            "erfinv", "gammaln", "power", "sqrt", "rsqrt", "cbrt",
            "square", "var", "std", "ctc_loss", "smooth_l1",
            "softmax_cross_entropy",
            "linalg.norm", "linalg.svd", "linalg.cholesky", "linalg.qr",
            "linalg.inv", "linalg.det", "linalg.slogdet", "linalg.solve",
            "linalg_potrf", "linalg_potri", "linalg_sumlogdiag"]

_TARGET_SET = frozenset(TARGET_DTYPE_OPS)
_FP32_SET = frozenset(FP32_OPS)
_LOW = (torch.bfloat16, torch.float16)


class lists:
    TARGET_DTYPE_OPS = TARGET_DTYPE_OPS
    FP32_OPS = FP32_OPS


def _check_target(target_dtype):
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError("target_dtype must be bfloat16 or float16")
    if target_dtype == "float16":
        raise MXNetError("float16 kernels are not ported (ROADMAP §2a "
                         "item 2)")


def op_cast_mode(name):
    """None (no casting), ("target", dtype name) or ("fp32",) for the op
    ``name`` under the current AMP state."""
    if not _STATE.active:
        return None
    if name in _TARGET_SET:
        return ("target", _STATE.dtype)
    if name in _FP32_SET:
        return ("fp32",)
    return None


def cast_vals(mode, vals):
    """Apply an :func:`op_cast_mode` result to a sequence of values:
    float32 tensors to the target dtype, or low-precision ones to float32;
    anything else (None, integer tensors) as it is."""
    if mode[0] == "target":
        dt = torch.bfloat16 if mode[1] == "bfloat16" else torch.float16
        return [v.to(dt) if isinstance(v, torch.Tensor)
                and v.dtype == torch.float32 else v for v in vals]
    return [v.float() if isinstance(v, torch.Tensor) and v.dtype in _LOW
            else v for v in vals]


def cast_inputs(name, *vals):
    """The inputs of the op ``name`` as AMP has it take them (the
    reference's funnel cast): ``vals`` themselves when AMP is off or the
    op is in no list."""
    mode = op_cast_mode(name)
    return vals if mode is None else tuple(cast_vals(mode, vals))


def init(target_dtype="bfloat16"):
    """Enable mixed precision in this thread (reference: amp.init). Only
    "bfloat16" is ported; "float16" raises :class:`MXNetError`."""
    _check_target(target_dtype)
    _STATE.active = True
    _STATE.dtype = target_dtype


def deinit():
    _STATE.active = False
    _STATE.dtype = None


def amp_active() -> bool:
    return _STATE.active


def amp_dtype():
    return torch.bfloat16 if _STATE.dtype == "bfloat16" else torch.float16


def cast_for_matmul(*vals):
    """Cast float32 operands of a matmul-class op to the AMP dtype."""
    if not _STATE.active:
        return vals
    dt = amp_dtype()
    return tuple(v.to(dt) if isinstance(v, torch.Tensor)
                 and v.dtype == torch.float32 else v for v in vals)


class scale_loss:
    """Context manager scaling the loss up and the gradients down
    (reference: amp.scale_loss): yields ``loss * loss_scale``; on exit
    folds 1/loss_scale into ``trainer``'s next step (its ``_scale``, which
    :meth:`Trainer.step` multiplies into ``rescale_grad``)."""

    _scaler = None

    def __init__(self, loss, trainer=None):
        if scale_loss._scaler is None:
            scale_loss._scaler = LossScaler()
        self._trainer = trainer
        self.loss = loss * scale_loss._scaler.loss_scale

    def __enter__(self):
        return self.loss

    def __exit__(self, *exc):
        if self._trainer is not None:
            self._trainer._scale = 1.0 / scale_loss._scaler.loss_scale
        return False


def unscale(trainer):
    trainer._scale = 1.0


def convert_model(net, target_dtype="bfloat16"):
    """Cast every parameter of ``net`` for low-precision inference
    (reference: amp.convert_model, which calls ``net.cast``)."""
    _check_target(target_dtype)
    return net.to(getattr(torch, target_dtype))


class _AMPWrapped(nn.Module):
    """AMP is active for the wrapped forward: LayerNorm keeps f32
    parameters, so its f32 outputs would promote later bf16-weight
    products back to f32; the listed ops' casts re-lower those
    activations. Float32 inputs enter in the target dtype; outputs leave
    in float32."""

    def __init__(self, inner, target_dtype):
        super().__init__()
        self.net = inner
        self._target = target_dtype

    def forward(self, *args):
        dt = getattr(torch, self._target)
        cast_args = [a.to(dt) if isinstance(a, torch.Tensor)
                     and a.dtype == torch.float32 else a for a in args]
        was_active, was_dtype = _STATE.active, _STATE.dtype
        _STATE.active, _STATE.dtype = True, self._target
        try:
            out = self.net(*cast_args)
        finally:
            _STATE.active, _STATE.dtype = was_active, was_dtype
        if isinstance(out, (list, tuple)):
            return type(out)(o.float() for o in out)
        return out.float()


def convert_hybrid_block(net, target_dtype="bfloat16",
                         cast_params_offline=True):
    """Selective low-precision rewrite of a net (reference:
    `amp.convert_hybrid_block`): the parameters of its matmul-class layers
    (Dense, Embedding) are cast to the target dtype, LayerNorm keeps
    float32 parameters, and the returned module runs ``net`` under AMP
    with float32 inputs cast on entry and outputs restored to float32."""
    _check_target(target_dtype)
    from ..gluon import nn as gnn

    dt = getattr(torch, target_dtype)

    def walk(block):
        if isinstance(block, gnn.LayerNorm):
            return
        if isinstance(block, (gnn.Dense, gnn.Embedding)):
            block.to(dt)
            return
        for child in block.children():
            walk(child)

    if cast_params_offline:
        walk(net)
    return _AMPWrapped(net, target_dtype)
