"""``npx`` ops of the reference's contrib corpus that the vision path
calls (port of `incubator_mxnet_tpu/numpy_extension/_contrib_misc.py`:
`adaptive_avg_pooling2d` :305, `batch_norm_with_relu` :360, `softsign`
:384, `pad` :389).
Plain torch: the reference composes them in jnp, with no kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["adaptive_avg_pooling2d", "batch_norm_with_relu", "softsign",
           "pad"]


def adaptive_avg_pooling2d(data, output_size=1):
    """NCHW adaptive average pooling: bin i covers
    [floor(i·H/out), ceil((i+1)·H/out)), the reference's binning (and
    ``F.adaptive_avg_pool2d``'s)."""
    from . import _op

    if isinstance(output_size, int):
        oh = ow = int(output_size)
    else:
        oh, ow = (int(v) for v in output_size)
    return _op("adaptive_avg_pooling2d",
               lambda x: F.adaptive_avg_pool2d(x, (oh, ow)), data)


def batch_norm_with_relu(x, gamma, beta, running_mean, running_var,
                         **kwargs):
    """``relu(batch_norm(...))``, the running statistics updated as
    `npx.batch_norm` updates them."""
    from . import batch_norm, relu

    return relu(batch_norm(x, gamma, beta, running_mean, running_var,
                           **kwargs))


def softsign(data):
    """``x / (1 + |x|)``."""
    from . import _op

    return _op("softsign", lambda x: x / (1 + x.abs()), data)


def _pad_index(n, lo, hi, mode, device):
    """Source indices of an axis of length ``n`` padded by (lo, hi):
    "edge" repeats the border, "reflect" mirrors about it (numpy's
    modes)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def pad(data, mode="constant", pad_width=None, constant_value=0.0):
    """Pad by ``pad_width``, a flat 2·ndim tuple (before, after a axis),
    in mode "constant" (``constant_value``), "edge" or "reflect"."""
    from . import _op

    pw = tuple(int(v) for v in pad_width)
    pairs = tuple((pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2))
    if mode not in ("constant", "edge", "reflect"):
        raise ValueError(f"pad: unknown mode {mode!r}")

    def fn(x):
        if mode == "constant":
            flat = [q for lo_hi in reversed(pairs) for q in lo_hi]
            return F.pad(x, flat, value=constant_value)
        for ax, (lo, hi) in enumerate(pairs):
            if lo or hi:
                x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                                  x.device))
        return x

    return _op("pad", fn, data)
