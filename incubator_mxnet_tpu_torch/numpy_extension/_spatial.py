"""Deformable convolution, v1 and v2 (port of
`incubator_mxnet_tpu/numpy_extension/_spatial.py`:
`deformable_convolution` :226, `modulated_deformable_convolution` :340).

As in the reference, plain ops: a bilinear im2col at the offset
positions (corners outside the image contribute 0) and one
(F, C·kh·kw) x (C·kh·kw, OH·OW) product an image. The reference has no
kernel for it."""
from __future__ import annotations

import torch

__all__ = ["deformable_convolution", "modulated_deformable_convolution"]


def _bilinear_zero(img, gy, gx):
    """``img`` (N, C, H, W) sampled at the float pixel coordinates
    ``gy``/``gx`` (N, ...): (N, C, ...); corners outside [0, H-1] x
    [0, W-1] contribute 0 (the reference's "zero" padding)."""
    n, c, h, w = img.shape
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy, wx = gy - y0, gx - x0
    flat = img.reshape(n, c, h * w)

    def at(yi, xi):
        ci = yi.clamp(0, h - 1).long()
        cj = xi.clamp(0, w - 1).long()
        idx = (ci * w + cj).reshape(n, 1, -1).expand(n, c, -1)
        v = flat.gather(2, idx).reshape((n, c) + tuple(yi.shape[1:]))
        inside = ((yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1))
        return v * inside.to(img.dtype).unsqueeze(1)

    wy, wx = wy.unsqueeze(1), wx.unsqueeze(1)
    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x0 + 1) * (1 - wy) * wx
            + at(y0 + 1, x0) * wy * (1 - wx) + at(y0 + 1, x0 + 1) * wy * wx)


def _deform(x, off, wgt, b, mk, kernel, stride, pad, dilate, num_filter,
            g):
    n, c, h, w = x.shape
    f, kh, kw = wgt.shape[0], wgt.shape[2], wgt.shape[3]
    if tuple(kernel) != (kh, kw):
        raise ValueError(f"deformable_convolution: kernel={tuple(kernel)} "
                         f"disagrees with weight shape {tuple(wgt.shape)}")
    if num_filter is not None and int(num_filter) != f:
        raise ValueError(f"deformable_convolution: num_filter={num_filter} "
                         f"disagrees with weight shape {tuple(wgt.shape)}")
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    taps, cg = kh * kw, c // g
    dev, dt = x.device, x.dtype
    base_y = (torch.arange(oh, device=dev) * sh - ph).to(dt)[:, None, None]
    base_x = (torch.arange(ow, device=dev) * sw - pw).to(dt)[None, :, None]
    tap_y = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw).to(dt)
    tap_x = (torch.arange(kw, device=dev) * dw).repeat(kh).to(dt)
    # offsets (N, G*K*2, OH, OW): (dy, dx) a tap a group -> (N, G, OH, OW, K)
    o = off.reshape(n, g, taps, 2, oh, ow)
    sy = base_y + tap_y + o[:, :, :, 0].permute(0, 1, 3, 4, 2)
    sx = base_x + tap_x + o[:, :, :, 1].permute(0, 1, 3, 4, 2)
    if mk is not None:
        mods = mk.reshape(n, g, taps, oh, ow).permute(0, 1, 3, 4, 2)
    cols = []
    for gi in range(g):
        s = _bilinear_zero(x[:, gi * cg:(gi + 1) * cg], sy[:, gi], sx[:, gi])
        if mk is not None:
            s = s * mods[:, gi].unsqueeze(1)
        cols.append(s)
    col = torch.cat(cols, 1)                          # (N, C, OH, OW, K)
    col = col.permute(0, 1, 4, 2, 3).reshape(n, c * taps, oh * ow)
    y = torch.matmul(wgt.reshape(f, c * taps), col).reshape(n, f, oh, ow)
    if b is not None:
        y = y + b.reshape(1, f, 1, 1)
    return y


def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_filter=None, num_deformable_group=1,
                           no_bias=False, mask=None):
    """Deformable convolution (v1; v2 with ``mask``): data (N, C, H, W),
    offset (N, 2·G·kh·kw, OH, OW) with (dy, dx) a tap a deformable group,
    weight (F, C, kh, kw), mask (N, G·kh·kw, OH, OW) modulating each
    sampled tap."""
    from . import _op

    b = None if no_bias else bias
    g = int(num_deformable_group)

    def fn(x, off, wgt, bv, mk):
        return _deform(x, off, wgt, bv, mk, kernel, tuple(stride),
                       tuple(pad), tuple(dilate), num_filter, g)

    return _op("deformable_convolution", fn, data, offset, weight, b, mask)


def modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                     kernel=(3, 3), stride=(1, 1),
                                     pad=(0, 0), dilate=(1, 1),
                                     num_filter=None, num_deformable_group=1,
                                     no_bias=False, **kwargs):  # noqa: ARG001
    """Deformable convolution v2: :func:`deformable_convolution` with the
    per-tap modulation ``mask``."""
    return deformable_convolution(
        data, offset, weight, bias=bias, kernel=kernel, stride=stride,
        pad=pad, dilate=dilate, num_filter=num_filter,
        num_deformable_group=num_deformable_group, no_bias=no_bias,
        mask=mask)
