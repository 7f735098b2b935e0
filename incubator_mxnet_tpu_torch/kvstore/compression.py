"""Gradient compression (port of `incubator_mxnet_tpu/kvstore/
compression.py`: `GradientCompression` :24, `create` :53).

"2bit": elements at or above +threshold become +threshold, at or below
-threshold -threshold, the rest 0, with the dropped mass carried in a
per-key residual into later steps (error feedback). "fp16": a round trip
through float16. The stores apply the round trip on the push leg.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray

__all__ = ["GradientCompression", "create"]


class GradientCompression:
    def __init__(self, type="2bit", threshold=0.5):  # noqa: A002
        if type not in ("2bit", "fp16"):
            raise ValueError(f"unsupported compression type {type!r}; "
                             "expected '2bit' or 'fp16'")
        if type == "2bit" and threshold <= 0:
            raise ValueError("2bit compression needs a positive threshold")
        self.type = type
        self.threshold = float(threshold)
        self._residual: dict = {}  # key -> tensor

    def compress(self, key, value):
        """value (NDArray) → quantized NDArray; updates the residual."""
        v = value._data if isinstance(value, NDArray) else torch.as_tensor(
            value)
        v = v.detach()
        if self.type == "fp16":
            return NDArray(v.to(torch.float16).to(v.dtype))
        t = self.threshold
        r = self._residual.get(key)
        acc = v if r is None else v + r
        q = torch.where(acc >= t, torch.full_like(acc, t),
                        torch.where(acc <= -t, torch.full_like(acc, -t),
                                    torch.zeros_like(acc))).to(v.dtype)
        self._residual[key] = acc - q
        return NDArray(q)

    def reset(self):
        self._residual.clear()


def create(params) -> GradientCompression:
    """From the reference's dict form: {'type': '2bit', 'threshold': 0.5}."""
    if isinstance(params, GradientCompression):
        return params
    if not isinstance(params, dict) or "type" not in params:
        raise ValueError("compression_params must be a dict with a 'type'")
    return GradientCompression(type=params["type"],
                               threshold=params.get("threshold", 0.5))
