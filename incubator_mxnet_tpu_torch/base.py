"""Framework-level error type (parity with `mxnet.base.MXNetError`)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Framework-level error (parity with mxnet.base.MXNetError)."""
