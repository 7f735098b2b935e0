"""Mixture-of-Experts gluon block (port of `incubator_mxnet_tpu/gluon/
contrib/moe.py`, `MoEFFN` :20): the experts live in stacked parameters,
tokens dispatch with capacity-factor top-1/top-2 gating
(`parallel.moe`), and the load-balancing loss is returned for the caller
to add to the objective (the Switch Transformer recipe)."""
from __future__ import annotations

from ...gluon.block import HybridBlock
from ...gluon.parameter import Parameter

__all__ = ["MoEFFN"]


class MoEFFN(HybridBlock):
    """Token-routed expert FFN layer.

    ``forward(x)``, x (N, T, D) or (T, D), returns ``(out, aux_loss)``:
    out has x's shape, aux_loss is the scalar Switch load-balance term
    (multiply it by a coefficient, typically 1e-2, and add it to the task
    loss; its gradient trains the gate toward balanced routing).

    ``units`` the token width D, ``hidden_size`` each expert's hidden
    width H, ``num_experts`` E, ``top_k`` 1 (Switch) or 2 (GShard),
    ``capacity_factor``: an expert's slots are cf · top_k · T / E."""

    def __init__(self, units, hidden_size, num_experts, top_k=2,
                 capacity_factor=1.25):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 or 2")
        self._units = units
        self._hidden = hidden_size
        self._experts = num_experts
        self._top_k = top_k
        self._cf = capacity_factor
        self.gate_weight = Parameter(shape=(num_experts, units),
                                     init="xavier")
        self.w1 = Parameter(shape=(num_experts, units, hidden_size),
                            init="xavier")
        self.b1 = Parameter(shape=(num_experts, hidden_size), init="zeros")
        self.w2 = Parameter(shape=(num_experts, hidden_size, units),
                            init="xavier")
        self.b2 = Parameter(shape=(num_experts, units), init="zeros")

    def forward(self, x):
        from ...numpy_extension import _op
        from ...parallel.moe import moe_dispatch_combine, moe_ffn_apply

        top_k, cf = self._top_k, self._cf

        def f(xv, gw, w1, b1, w2, b2):
            shape = xv.shape
            tokens = xv.reshape(-1, shape[-1])             # (T, D)
            logits = tokens @ gw.T                          # (T, E)
            out, aux = moe_dispatch_combine(
                tokens, logits, moe_ffn_apply(w1, b1, w2, b2),
                capacity_factor=cf, top_k=top_k)
            return out.reshape(shape), aux

        return _op("moe_ffn", f, x, self.gate_weight.data(), self.w1.data(),
                   self.b1.data(), self.w2.data(), self.b2.data())

    def __repr__(self):
        return (f"MoEFFN({self._units} -> {self._hidden}, "
                f"E={self._experts}, top{self._top_k})")
