"""``mx.gluon`` of the port: the layers the serving slice builds on.

Layers are `torch.nn.Module`s that keep MXNet's parameter names (``weight``,
``bias``, ``gamma``, ``beta``), so a model's ``named_parameters()`` match
the reference's ``collect_params()`` names one to one. Torch tensors and
autograd take the place of the reference's NDArray funnel and tape.
"""
from . import nn

__all__ = ["nn"]
