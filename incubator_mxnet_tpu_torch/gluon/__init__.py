"""``mx.gluon`` of the port: the layers, losses and trainer the serving
and training slices build on.

Layers are `torch.nn.Module`s that keep MXNet's parameter names (``weight``,
``bias``, ``gamma``, ``beta``), so a model's ``named_parameters()`` match
the reference's ``collect_params()`` names one to one. Torch tensors and
autograd take the place of the reference's NDArray funnel and tape.
"""
from . import loss, nn
from .trainer import Trainer

__all__ = ["loss", "nn", "Trainer"]
