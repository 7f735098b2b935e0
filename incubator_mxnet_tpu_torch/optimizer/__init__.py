"""Optimizers of the port (``mx.optimizer``)."""
from .optimizer import Adam, Optimizer

__all__ = ["Adam", "Optimizer"]
