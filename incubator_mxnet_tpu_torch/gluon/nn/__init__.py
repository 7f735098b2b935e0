"""Neural-network layers (``mx.gluon.nn``) of the port."""
from .basic_layers import (Dense, Dropout, Embedding, HybridSequential,
                           LayerNorm)

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential", "LayerNorm"]
