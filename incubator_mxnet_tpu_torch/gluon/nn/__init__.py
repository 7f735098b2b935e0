"""Neural-network layers (``mx.gluon.nn``) of the port."""
from .basic_layers import Dense, Embedding, HybridSequential, LayerNorm

__all__ = ["Dense", "Embedding", "HybridSequential", "LayerNorm"]
