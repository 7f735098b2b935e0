"""Models of the port: GPT (KV-cache serving) and the BERT blocks GPT
shares."""
from . import bert, decoding, gpt
from .decoding import GPTDecoder
from .gpt import GPTModel, gpt2_small, gpt_tiny

__all__ = ["bert", "decoding", "gpt", "GPTDecoder", "GPTModel",
           "gpt2_small", "gpt_tiny"]
