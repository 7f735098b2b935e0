"""Models of the port: GPT (KV-cache serving) and BERT (MLM training)."""
from . import bert, decoding, gpt, params
from .bert import (BERTClassifier, BERTEncoder, BERTModel,
                   TransformerEncoderCell, bert_base, bert_small)
from .decoding import GPTDecoder
from .gpt import GPTModel, gpt2_small, gpt_tiny

__all__ = ["bert", "decoding", "gpt", "params", "BERTModel", "BERTEncoder",
           "BERTClassifier", "TransformerEncoderCell", "bert_base",
           "bert_small", "GPTDecoder", "GPTModel", "gpt2_small", "gpt_tiny"]
