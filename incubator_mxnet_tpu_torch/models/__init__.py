"""Models of the port: GPT (KV-cache serving), BERT (MLM training) and
`sharded_bert` (the functional BERT step over a dp × tp mesh)."""
from . import bert, decoding, gpt, params, sharded_bert
from .bert import (BERTClassifier, BERTEncoder, BERTModel,
                   TransformerEncoderCell, bert_base, bert_small)
from .decoding import GPTDecoder
from .gpt import GPTModel, gpt2_small, gpt_tiny

__all__ = ["bert", "decoding", "gpt", "params", "sharded_bert", "BERTModel",
           "BERTEncoder", "BERTClassifier", "TransformerEncoderCell", "bert_base",
           "bert_small", "GPTDecoder", "GPTModel", "gpt2_small", "gpt_tiny"]
