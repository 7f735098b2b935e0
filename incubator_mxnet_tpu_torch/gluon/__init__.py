"""``mx.gluon`` of the port: Parameters, Blocks and HybridBlocks (with
``hybridize`` as CUDA graphs), the layers, the losses and the Trainer
(port of `incubator_mxnet_tpu/gluon/`).

A Block is a `torch.nn.Module` whose `Parameter`s register their tensors
under MXNet's names (``weight``, ``bias``, ``gamma``, ``beta``), so
``named_parameters()`` and ``collect_params()`` agree one to one. A
block takes NDArrays (the reference's convention) or torch tensors (the
port's module path); see `gluon.block`. `model_zoo` holds the vision
models and the local pretrained-weight store; `data` the datasets,
samplers, transforms and the DataLoader; `metric` the evaluation
metrics; `contrib` the Estimator and the composable vision loader;
`rnn` the recurrent layers and cells.
"""
from . import utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer
from . import loss, nn
from . import rnn
from . import metric
from . import data
from . import model_zoo
from . import contrib

__all__ = ["utils", "Block", "HybridBlock", "SymbolBlock", "Constant",
           "Parameter", "ParameterDict", "Trainer", "loss", "nn", "metric",
           "data", "model_zoo", "contrib", "rnn"]
