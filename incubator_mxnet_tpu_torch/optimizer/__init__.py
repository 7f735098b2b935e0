"""Optimizers of the port (``mx.optimizer``)."""
from ..lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                            MultiFactorScheduler, PolyScheduler)
from .optimizer import (DCASGD, FTML, FTRL, LAMB, LANS, LARS, NAG, SGD, SGLD,
                        AdaBelief, AdaDelta, AdaGrad, Adam, Adamax, AdamW,
                        Ftrl, GroupAdaGrad, Nadam, Optimizer, RMSProp, Signum,
                        Updater, create, get_updater, register)

__all__ = ["Optimizer", "create", "register", "SGD", "NAG", "Adam", "AdamW",
           "AdaBelief", "AdaDelta", "AdaGrad", "Adamax", "DCASGD", "FTML",
           "FTRL", "Ftrl", "GroupAdaGrad", "LAMB", "LANS", "LARS", "Nadam",
           "RMSProp", "SGLD", "Signum", "Updater", "get_updater",
           "CosineScheduler", "FactorScheduler", "LRScheduler",
           "MultiFactorScheduler", "PolyScheduler"]
