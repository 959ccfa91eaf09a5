"""Optimizers of the port: the base class, every optimizer of the
reference's ``optimizers.py`` but ``LBFGS``, ``ASGD``, ``Rprop`` and
``DGCMomentumOptimizer``, and the LR schedulers (``lr``)."""

from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                         AdamW, Lamb, Lars, LarsMomentumOptimizer, Momentum,
                         NAdam, RAdam, RMSProp)
