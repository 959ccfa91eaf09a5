"""Activation layers (counterpart of ``paddlepaddle_tpu/nn/activation.py``):
one layer per functional activation, holding the functional's extra
arguments, plus ``Softmax``, ``LogSoftmax`` and ``PReLU``."""

from __future__ import annotations

import torch
from torch import nn

from ..core.dtype import to_torch_dtype
from ..device import resolve_device
from . import functional as F
from .common import check_attr


def _layer(fn_name: str):
    class _Act(nn.Module):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            self._args = args
            self._kwargs = kwargs

        def forward(self, x):
            return getattr(F, fn_name)(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = "".join(
        p.capitalize() for p in fn_name.split("_"))
    return _Act


ReLU = _layer("relu")
ReLU6 = _layer("relu6")
Sigmoid = _layer("sigmoid")
Tanh = _layer("tanh")
Silu = _layer("silu")
Swish = _layer("swish")
Mish = _layer("mish")
GELU = _layer("gelu")
LeakyReLU = _layer("leaky_relu")
ELU = _layer("elu")
CELU = _layer("celu")
SELU = _layer("selu")
Hardtanh = _layer("hardtanh")
Hardsigmoid = _layer("hardsigmoid")
Hardswish = _layer("hardswish")
Hardshrink = _layer("hardshrink")
Softshrink = _layer("softshrink")
Softplus = _layer("softplus")
Softsign = _layer("softsign")
Tanhshrink = _layer("tanhshrink")
ThresholdedReLU = _layer("thresholded_relu")
LogSigmoid = _layer("log_sigmoid")
Maxout = _layer("maxout")
GLU = _layer("glu")
RReLU = _layer("rrelu")


class Softmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class PReLU(nn.Module):
    """``where(x > 0, x, w x)`` with ``num_parameters`` slopes set to
    ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_attr("PReLU", "weight_attr", weight_attr, allow_false=False)
        self.data_format = data_format
        self.weight = nn.Parameter(torch.full(
            [num_parameters], float(init), device=resolve_device(device),
            dtype=to_torch_dtype(dtype)))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)
