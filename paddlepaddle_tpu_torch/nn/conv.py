"""``Conv1D`` and ``Conv2D`` (counterparts of ``paddlepaddle_tpu/nn/conv.py``
:18-76). Weights are ``[out_channels, in_channels / groups, *kernel]``,
the OIHW layout of both packages, whatever the data format. The weight is
drawn Kaiming-uniform over ``fan_in = in_channels * prod(kernel) /
groups`` and the bias uniform in ``+-1/sqrt(fan_in)``, from the port's
stream for the layer's device. ``padding`` takes the reference's forms
(see ``functional._pad_pairs``); ``padding_mode`` is accepted and, as in
the reference, not read."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core import random
from ..core.dtype import to_torch_dtype
from ..device import resolve_device
from . import functional as F
from .common import check_attr


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32):
        super().__init__()
        check_attr(type(self).__name__, "weight_attr", weight_attr,
                   allow_false=False)
        check_attr(type(self).__name__, "bias_attr", bias_attr,
                   allow_false=True)
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = F._tup(kernel_size, nd)
        self._stride = F._tup(stride, nd)
        self._padding = padding
        self._dilation = F._tup(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        self._nd = nd
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        gen = random.torch_generator(dev)
        self.weight = nn.Parameter(torch.empty(
            [out_channels, in_channels // groups, *self._kernel_size],
            device=dev, dtype=dt))
        limit = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=gen)
            self.bias = None
            if bias_attr is not False:
                self.bias = nn.Parameter(torch.empty(out_channels, device=dev,
                                                     dtype=dt))
                self.bias.uniform_(-bound, bound, generator=gen)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, kernel_size="
                f"{self._kernel_size}, stride={self._stride}, padding="
                f"{self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)
