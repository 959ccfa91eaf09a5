"""``MaxPool2D``, ``AvgPool2D`` and ``AdaptiveAvgPool2D`` (counterparts of
``paddlepaddle_tpu/nn/pooling.py`` :9, :19, :57): each holds its
functional's arguments. As in the reference the pools floor their output
size whatever ``ceil_mode`` says."""

from __future__ import annotations

from torch import nn

from . import functional as F


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, return_mask,
                     data_format)

    def forward(self, x):
        return F.max_pool2d(x, *self.args)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool2d(x, *self.args)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
