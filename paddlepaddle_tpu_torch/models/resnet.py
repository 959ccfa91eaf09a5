"""The ResNet family (counterpart of ``paddlepaddle_tpu/models/resnet.py``,
BASELINE config 2): ``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and the
``resnet18`` ... ``152``, ``resnext*`` and ``wide_resnet*`` builders, which
differ only in ``groups`` and ``width``. NCHW, as the reference.

``device`` is keyword-only (None: the card). Weights are drawn by each
layer from the port's stream for the device (:mod:`..core.random`);
``convert.load_jax_state`` carries a JAX model's weights and batch-norm
running statistics across, name for name. ``model.to(torch.bfloat16)``
casts the running statistics too, as the reference's ``Layer.to(dtype=)``
does. In training mode every batch norm updates its running statistics in
place (see ``nn.functional.batch_norm``)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..nn.activation import ReLU
from ..nn.common import Linear
from ..nn.container import Sequential
from ..nn.conv import Conv2D
from ..nn.norm import BatchNorm2D
from ..nn.pooling import AdaptiveAvgPool2D, MaxPool2D


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 device: DeviceLike = None):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and "
                             "base_width=64")
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, device=device)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            device=device)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 device: DeviceLike = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            device=device)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, device=device)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, device=device)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """``block`` stacked ``depth``-deep (18, 34, 50, 101 or 152) over a
    7x7 stem and a 3x3 max pool; ``width`` is the bottleneck's base width,
    ``groups`` its grouped 3x3; a global average pool (``with_pool``) and
    a ``num_classes`` head (none when 0)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device: DeviceLike = None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, device=dev)
        self.bn1 = BatchNorm2D(self.inplanes, device=dev)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], dev)
        self.layer2 = self._make_layer(block, 128, layers[1], dev, stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], dev, stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], dev, stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, device=dev)

    def _make_layer(self, block, planes, blocks, dev, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, device=dev),
                BatchNorm2D(planes * block.expansion, device=dev))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, device=dev)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, device=dev))
        return Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def resnet18(**kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(**kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(**kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(**kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(**kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def resnext50_32x4d(**kwargs):
    return ResNet(BottleneckBlock, 50, width=4, groups=32, **kwargs)


def resnext50_64x4d(**kwargs):
    return ResNet(BottleneckBlock, 50, width=4, groups=64, **kwargs)


def resnext101_32x4d(**kwargs):
    return ResNet(BottleneckBlock, 101, width=4, groups=32, **kwargs)


def resnext101_64x4d(**kwargs):
    return ResNet(BottleneckBlock, 101, width=4, groups=64, **kwargs)


def resnext152_32x4d(**kwargs):
    return ResNet(BottleneckBlock, 152, width=4, groups=32, **kwargs)


def resnext152_64x4d(**kwargs):
    return ResNet(BottleneckBlock, 152, width=4, groups=64, **kwargs)


def wide_resnet50_2(**kwargs):
    return ResNet(BottleneckBlock, 50, width=128, **kwargs)


def wide_resnet101_2(**kwargs):
    return ResNet(BottleneckBlock, 101, width=128, **kwargs)
