"""``Sequential`` and ``LayerList`` (counterparts of
``paddlepaddle_tpu/nn/container.py`` :10, :40). Children are named ``"0"``,
``"1"``, ... as in Paddle and torch, so state names carry across."""

from __future__ import annotations

from collections import OrderedDict

from torch import nn


class Sequential(nn.Sequential):
    """Layers applied in turn. Built from layers (named by position), from
    one ``OrderedDict`` of name -> layer, or from ``(name, layer)`` pairs;
    indexed by position, slice or name."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self._modules[idx]
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerList(nn.ModuleList):
    """A list of layers (``sublayers``), named by position."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
