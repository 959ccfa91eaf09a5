"""``Linear``, ``Embedding`` and ``Dropout`` (counterparts of
``paddlepaddle_tpu/nn/common.py`` :10, :36, :59).

Both keep the reference's positional parameters; ``device`` and ``dtype``
are keyword-only (``device=None`` is the card, as for every entry point;
``dtype`` defaults to float32, the reference's default). A layer is
initialised as the reference's: ``Linear``'s weight Xavier-normal and its
bias zeros, ``Embedding``'s weight N(0, 1), drawn from the port's default
generator (:mod:`..core.random`). A ``weight_attr`` / ``bias_attr`` other
than None, True (and ``bias_attr=False``, no bias) would carry an
initializer, a name or a learning rate the port cannot honour yet: it
raises ``NotImplementedError`` (ROADMAP A11)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core import random
from ..core.dtype import to_torch_dtype
from ..device import resolve_device
from . import functional as F


def check_attr(owner: str, what: str, attr, allow_false: bool) -> None:
    """Raise on a ``ParamAttr``-like argument the port does not honour."""
    if attr is None or attr is True or (allow_false and attr is False):
        return
    raise NotImplementedError(
        f"{owner}({what}={attr!r}): parameter attributes (initializer, "
        "name, learning rate, trainable) are not ported (ROADMAP A11)")


class Linear(nn.Module):
    """``y = x W (+ b)`` with ``W: [in_features, out_features]`` — the
    paddle layout, kept so weights carry across from the JAX package
    unchanged. ``bias_attr=False`` builds no bias (every Llama projection)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_attr("Linear", "weight_attr", weight_attr, allow_false=False)
        check_attr("Linear", "bias_attr", bias_attr, allow_false=True)
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=dev, dtype=dt))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=dev,
                                              dtype=dt))
                     if bias_attr is not False else None)
        with torch.no_grad():
            std = math.sqrt(2.0 / (in_features + out_features))
            self.weight.normal_(0.0, std,
                                generator=random.torch_generator(dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    """Row lookup ``weight[ids]``; ids equal to ``padding_idx`` read zeros
    (and send that row no gradient). ``sparse`` is accepted and, as in the
    reference, not read."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        check_attr("Embedding", "weight_attr", weight_attr, allow_false=False)
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=dev, dtype=dt))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0,
                                generator=random.torch_generator(dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """:func:`..functional.dropout` with ``p``, ``axis`` and ``mode``, in
    training only while the module is in training mode."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"
