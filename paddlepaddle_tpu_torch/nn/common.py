"""``Linear`` and ``Embedding`` (counterparts of
``paddlepaddle_tpu/nn/common.py`` :10, :36)."""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F


class Linear(nn.Module):
    """``y = x W`` with ``W: [in_features, out_features]`` — the paddle
    layout, kept so weights carry across from the JAX package unchanged.
    Bias-free, as every Llama projection is."""

    def __init__(self, in_features: int, out_features: int, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"
