"""``RMSNorm`` (counterpart of ``paddlepaddle_tpu/nn/norm.py`` :35)."""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.epsilon)
