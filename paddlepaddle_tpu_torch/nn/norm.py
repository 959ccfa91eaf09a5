"""``RMSNorm`` (counterpart of ``paddlepaddle_tpu/nn/norm.py`` :35)."""

from __future__ import annotations

import torch
from torch import nn

from ..core.dtype import to_torch_dtype
from ..device import resolve_device
from . import functional as F
from .common import check_attr


class RMSNorm(nn.Module):
    """RMS norm over the last axis with a weight of ``normalized_shape``
    (ones), and a zero bias when ``bias_attr`` is True (the reference's
    default ``bias_attr=False`` builds none). The reference's positional
    parameters; ``device`` / ``dtype`` keyword-only, as for ``Linear``."""

    def __init__(self, normalized_shape, epsilon: float = 1e-6,
                 weight_attr=None, bias_attr=False, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        check_attr("RMSNorm", "weight_attr", weight_attr, allow_false=False)
        check_attr("RMSNorm", "bias_attr", bias_attr, allow_false=True)
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=dev, dtype=dt))
        self.bias = (nn.Parameter(torch.zeros(self.normalized_shape,
                                              device=dev, dtype=dt))
                     if bias_attr not in (False, None) else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.bias, self.epsilon)
