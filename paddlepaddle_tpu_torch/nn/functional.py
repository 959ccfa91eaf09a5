"""Functional subset the Llama serving path needs (counterpart of
``paddlepaddle_tpu/nn/functional.py``: ``linear`` :183, ``embedding`` :202,
``swiglu`` :137, ``rms_norm`` :336). Plain tensor functions; weights keep the
paddle layout ``W: [in, out]``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as _tF


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``y = x @ W`` with ``W: [in, out]`` (the Llama projections carry no
    bias)."""
    return torch.matmul(x, weight)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Row gather ``weight[ids]``."""
    return weight[ids]


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y``."""
    return _tF.silu(x) * y


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMS norm in the reference's exact order: f32 mean of squares ->
    rsqrt -> cast back to the input dtype -> multiply by the weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out
