"""Functional subset the Llama serving and training paths need (counterpart
of ``paddlepaddle_tpu/nn/functional.py``: ``linear`` :183, ``embedding``
:202, ``swiglu`` :137, ``rms_norm`` :336, ``scaled_dot_product_attention``
:1193, ``flash_attention`` :1206). Plain tensor functions; weights keep the
paddle layout ``W: [in, out]``; attention keeps the ``[b, s, h, d]``
layout."""

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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """Attention over ``[b, s, h, d]``: the flash kernels on the card, the
    plain version on the CPU (see ``ops/kernels/flash_attention.py``)."""
    from ..ops.kernels.flash_attention import flash_attention_bshd

    return flash_attention_bshd(query, key, value, causal=is_causal,
                                mask=attn_mask,
                                dropout=dropout_p if training else 0.0)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    training: bool = True):
    """``(out, None)``: the softmax is never returned, as in the
    reference."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None
