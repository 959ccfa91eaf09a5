"""Functional subset the Llama serving and training paths need (counterpart
of ``paddlepaddle_tpu/nn/functional.py``: ``linear`` :183, ``embedding``
:202, ``swiglu`` :137, ``rms_norm`` :336, ``scaled_dot_product_attention``
:1193, ``flash_attention`` :1206, ``flash_attn_unpadded`` :1215). Plain
tensor functions; weights keep the paddle layout ``W: [in, out]``; attention
keeps the ``[b, s, h, d]`` layout, varlen attention the packed ``[t, h, d]``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as _tF


def linear(x: torch.Tensor, weight, bias: Optional[torch.Tensor] = None,
           name=None) -> torch.Tensor:
    """``y = x @ W (+ b)`` with ``W: [in, out]`` (reference :183). A weight
    that carries ``wo_matmul`` (an ``nn.quant.QuantizedWeight``) lowers
    through it, int8 codes with the scale applied after the product, and
    the result is cast back to ``x.dtype``. ``name`` is accepted for API
    parity."""
    wo = getattr(weight, "wo_matmul", None)
    out = torch.matmul(x, weight) if wo is None else wo(x).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Row gather ``weight[ids]``."""
    return weight[ids]


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y``."""
    return _tF.silu(x) * y


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1, name=None) -> torch.Tensor:
    """RMS norm over the last axis in the reference's exact order (:336): f32
    mean of squares -> rsqrt -> cast back to the input dtype -> multiply by
    the weight -> add the bias. ``begin_norm_axis`` must name the last axis
    (-1 or ``x.dim() - 1``); another axis raises ``NotImplementedError``.
    ``name`` is accepted for API parity."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"rms_norm: begin_norm_axis={begin_norm_axis} (only the last "
            f"axis, -1 or {x.dim() - 1}, is normalised)")
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 name=None) -> torch.Tensor:
    """Attention over ``[b, s, h, d]``: the flash kernels on the card, the
    plain version on the CPU (see ``ops/kernels/flash_attention.py``).
    ``name`` is accepted for API parity."""
    from ..ops.kernels.flash_attention import flash_attention_bshd

    return flash_attention_bshd(query, key, value, causal=is_causal,
                                mask=attn_mask,
                                dropout=dropout_p if training else 0.0)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None):
    """``(out, None)``: the softmax is never returned, as in the reference
    (:1206, same argument order). A dropout draws from a generator seeded
    with ``fixed_seed_offset`` when given, else from the named generator
    ``rng_name`` of ``core.random`` (the default one for ``""``)."""
    from ..core import random
    from ..ops.kernels.flash_attention import flash_attention_bshd

    drop = float(dropout) if training else 0.0
    gen = (random.dropout_generator(query.device, fixed_seed_offset,
                                    rng_name) if drop > 0.0 else None)
    out = flash_attention_bshd(query, key, value, causal=causal,
                               dropout=drop, generator=gen)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, fixed_seed_offset=None,
                        rng_name: str = "", training: bool = True,
                        name=None):
    """Packed varlen attention (reference flash_attention.py:762): the
    varlen kernels on the card, the plain version on the CPU (see
    ``ops/kernels/flash_varlen.py``). Returns ``(out, None)``.
    ``fixed_seed_offset`` reaches the dropout, where the JAX package's
    functional wrapper (:1215) drops it."""
    from ..ops.kernels.flash_varlen import flash_attn_unpadded as _impl

    return _impl(query, key, value, cu_seqlens_q, cu_seqlens_k,
                 max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k,
                 scale=scale, dropout=dropout, causal=causal,
                 return_softmax=return_softmax,
                 fixed_seed_offset=fixed_seed_offset, rng_name=rng_name,
                 training=training)
