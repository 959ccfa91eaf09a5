"""Packed flash-attention entry points (counterpart of the JAX package's
``nn/long_tail.py`` :555-577; reference flash_attention.py:700).

``flash_attn_qkvpacked`` unpacks ``qkv [b, s, 3, h, d]`` onto the dense
flash kernels; ``flash_attn_varlen_qkvpacked`` unpacks ``qkv [t, 3, h, d]``
onto the varlen kernels. Both return ``(out, None)``.
"""

from __future__ import annotations

from . import functional as F


def flash_attn_qkvpacked(qkv, dropout: float = 0.0, causal: bool = False,
                         return_softmax: bool = False, fixed_seed_offset=None,
                         rng_name: str = "", training: bool = True,
                         name=None):
    """``qkv [b, s, 3, h, d]`` -> ``(out [b, s, h, d], None)``."""
    out = F.scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                         qkv[:, :, 2], dropout_p=dropout,
                                         is_causal=causal, training=training)
    return out, None


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout: float = 0.0,
                                causal: bool = False,
                                return_softmax: bool = False,
                                varlen_padded: bool = True,
                                training: bool = True, name=None):
    """``qkv [t, 3, h, d]`` packed -> ``(out [t, h, d], None)``."""
    return F.flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                                 cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                 max_seqlen_k, scale=scale, dropout=dropout,
                                 causal=causal, training=training)
