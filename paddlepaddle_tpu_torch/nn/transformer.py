"""``MultiHeadAttention``, ``TransformerEncoderLayer`` and
``TransformerEncoder`` (counterparts of ``paddlepaddle_tpu/nn/transformer.py``
:19-141). The decoder half waits (ROADMAP queue A item 5).

Attention runs in the ``[batch, seq, heads, head_dim]`` layout through
:func:`..functional.scaled_dot_product_attention` with ``is_causal=False``,
which routes as the reference's ``flash_attention_bshd`` does: with no mask
and no dropout in effect, the flash kernels on the card (kernel 2 for the
forward, 3 and 4 for the backward); a mask, or a dropout in training,
computes in plain PyTorch on either device. A mask is used as given: bool
keeps, float adds, broadcast over ``[b, h, s_q, s_k]``.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from . import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention of ``embed_dim`` over ``num_heads`` heads,
    with q/k/v/out projections. ``cache=(k, v)`` (``[b, s, h, d]``, from
    :meth:`gen_cache` or a previous call) is prepended to this call's keys
    and values, and the call then returns ``(out, (k, v))``."""

    Cache = tuple
    StaticCache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        """``(k, v)`` projected from ``key`` when ``value`` is None, else
        ``(key, value)`` as given."""
        if value is None:
            return self._shape(self.k_proj(key)), self._shape(self.v_proj(key))
        return key, value


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a two-layer feed-forward, each with a residual
    and a layer norm: after the residual (post-norm, the default) or before
    the sublayer (``normalize_before``). ``activation`` names a function of
    :mod:`..functional` (``"relu"``, ``"gelu"``, ...)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(act_dropout if act_dropout is not None
                                else dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.dropout2(act(self.linear1(src))))
        src = residual + self.dropout(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(nn.Module):
    """``num_layers`` encoder layers: ``encoder_layer`` and deep copies of
    it (so a fresh encoder's layers are equal), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)
