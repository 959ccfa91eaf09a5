"""Llama-3-style decoder-only LM: forward, logits and the next-token loss
(counterpart of ``paddlepaddle_tpu/models/llama.py``).

What is here: ``LlamaConfig`` with its presets, the fp32 rope tables and the
NeoX rotate-half rope (scalar or per-row offsets), ``_cached_attention`` (the
plain-PyTorch prefill attention the decode engine uses), the cross-entropy
rows ``_CERows`` and ``loss_from_logits``, and the attention / MLP / decoder
layer / model / causal-LM modules. ``generate`` and ``generate_cached`` are
not ported (ROADMAP A3).

Attention without a cache (``LlamaForCausalLM.forward(ids[, labels])``, the
training path) repeats the K/V heads and runs ``F.flash_attention(...,
causal=True)``, as the reference does (:246-266): the flash kernels on the
card, the plain version on the CPU. With a cache it runs
``_cached_attention``, the path of the JAX engine's prefill.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..core.dtype import to_torch_dtype
from ..device import DeviceLike, resolve_device
from ..nn import functional as F
from ..nn.common import Embedding, Linear
from ..nn.norm import RMSNorm
from ..ops.kernels._build import check_device
from ..ops.kernels.flash_attention import flash_attention_supported

Cache = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")

    @staticmethod
    def tiny(vocab_size=256, hidden_size=64, layers=2, heads=4, kv_heads=2,
             max_len=128) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            intermediate_size=hidden_size * 3, num_hidden_layers=layers,
            num_attention_heads=heads, num_key_value_heads=kv_heads,
            max_position_embeddings=max_len)

    def num_params(self) -> int:
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        kv = self.num_key_value_heads * self.head_dim
        per_layer = h * h + 2 * h * kv + h * h + 3 * h * i + 2 * h
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return self.num_hidden_layers * per_layer + embed + h


def rope_tables(head_dim: int, max_len: int, theta: float,
                device: DeviceLike = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables ``[max_len, head_dim]`` for NeoX-style rope."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                      # [T, dim/2]
    emb = torch.cat([freqs, freqs], dim=-1)               # [T, dim]
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_at(cos: torch.Tensor, sin: torch.Tensor,
            offset: Union[int, torch.Tensor], seq: int, dtype: torch.dtype):
    """cos/sin rows for positions ``offset .. offset+seq-1``, shaped to
    broadcast over ``[b, seq, heads, d]``. ``offset`` is a scalar start or a
    per-row ``[b]`` vector (ragged continuous batching). Positions are
    clamped to the table as the reference's gather clamps them; the fp32
    tables are cast to the activation dtype, as in the reference."""
    T = cos.shape[0]
    if isinstance(offset, torch.Tensor) and offset.dim() > 0:
        idx = offset.long()[:, None] + torch.arange(
            seq, device=cos.device)[None, :]               # [b, seq]
        idx = idx.clamp(0, T - 1)
        c, s = cos[idx][:, :, None, :], sin[idx][:, :, None, :]
    else:
        start = min(max(int(offset), 0), T - seq)
        c = cos[start:start + seq][None, :, None, :]
        s = sin[start:start + seq][None, :, None, :]
    return c.to(dtype), s.to(dtype)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return x * c + rotate_half(x) * s


def _apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, offset: Union[int, torch.Tensor] = 0):
    """NeoX rotate-half rope on ``[b, s, heads, d]`` q and k at positions
    ``offset .. offset+s-1`` (see :func:`rope_at`)."""
    c, s = rope_at(cos, sin, offset, q.shape[1], q.dtype)
    return rotate(q, c, s), rotate(k, c, s)


def _cached_attention(q, k_new, v_new, k_cache, v_cache, pos, n_rep: int,
                      scale: float):
    """Write new K/V at ``[pos, pos+s)`` and attend ``q`` over the valid
    cache prefix — plain PyTorch, the prefill path.

    ``q/k_new/v_new``: ``[b, s, heads, d]``; caches ``[b, L, kvh, d]``;
    ``pos`` a scalar or a per-row ``[b]`` vector. The caches are updated IN
    PLACE (where the reference returned new arrays) and returned as well.
    GQA contracts the regrouped ``q [b, s, kvh, rep, d]`` against the
    unrepeated cache; logits and softmax are f32, as in the reference.
    Returns ``(out [b, s, h, d], k_cache, v_cache)``."""
    b, s = q.shape[0], q.shape[1]
    L = k_cache.shape[1]
    dev = q.device
    ar_s = torch.arange(s, device=dev)
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        rows = torch.arange(b, device=dev)[:, None]
        cols = pos.long()[:, None] + ar_s[None, :]                # [b, s]
        k_cache[rows, cols] = k_new.to(k_cache.dtype)
        v_cache[rows, cols] = v_new.to(v_cache.dtype)
        q_pos = cols[:, :, None]                                  # [b, s, 1]
    else:
        p0 = int(pos)
        k_cache[:, p0:p0 + s] = k_new.to(k_cache.dtype)
        v_cache[:, p0:p0 + s] = v_new.to(v_cache.dtype)
        q_pos = (p0 + ar_s)[None, :, None]                        # [1, s, 1]
    k_pos = torch.arange(L, device=dev)[None, None, :]
    valid = k_pos <= q_pos                                        # [b|1, s, L]
    h, d = q.shape[2], q.shape[3]
    kvh = k_cache.shape[2]
    qg = q.reshape(b, s, kvh, n_rep, d)
    logits = torch.einsum("bskrd,blkd->bkrsl", qg.float(),
                          k_cache.float()) * scale
    logits = logits.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrsl,blkd->bskrd",
                       probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, s, h, d).to(q.dtype), k_cache, v_cache


_CE_CHUNK_ELEMS = 1 << 27          # f32 elements of one loss chunk (512 MB)


class _CERows(torch.autograd.Function):
    """Per-position NLL ``lse(logits) - logits[label]`` in f32 over logits
    of the model's dtype (reference ``_ce_rows`` :33-59). The forward saves
    only the logits and the ``[B, S]`` f32 lse; the backward rebuilds the
    softmax rows in f32, so no f32 ``[B, S, V]`` residual crosses from
    forward to backward. Rows are taken in chunks so the f32 temporaries
    stay near ``_CE_CHUNK_ELEMS`` elements whatever the vocabulary."""

    @staticmethod
    def forward(ctx, lg, labels):
        V = lg.shape[-1]
        flat = lg.reshape(-1, V)
        lab = labels.reshape(-1, 1)
        lse = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=lg.device)
        rows = max(1, _CE_CHUNK_ELEMS // V)
        for i in range(0, flat.shape[0], rows):
            lse[i:i + rows] = torch.logsumexp(flat[i:i + rows].float(), -1)
        picked = flat.gather(1, lab)[:, 0].float()
        lse = lse.reshape(labels.shape)
        ctx.save_for_backward(lg, labels, lse)
        return lse - picked.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        lg, labels, lse = ctx.saved_tensors
        V = lg.shape[-1]
        flat = lg.reshape(-1, V)
        lab = labels.reshape(-1, 1)
        lse, g = lse.reshape(-1, 1), g.reshape(-1, 1).float()
        grad = torch.empty_like(flat)
        rows = max(1, _CE_CHUNK_ELEMS // V)
        for i in range(0, flat.shape[0], rows):
            p = torch.exp(flat[i:i + rows].float() - lse[i:i + rows])
            p.scatter_add_(1, lab[i:i + rows],
                           torch.full_like(lse[i:i + rows], -1.0))
            grad[i:i + rows] = (p * g[i:i + rows]).to(lg.dtype)
        return grad.reshape(lg.shape), None


def loss_from_logits(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy in f32 (reference ``loss_from_logits``
    :549): the label of position t is token t+1 (labels rolled by -1),
    labels < 0 are ignored, the last position has no target, and the mean
    is over the valid positions."""
    seq = logits.shape[1]
    lb_next = torch.roll(labels, -1, dims=1)
    nll = _CERows.apply(logits, lb_next.clamp_min(0).long())
    pos = torch.arange(seq, device=logits.device)[None, :]
    valid = ((lb_next >= 0) & (pos < seq - 1)).float()
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, init_std: float) -> None:
    """Every parameter N(0, ``init_std``) from a generator on the model's
    device seeded with ``seed``, except the norms' weights, which are ones."""
    params = list(model.named_parameters())
    gen = torch.Generator(device=params[0][1].device)
    gen.manual_seed(int(seed))
    for name, p in params:
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, init_std, generator=gen)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv = self.num_kv_heads * self.head_dim
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, kv, **kw)
        self.v_proj = Linear(h, kv, **kw)
        self.o_proj = Linear(h, h, **kw)

    def forward(self, x, cos, sin, cache: Optional[Cache] = None, pos=0):
        """``cache=None``: causal self-attention over ``x`` alone through
        ``F.flash_attention`` (K/V heads repeated first, so autograd sums
        the repeated heads' gradients), returns the output. With a cache:
        write-through at ``pos``, returns ``(output, new cache)``."""
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = _apply_rope(q, k, cos, sin, offset=pos)
        if cache is None:
            rep = self.num_heads // self.num_kv_heads
            if rep > 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out, _ = F.flash_attention(q, k, v, causal=True)
            return self.o_proj(out.reshape(b, s, -1))
        out, kc, vc = _cached_attention(
            q, k, v, cache[0], cache[1], pos,
            self.num_heads // self.num_kv_heads, 1.0 / math.sqrt(self.head_dim))
        return self.o_proj(out.reshape(b, s, -1)), (kc, vc)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = Linear(h, i, **kw)
        self.up_proj = Linear(h, i, **kw)
        self.down_proj = Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cos, sin, cache: Optional[Cache] = None, pos=0):
        """Returns ``x`` without a cache, ``(x, new cache)`` with one."""
        if cache is None:
            x = x + self.self_attn(self.input_layernorm(x), cos, sin)
            return x + self.mlp(self.post_attention_layernorm(x))
        attn_out, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                             cache, pos)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        # fp32 rope tables, recomputed here rather than carried as state
        # (non-persistent: they are not part of state_dict)
        cos, sin = rope_tables(config.head_dim,
                               config.max_position_embeddings,
                               config.rope_theta, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids: torch.Tensor,
                caches: Optional[List[Cache]] = None, pos=0):
        """``caches=None``: causal attention over ``input_ids`` alone
        (flash attention), returns the final hidden states. With caches:
        write-through at ``pos`` (scalar or per-row), returns
        ``(hidden, caches)``."""
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos, self.rope_sin
        if caches is None:
            for layer in self.layers:
                x = layer(x, cos, sin)
            return self.norm(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, nc = layer(x, cos, sin, cache, pos)
            new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """Causal LM head over :class:`LlamaModel`.

    ``device=None`` builds on the card (raises without CUDA). Weights are
    drawn from a seeded generator on that device: N(0, ``init_std``) for
    every matrix, ones for the norms. Parity tests overwrite them with the
    JAX model's weights through :mod:`..convert`. On the card the flash
    kernels' support check runs here and raises on a configuration they do
    not take."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 seed: int = 0, init_std: float = 0.02):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = to_torch_dtype(config.dtype)
        if dev.type == "cuda":
            check_device(dev)
            n = config.max_position_embeddings
            ok, why = flash_attention_supported(config.head_dim, dtype, True,
                                                n, n)
            if not ok:
                raise ValueError(f"flash attention kernels do not take this "
                                 f"model: {why}")
        self.model = LlamaModel(config, device=dev, dtype=dtype)
        self.lm_head = (None if config.tie_word_embeddings
                        else Linear(config.hidden_size, config.vocab_size,
                                    device=dev, dtype=dtype))
        self.reset_parameters(seed, init_std)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    def reset_parameters(self, seed: int = 0, init_std: float = 0.02) -> None:
        init_weights(self, seed, init_std)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return torch.matmul(hidden, self.model.embed_tokens.weight.T)
        return self.lm_head(hidden)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[b, s, vocab]``, or with ``labels`` the next-token loss
        (reference :361-369)."""
        logits = self.logits(self.model(input_ids))
        if labels is None:
            return logits
        return self.loss_from_logits(logits, labels)

    loss_from_logits = staticmethod(loss_from_logits)
