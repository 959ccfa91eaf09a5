"""Llama-3-style decoder-only LM: forward, logits and the next-token loss
(counterpart of ``paddlepaddle_tpu/models/llama.py``).

What is here: ``LlamaConfig`` with its presets, the fp32 rope tables and the
NeoX rotate-half rope (scalar or per-row offsets), ``_cached_attention`` (the
plain-PyTorch prefill attention the decode engine uses), the cross-entropy
rows ``_CERows`` and ``loss_from_logits``, the attention / MLP / decoder
layer / model / causal-LM modules, and the causal LM's two decoding loops:
``generate_cached`` (prefill once, then single-position steps over
contiguous caches, the static serving mode's path) and ``generate`` (the
O(L^2) loop over a static token buffer, one full forward a token).

Attention without a cache (``LlamaForCausalLM.forward(ids[, labels])``, the
training path) repeats the K/V heads and runs ``F.flash_attention(...,
causal=True)``, as the reference does (:246-266): the flash kernels on the
card, the plain version on the CPU. With an ``attn_mask`` it runs
``F.scaled_dot_product_attention(..., attn_mask=mask, is_causal=True)``,
which the reference computes with XLA (a bool mask selects, a float mask
adds): plain PyTorch on either device, no flash launch, since no TPU kernel
takes a mask. With a cache it runs ``_cached_attention``, the path of the
JAX engine's prefill; a mask with caches raises, as in the reference. With
``LlamaConfig.context_parallel_axis`` set (read at each call, reference
:251) attention runs ring attention over that axis
(:mod:`..ops.kernels.ring_attention`), and under a context-parallel
``ShardedTrainStep`` the loss shifts its labels across the sequence blocks
(:func:`sequence_sharded`).

``LlamaConfig.recompute`` runs each decoder layer under activation
recompute (:mod:`..distributed.fleet.recompute`) with ``remat_policy``
None (full), ``"dots"`` or ``"dots_no_batch"`` (reference :84-92, :327-345).
Every function the reference runs as a named op passes its inputs through
the AMP cast hook under that name (``fused_rope`` here; ``linear``,
``rms_norm``, ``embedding``, ``flash_attention`` and ``cross_entropy`` in
their modules).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..amp import amp_cast
from ..core.dtype import to_torch_dtype
from ..device import DeviceLike, resolve_device
from ..nn import functional as F
from ..nn.common import Embedding, Linear
from ..distributed.fleet.recompute import recompute, remat_policy
from ..nn.norm import RMSNorm
from ..ops.kernels._build import check_device
from ..ops.kernels.flash_attention import (flash_attention_supported,
                                           routes_to_plain)

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
    # ring attention over a context-parallel axis (reference :82-83, :251),
    # read by each attention call, so it may be set after construction as
    # the reference's tests do. The data-parallel axis is read only by that
    # path, in the reference too
    context_parallel_axis: Optional[str] = None
    data_parallel_axis: str = "dp"
    # activation recompute per decoder layer (reference :84-92)
    recompute: bool = False
    # None = full remat; "dots" saves the matrix products' outputs,
    # "dots_no_batch" those without a batch dim
    remat_policy: Optional[str] = None

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
    ``offset .. offset+s-1`` (see :func:`rope_at`); the reference's
    ``fused_rope`` op."""
    q, k, cos, sin = amp_cast("fused_rope", q, k, cos, sin)
    c, s = rope_at(cos, sin, offset, q.shape[1], q.dtype)
    return rotate(q, c, s), rotate(k, c, s)


def _cached_attention(q, k_new, v_new, k_cache, v_cache, pos, n_rep: int,
                      scale: float):
    """Write new K/V at ``[pos, pos+s)`` and attend ``q`` over the valid
    cache prefix — plain PyTorch, the prefill path.

    ``q/k_new/v_new``: ``[b, s, heads, d]``; caches ``[b, L, kvh, d]``;
    ``pos`` a scalar or a per-row ``[b]`` vector. The caches are updated IN
    PLACE (where the reference returned new arrays) and returned as well.
    A per-row write past the cache is dropped, as the reference's scatter
    drops it (the speculative draft proposes past ``max_len``); the writes
    go one column at a time, so no two land on one row and position.
    GQA contracts the regrouped ``q [b, s, kvh, rep, d]`` against the
    unrepeated cache; logits and softmax are f32, as in the reference.
    Returns ``(out [b, s, h, d], k_cache, v_cache)``."""
    b, s = q.shape[0], q.shape[1]
    L = k_cache.shape[1]
    dev = q.device
    ar_s = torch.arange(s, device=dev)
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        rows = torch.arange(b, device=dev)
        cols = pos.long()[:, None] + ar_s[None, :]                # [b, s]
        inside = (cols < L)[:, :, None, None]
        write = cols.clamp(max=L - 1)
        for j in range(s):
            for cache, new in ((k_cache, k_new), (v_cache, v_new)):
                old = cache[rows, write[:, j]]
                cache[rows, write[:, j]] = torch.where(
                    inside[:, j], new[:, j].to(cache.dtype), old)
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


def next_labels(labels: torch.Tensor, pg=None):
    """The next-token targets of ``labels [b, s]``: ``(label of position
    t + 1, global position of t, global length)``. With ``pg`` (the
    sequence axis's group) ``labels`` is this rank's block ``[r * s, (r +
    1) * s)`` of the sequence: its last position's target is the next
    block's first label (the first columns are gathered, no gradient)."""
    seq = labels.shape[1]
    pos = torch.arange(seq, device=labels.device)[None, :]
    if pg is None:
        return torch.roll(labels, -1, dims=1), pos, seq
    from ..distributed.collective import _all_gather, _grank, _size

    n, r = _size(pg), _grank(pg)
    firsts = _all_gather(labels[:, :1].contiguous(), pg, 1)       # [b, n]
    nxt = (r + 1) % n
    return (torch.cat([labels[:, 1:], firsts[:, nxt:nxt + 1]], dim=1),
            pos + r * seq, seq * n)


def loss_from_logits(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy in f32 (reference ``loss_from_logits``
    :549, the ``cross_entropy`` op): the label of position t is token t+1
    (labels rolled by -1), labels < 0 are ignored, the last position has no
    target, and the mean is over the valid positions. Inside
    :func:`sequence_sharded` the arrays are this rank's sequence block and
    the shift and the last position are the global ones."""
    logits, labels = amp_cast("cross_entropy", logits, labels)
    lb_next, pos, total = next_labels(labels, _seq_shard.get())
    nll = _CERows.apply(logits, lb_next.clamp_min(0).long())
    valid = ((lb_next >= 0) & (pos < total - 1)).float()
    count = valid.sum()
    reduce_count = _token_count_reduce.get()
    if reduce_count is not None:
        count = reduce_count(count)
    return (nll * valid).sum() / count.clamp_min(1.0)


# set by a data-parallel step for its own thread: reduces the valid-token
# count over the data group, so each rank's loss is its part of the global
# token mean
_token_count_reduce: contextvars.ContextVar = contextvars.ContextVar(
    "token_count_reduce", default=None)
# set by a context-parallel step for its own thread: the group of the
# sequence axis the batch's columns are sharded over
_seq_shard: contextvars.ContextVar = contextvars.ContextVar(
    "seq_shard", default=None)


@contextlib.contextmanager
def sequence_sharded(pg):
    """Inside the block (in this thread) :func:`loss_from_logits` takes its
    labels and logits as this rank's block of the sequence over ``pg``
    (:class:`~..parallel.sharded.ShardedTrainStep` with ``seq_axis``);
    None leaves them whole."""
    token = _seq_shard.set(pg)
    try:
        yield
    finally:
        _seq_shard.reset(token)


@contextlib.contextmanager
def global_token_mean(reduce_count):
    """Inside the block (in this thread) :func:`loss_from_logits` divides
    by ``reduce_count(local count)`` (the count summed over the
    data-parallel ranks, :class:`~..parallel.sharded.ShardedTrainStep`);
    None leaves the local mean."""
    token = _token_count_reduce.set(reduce_count)
    try:
        yield
    finally:
        _token_count_reduce.reset(token)


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
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv = self.num_kv_heads * self.head_dim
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(h, h, bias_attr=False, **kw)
        self.k_proj = Linear(h, kv, bias_attr=False, **kw)
        self.v_proj = Linear(h, kv, bias_attr=False, **kw)
        self.o_proj = Linear(h, h, bias_attr=False, **kw)

    def forward(self, x, cos, sin, attn_mask=None,
                cache: Optional[Cache] = None, pos=0):
        """``cache=None``: causal self-attention over ``x`` alone (K/V heads
        repeated first, so autograd sums the repeated heads' gradients)
        through ``F.flash_attention``, or with ``attn_mask`` through
        ``F.scaled_dot_product_attention``; returns the output. With a
        cache: write-through at ``pos``, returns ``(output, new cache)``;
        a mask with a cache raises (reference :232-235). With
        ``config.context_parallel_axis`` (and no cache) ``x`` is this
        rank's block of the sequence under the active plan: rope at the
        block's global positions and attention through
        :func:`~..ops.kernels.ring_attention.ring_flash_attention`
        (reference :251-260); a mask raises there, as in the reference."""
        # heads and length from the projections: a tensor-parallel view
        # holds its rank's heads only (distributed.shard_plan), and under
        # Megatron sequence parallelism the projections gather the
        # sequence blocks of ``x``
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        b, s = q.shape[0], q.shape[1]
        q = q.reshape(b, s, -1, self.head_dim)
        k = k.reshape(b, s, -1, self.head_dim)
        v = v.reshape(b, s, -1, self.head_dim)
        if cache is not None and attn_mask is not None:
            raise NotImplementedError(
                "KV-cache decoding supports causal masking only; strip "
                "padding (or use dense attention) when passing caches")
        cp = getattr(self.config, "context_parallel_axis", None)
        if cache is None and cp is not None:
            return self.o_proj(self._context_parallel(q, k, v, cos, sin,
                                                      attn_mask, cp))
        q, k = _apply_rope(q, k, cos, sin, offset=pos)
        if cache is None:
            rep = q.shape[2] // k.shape[2]
            if rep > 1:
                k, v = amp_cast(None, k, v)
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            if attn_mask is not None:
                out = F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, is_causal=True)
            else:
                out, _ = F.flash_attention(q, k, v, causal=True)
            return self.o_proj(out.reshape(b, s, -1))
        out, kc, vc = _cached_attention(
            q, k, v, cache[0], cache[1], pos,
            q.shape[2] // k.shape[2], 1.0 / math.sqrt(self.head_dim))
        return self.o_proj(out.reshape(b, s, -1)), (kc, vc)

    def _context_parallel(self, q, k, v, cos, sin, attn_mask, axis):
        """Ring attention over ``axis``: in the SPMD form this rank holds
        the sequence block ``[r * s, (r + 1) * s)``, so rope starts there;
        in the one-process form ``x`` is the whole sequence. The K/V heads
        ride the ring un-repeated."""
        from ..ops.kernels.ring_attention import ring_flash_attention, ring_of

        if attn_mask is not None:
            raise NotImplementedError(
                "ring attention supports causal masking only; pad-free "
                "batches (or dense attention) are required under context "
                "parallelism")
        ring = ring_of(None, axis)
        offset = 0 if ring.local else ring.r * q.shape[1]
        q, k = _apply_rope(q, k, cos, sin, offset=offset)
        out = ring_flash_attention(q, k, v, sp_axis=axis, causal=True,
                                   data_axis=self.config.data_parallel_axis)
        return out.reshape(q.shape[0], q.shape[1], -1)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = Linear(h, i, bias_attr=False, **kw)
        self.up_proj = Linear(h, i, bias_attr=False, **kw)
        self.down_proj = Linear(i, h, bias_attr=False, **kw)

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

    def forward(self, x, cos, sin, attn_mask=None,
                cache: Optional[Cache] = None, pos=0):
        """Returns ``x`` without a cache, ``(x, new cache)`` with one."""
        if cache is None:
            x = x + self.self_attn(self.input_layernorm(x), cos, sin,
                                   attn_mask)
            return x + self.mlp(self.post_attention_layernorm(x))
        attn_out, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                             attn_mask, cache, pos)
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
                attn_mask: Optional[torch.Tensor] = None,
                caches: Optional[List[Cache]] = None, pos=None):
        """``caches=None``: causal attention over ``input_ids`` alone
        (flash attention; with ``attn_mask``, the masked plain route),
        returns the final hidden states; with ``config.recompute`` each
        layer runs under activation recompute. With caches: write-through
        at ``pos`` (scalar or per-row; None means 0), returns ``(hidden,
        caches)``. The reference's parameter order (:318)."""
        pos = 0 if pos is None else pos
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos, self.rope_sin
        if caches is None:
            if self.config.recompute:
                policy = self.config.remat_policy
                remat_policy(policy)            # a bad name raises here
                for layer in self.layers:
                    x = recompute(layer, x, cos, sin, attn_mask,
                                  policy=policy)
            else:
                for layer in self.layers:
                    x = layer(x, cos, sin, attn_mask)
            return self.norm(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, nc = layer(x, cos, sin, attn_mask, cache, pos)
            new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """Causal LM head over :class:`LlamaModel`.

    ``device=None`` builds on the card (raises without CUDA). Weights are
    drawn from a seeded generator on that device: N(0, ``init_std``) for
    every matrix, ones for the norms. Parity tests overwrite them with the
    JAX model's weights through :mod:`..convert`. On the card the flash
    kernels' support check runs here and raises on a configuration they do
    not take, unless the JAX package never sends it to a kernel either
    (a head dim its gate refuses, such as 96)."""

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
            # a head dim the JAX package's kernel gate refuses computes in
            # the plain version on the card too (F.flash_attention routes
            # it there), as the reference computes it with XLA
            if not ok and not routes_to_plain(config.head_dim, True, n, n):
                raise ValueError(f"flash attention kernels do not take this "
                                 f"model: {why}")
        self.model = LlamaModel(config, device=dev, dtype=dtype)
        self.lm_head = (None if config.tie_word_embeddings
                        else Linear(config.hidden_size, config.vocab_size,
                                    bias_attr=False, device=dev,
                                    dtype=dtype))
        self.reset_parameters(seed, init_std)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    def reset_parameters(self, seed: int = 0, init_std: float = 0.02) -> None:
        init_weights(self, seed, init_std)

    def _hidden(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Final hidden states of a causal forward over ``input_ids``."""
        return self.model(input_ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            # the reference's tied head is an unnamed op
            hidden, w = amp_cast(None, hidden, self.model.embed_tokens.weight)
            return torch.matmul(hidden, w.T)
        return self.lm_head(hidden)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[b, s, vocab]``, or with ``labels`` the next-token loss
        (reference :361-369, same parameter order). ``attn_mask`` (bool:
        True attends; float: added to the logits), broadcast to ``[b, h,
        s, s]``, applies on top of the causal mask."""
        logits = self.logits(self.model(input_ids, attn_mask))
        if labels is None:
            return logits
        return self.loss_from_logits(logits, labels)

    loss_from_logits = staticmethod(loss_from_logits)

    def _prompt(self, input_ids) -> np.ndarray:
        ids = (input_ids.detach().cpu().numpy()
               if isinstance(input_ids, torch.Tensor) else
               np.asarray(input_ids)).astype(np.int32)
        if ids.shape[1] >= self.config.max_position_embeddings:
            raise ValueError(
                f"prompt length {ids.shape[1]} exceeds "
                f"max_position_embeddings "
                f"{self.config.max_position_embeddings}; truncate the prompt")
        return ids

    @torch.no_grad()
    def generate_cached(self, input_ids, max_new_tokens=32, temperature=1.0,
                        top_k=0, eos_token_id=None, seed=0) -> torch.Tensor:
        """KV-cache decoding (reference :371-477): ONE prefill over the
        prompt, then single-position steps through ``_cached_attention``
        over contiguous caches ``[b, cache_len, kvh, hd]``, ``cache_len``
        the prompt + budget bucketed to 128 as in the reference. Sampling:
        greedy at ``temperature == 0``, else Gumbel-max over a generator on
        the model's device seeded with ``seed``, after the ``top_k`` filter.
        The loop stops when every row has emitted ``eos_token_id``; past a
        row's first eos its tokens read eos. Returns ``[b, prompt +
        new]`` int32 ids on the host.

        The reference runs its loop to a length bucketed to 64 and trims
        the result; this loop runs the tokens it returns, which are the
        same."""
        cfg = self.config
        ids = self._prompt(input_ids)
        b, prompt_len = ids.shape
        total = min(prompt_len + max_new_tokens,
                    cfg.max_position_embeddings)
        cache_len = min(-(-total // 128) * 128, cfg.max_position_embeddings)
        dev = self.device
        kvh, hd = cfg.num_key_value_heads, cfg.head_dim
        caches = [(torch.zeros((b, cache_len, kvh, hd), dtype=self.dtype,
                               device=dev),
                   torch.zeros((b, cache_len, kvh, hd), dtype=self.dtype,
                               device=dev))
                  for _ in range(cfg.num_hidden_layers)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        n_new = total - prompt_len
        out = torch.zeros((b, n_new), dtype=torch.int32, device=dev)
        toks = torch.as_tensor(ids, dtype=torch.long, device=dev)
        pos = 0
        finished = np.zeros((b,), bool)
        for i in range(n_new):
            hidden, caches = self.model(toks, caches=caches, pos=pos)
            nxt = _sample_next(self.logits(hidden[:, -1]).float(),
                               temperature, top_k, gen)
            out[:, i] = nxt
            pos += toks.shape[1]
            toks = nxt[:, None].long()
            if eos_token_id is not None:
                finished |= (nxt == eos_token_id).cpu().numpy()
                if finished.all():
                    break
        gen_ids = out.cpu().numpy()
        if eos_token_id is not None:
            hit = gen_ids == eos_token_id
            first = np.where(hit.any(1), hit.argmax(1), gen_ids.shape[1] - 1)
            posn = np.arange(gen_ids.shape[1])[None, :]
            gen_ids = np.where(posn > first[:, None], eos_token_id, gen_ids)
            gen_ids = gen_ids[:, : int(first.max()) + 1]
        return torch.from_numpy(
            np.concatenate([ids, gen_ids.astype(np.int32)], axis=1))

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0, top_k=0,
                 eos_token_id=None, seed=0) -> torch.Tensor:
        """Autoregressive decoding over a static buffer (reference
        :478-548): each token is one full causal forward over the
        ``[b, prompt + budget]`` buffer (``F.flash_attention``: the flash
        kernels on the card), reading the logits of the last filled
        position; the padded tail is inert under the causal mask. O(L^2)
        per sequence. Sampling as in :meth:`generate_cached`; after a row's
        first eos its tokens read eos. Returns int32 ids on the host. The
        GPT model runs this same loop over its own ``_hidden`` and
        :meth:`logits`, as the reference shares it."""
        ids = self._prompt(input_ids)
        b, prompt_len = ids.shape
        total = min(prompt_len + max_new_tokens,
                    self.config.max_position_embeddings)
        dev = self.device
        buf = torch.zeros((b, total), dtype=torch.long, device=dev)
        buf[:, :prompt_len] = torch.as_tensor(ids, dtype=torch.long,
                                              device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        finished = np.zeros((b,), bool)
        cur = prompt_len
        while cur < total:
            hidden = self._hidden(buf)
            nxt = _sample_next(self.logits(hidden[:, cur - 1]).float(),
                               temperature, top_k, gen)
            buf[:, cur] = nxt
            cur += 1
            if eos_token_id is not None:
                finished |= (nxt == eos_token_id).cpu().numpy()
                if finished.all():
                    break
        out = buf[:, :cur].cpu().numpy().astype(np.int32)
        if eos_token_id is not None:
            gen_ids = out[:, prompt_len:]
            hit = gen_ids == eos_token_id
            first = np.where(hit.any(1), hit.argmax(1), gen_ids.shape[1])
            posn = np.arange(gen_ids.shape[1])[None, :]
            gen_ids = np.where(posn > first[:, None], eos_token_id, gen_ids)
            out = np.concatenate([out[:, :prompt_len], gen_ids], axis=1)
        return torch.from_numpy(out)


def llama_sharding_rules(tp_axis="tp", fsdp_axis="fsdp"):
    """The reference's placement table (reference :575), verbatim:
    parameter-name regex -> spec axes. Every matmul weight is sharded on
    tp (column-parallel q/k/v, gate/up and the LM head on the out dim,
    row-parallel o/down on the in dim) and on fsdp on the other dim, the
    embedding's hidden dim on tp; norms replicated. Axes a mesh lacks fit
    away (:func:`~..parallel.sharded._fit_spec`)."""
    return [
        (r".*embed_tokens\.weight$", (fsdp_axis, tp_axis)),
        (r".*(q|k|v)_proj\.weight$", (fsdp_axis, tp_axis)),   # column-parallel
        (r".*o_proj\.weight$", (tp_axis, fsdp_axis)),          # row-parallel
        (r".*(gate|up)_proj\.weight$", (fsdp_axis, tp_axis)),  # column-parallel
        (r".*down_proj\.weight$", (tp_axis, fsdp_axis)),       # row-parallel
        (r".*lm_head\.weight$", (fsdp_axis, tp_axis)),
        (r".*", ()),                                           # norms etc. replicated
    ]


def _sample_next(row: torch.Tensor, temperature: float, top_k: int,
                 gen: torch.Generator) -> torch.Tensor:
    """One token per row of f32 logits ``row [b, V]``: the ``top_k`` filter
    (logits below the k-th largest set to -inf), then the first argmax at
    ``temperature == 0`` or a Gumbel-max draw at ``temperature`` from
    ``gen``. int32 ``[b]``."""
    if top_k and top_k > 0:
        kth = torch.topk(row, int(top_k), dim=-1).values[:, -1:]
        row = row.masked_fill(row < kth, float("-inf"))
    if temperature == 0.0:
        return row.argmax(dim=-1).to(torch.int32)
    u = torch.rand(row.shape, generator=gen, device=row.device)
    scaled = row / max(float(temperature), 1e-6)
    return (scaled - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)
