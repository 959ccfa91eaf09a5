"""MoE decoder LM, DeepSeekMoE / Qwen2-MoE style (counterpart of
``paddlepaddle_tpu/models/moe.py``).

The Llama attention stack with the dense MLP replaced by
:class:`~..parallel.moe.MoELayer` and an optional shared expert (DeepSeekMoE's
always-on expert, a ``LlamaMLP`` of width ``num_shared_experts *
intermediate_size``). The module tree and parameter names are the
reference's, so ``convert.load_jax_state`` carries its weights across.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.dtype import to_torch_dtype
from ..device import DeviceLike, resolve_device
from ..nn.common import Embedding, Linear
from ..nn.norm import RMSNorm
from ..ops.kernels._build import check_device
from ..ops.kernels.flash_attention import flash_attention_supported
from ..parallel.moe import GShardGate, MoELayer, SwitchGate
from .llama import (LlamaAttention, LlamaConfig, LlamaMLP, init_weights,
                    loss_from_logits, rope_tables)


@dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 1408      # per-expert FFN width
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 64
    num_experts_per_tok: int = 2
    num_shared_experts: int = 0        # shared expert width multiplier
    capacity_factor: float = 1.25
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    aux_loss_weight: float = 0.01
    dtype: str = "float32"
    # "sorted" | "dropless" | "einsum" | "fused" (the gather-GEMM kernel on
    # the card): see parallel.moe.MoELayer
    dispatch_mode: str = "sorted"

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            dtype=self.dtype)

    @staticmethod
    def tiny(vocab_size=128, hidden_size=32, layers=2, heads=4, experts=4,
             topk=2, max_len=64) -> "MoEConfig":
        return MoEConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=hidden_size * 2,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         num_key_value_heads=heads, num_experts=experts,
                         num_experts_per_tok=topk,
                         max_position_embeddings=max_len)


class MoEDecoderLayer(nn.Module):
    def __init__(self, config: MoEConfig, *, device, dtype):
        super().__init__()
        lcfg = config.as_llama()
        kw = dict(device=device, dtype=dtype)
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, **kw)
        self.self_attn = LlamaAttention(lcfg, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, **kw)
        gate_cls = SwitchGate if config.num_experts_per_tok == 1 else GShardGate
        self.mlp = MoELayer(
            config.hidden_size, config.intermediate_size, config.num_experts,
            gate=gate_cls(config.hidden_size, config.num_experts, **kw),
            capacity_factor=config.capacity_factor,
            dispatch_mode=config.dispatch_mode, **kw)
        self.shared_mlp = None
        if config.num_shared_experts > 0:
            self.shared_mlp = LlamaMLP(dataclasses.replace(
                lcfg, intermediate_size=config.intermediate_size
                * config.num_shared_experts), **kw)

    def forward(self, x, cos, sin, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        h = self.post_attention_layernorm(x)
        y = self.mlp(h)
        if self.shared_mlp is not None:
            y = y + self.shared_mlp(h)
        return x + y


class MoEForCausalLM(nn.Module):
    """The MoE causal LM (reference :99).

    ``device=None`` builds on the card (raises without CUDA). Weights are
    drawn from a seeded generator on that device: N(0, ``init_std``) for
    every matrix and expert bank, ones for the norms; parity tests
    overwrite them with the JAX model's through :mod:`..convert`. On the
    card the flash kernels' support check runs here, and with
    ``dispatch_mode="fused"`` each layer's gather-GEMM check too; either
    raises on a configuration its kernel does not take. The rope tables are
    f32, non-persistent buffers at the root, as in the reference."""

    def __init__(self, config: MoEConfig, device: DeviceLike = None,
                 seed: int = 0, init_std: float = 0.02):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = to_torch_dtype(config.dtype)
        head_dim = config.hidden_size // config.num_attention_heads
        if dev.type == "cuda":
            check_device(dev)
            n = config.max_position_embeddings
            ok, why = flash_attention_supported(head_dim, dtype, True, n, n)
            if not ok:
                raise ValueError(f"flash attention kernels do not take this "
                                 f"model: {why}")
        kw = dict(device=dev, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList([MoEDecoderLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, **kw)
        cos, sin = rope_tables(head_dim, config.max_position_embeddings,
                               config.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        init_weights(self, seed, init_std)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[b, s, vocab]``, or with ``labels`` the next-token loss
        plus ``aux_loss_weight`` times each layer's load-balance loss
        (reference :117-129). ``attn_mask`` takes the masked attention
        route of the Llama layers (plain PyTorch, no flash launch). Under
        a data-parallel plan each rank adds its ``aux_share`` of the global
        load-balance loss, so the term counts once in the summed loss."""
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, self.rope_cos, self.rope_sin, attn_mask)
        logits = self.lm_head(self.norm(x))
        if labels is None:
            return logits
        loss = loss_from_logits(logits, labels)
        if self.config.aux_loss_weight:
            for layer in self.layers:
                if layer.mlp.l_aux is not None:
                    loss = loss + (self.config.aux_loss_weight
                                   * layer.mlp.l_aux * layer.mlp.aux_share)
        return loss
