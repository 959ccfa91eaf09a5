"""GPT-style decoder LM: learned positions, pre-LN blocks, a GELU (tanh)
MLP and a head tied to the token embedding (counterpart of
``paddlepaddle_tpu/models/gpt.py``): ``GPTConfig`` (``gpt2_small()``,
``tiny()``), ``GPTAttention``, ``GPTBlock``, ``GPTModel`` and
``GPTForCausalLM``.

Attention is ``F.flash_attention(..., causal=True)``: at dropout 0 (or out
of training) the flash kernels on the card, kernel 2 forward and 3 / 4
backward at d = hidden / heads (64 for GPT-2 small); an attention dropout
in training computes in plain PyTorch, as the reference computes it
outside its kernel. The loss is ``LlamaForCausalLM.loss_from_logits`` and
``generate`` is ``LlamaForCausalLM.generate`` (a static buffer, one full
forward a token), as in the reference. ``config.dtype`` is not read, in the
reference either: cast with ``model.to(torch.bfloat16)``. ``device`` is
keyword-only (None: the card); layers draw their weights from the port's
stream for the device. The reference's ``gpt_sharding_rules`` waits for
A10."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..amp import amp_cast
from ..device import DeviceLike, resolve_device
from ..nn import functional as F
from ..nn.common import Dropout, Embedding, Linear
from ..nn.container import LayerList
from ..nn.norm import LayerNorm
from .llama import LlamaForCausalLM


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    dtype: str = "float32"

    @staticmethod
    def gpt2_small() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def tiny(vocab_size=128, hidden_size=32, layers=2, heads=4,
             max_len=64) -> "GPTConfig":
        return GPTConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         intermediate_size=hidden_size * 4,
                         max_position_embeddings=max_len,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv_proj = Linear(h, 3 * h, device=device)
        self.out_proj = Linear(h, h, device=device)
        self.attn_dropout_p = config.attention_probs_dropout_prob
        self.resid_dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        out, _ = F.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   causal=True, dropout=self.attn_dropout_p,
                                   training=self.training)
        return self.resid_dropout(self.out_proj(out.reshape(b, s, -1)))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = LayerNorm(h, epsilon=eps, device=device)
        self.attn = GPTAttention(config, device=device)
        self.ln_2 = LayerNorm(h, epsilon=eps, device=device)
        self.fc_in = Linear(h, config.intermediate_size, device=device)
        self.fc_out = Linear(config.intermediate_size, h, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = self.fc_out(F.gelu(self.fc_in(self.ln_2(x)), approximate=True))
        return x + self.dropout(h)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.wte = Embedding(config.vocab_size, config.hidden_size,
                             device=dev)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, device=dev)
        self.drop = Dropout(config.hidden_dropout_prob)
        self.h = LayerList([GPTBlock(config, device=dev)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, device=dev)

    def forward(self, input_ids):
        """Final hidden states ``[b, s, h]``; a sequence longer than
        ``max_position_embeddings`` raises ``ValueError``."""
        seq = input_ids.shape[1]
        if seq > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {seq} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings} (position table "
                f"gather would silently clamp)")
        pos = torch.arange(seq, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.h:
            x = blk(x)
        return self.ln_f(x)


def gpt_sharding_rules(tp_axis="tp", fsdp_axis="fsdp"):
    """The reference's placement table (reference :138), verbatim. The
    port's GPT runs under no plan in this slice (its tied head is refused
    under tensor parallelism, :meth:`~..distributed.shard_plan.
    ShardingPlan.shard_module`)."""
    return [
        (r".*wte\.weight$", (tp_axis, fsdp_axis)),
        (r".*wpe\.weight$", ()),
        (r".*qkv_proj\.weight$", (fsdp_axis, tp_axis)),
        (r".*out_proj\.weight$", (tp_axis, fsdp_axis)),
        (r".*fc_in\.weight$", (fsdp_axis, tp_axis)),
        (r".*fc_out\.weight$", (tp_axis, fsdp_axis)),
        (r".*", ()),
    ]


class GPTForCausalLM(nn.Module):
    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.transformer = GPTModel(config, device=dev)
        self.lm_head = (None if config.tie_word_embeddings
                        else Linear(config.hidden_size, config.vocab_size,
                                    bias_attr=False, device=dev))

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.weight.device

    def _hidden(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.transformer(input_ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            # the reference's tied head is an unnamed op
            hidden, w = amp_cast(None, hidden, self.transformer.wte.weight)
            return torch.matmul(hidden, w.T)
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None):
        """Logits ``[b, s, vocab]``, or with ``labels`` the next-token
        loss."""
        logits = self.logits(self.transformer(input_ids))
        if labels is None:
            return logits
        return LlamaForCausalLM.loss_from_logits(logits, labels)

    _prompt = LlamaForCausalLM._prompt
    generate = LlamaForCausalLM.generate
