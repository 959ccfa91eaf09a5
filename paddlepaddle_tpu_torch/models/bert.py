"""BERT for sequence classification (counterpart of
``paddlepaddle_tpu/models/bert.py``, BASELINE config 1): ``BertConfig``
(``base()``, ``tiny()``), ``BertEmbeddings``, ``BertPooler``, ``BertModel``
and ``BertForSequenceClassification``.

The encoder is ``nn.TransformerEncoder`` over post-norm GELU (erf) layers.
Attention without a mask, out of training or at dropout 0, runs the flash
forward kernel on the card (kernel 2, d = hidden / heads, 64 for
BERT-base); an ``attention_mask`` ``[b, s]`` of 1 (attend) / 0 (padding)
becomes the additive f32 ``(1 - m) (-1e9)`` at ``[b, 1, 1, s]`` and routes
to the plain attention, as does the attention dropout in training.
``device`` is keyword-only (None: the card); layers draw their weights from
the port's stream for the device, and ``convert.load_jax_state`` carries a
JAX model's weights across name for name."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..nn import functional as F
from ..nn.common import Dropout, Embedding, Linear
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    num_labels: int = 2

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(vocab_size=128, hidden_size=32, layers=2, heads=2) -> "BertConfig":
        return BertConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                          num_hidden_layers=layers, num_attention_heads=heads,
                          intermediate_size=hidden_size * 4,
                          max_position_embeddings=64)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, device=device)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, device=device)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               device=device)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        """Word + position (+ token type: row 0 of its table without
        ``token_type_ids``) embeddings, layer norm, dropout."""
        seq = input_ids.shape[1]
        pos = torch.arange(seq, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        else:
            x = x + self.token_type_embeddings.weight[0]
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.embeddings = BertEmbeddings(config, device=dev)
        self.encoder = TransformerEncoder(
            TransformerEncoderLayer(
                d_model=config.hidden_size,
                nhead=config.num_attention_heads,
                dim_feedforward=config.intermediate_size,
                dropout=config.hidden_dropout_prob,
                activation="gelu",
                attn_dropout=config.attention_probs_dropout_prob,
                normalize_before=False, device=dev),
            config.num_hidden_layers)
        self.pooler = BertPooler(config, device=dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``(hidden [b, s, h], pooled [b, h])``."""
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            attention_mask = (1.0 - attention_mask[:, None, None, :].float()) \
                * -1e9
        x = self.encoder(x, src_mask=attention_mask)
        return x, self.pooler(x)


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device=dev)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, config.num_labels,
                                 device=dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        """Logits ``[b, num_labels]``, or with ``labels`` the mean cross
        entropy (``F.cross_entropy``)."""
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels)
