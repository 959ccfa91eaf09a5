"""The model zoo's attention on the card (``cuda`` marker; skipped without
CUDA): kernels 2-4 at head dim 64, the BERT-base and GPT-2 small width,
against their plain versions, and BERT's routing (an unmasked eval forward
launches kernel 2 once a layer; a padding mask sends every layer to the
plain attention, as the reference sends it outside its kernel). No JAX
here, so the file runs on a card host without it:
``python -m pytest tests/test_torch_zoo_card.py -m cuda --noconftest``.

Tolerances: bf16 kernels against the plain version on the same bf16
inputs, 2e-2 absolute (P and dS rounded to bf16 before their products);
the BERT forward, card against the CPU's plain path in f32, 1e-4 of the
largest logit (12 layers of f32 sums in other orders).
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.core import random as trandom
from paddlepaddle_tpu_torch.models.bert import (BertConfig,
                                                BertForSequenceClassification)
from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) to run the CUDA kernels")


def _qkvo(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                 dtype=np.float32))
            .to("cuda", torch.bfloat16) for _ in range(4)]


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
def test_kernel_2_d64_noncausal_s128_matches_plain_on_card():
    """BERT-base's eval attention: b 8, s 128, 12 heads, d 64, full."""
    _need_card()
    q, k, v, _ = _qkvo(8, 128, 12, 64, 0)
    scale = 64 ** -0.5
    out, lse = fa.flash_fwd(q, k, v, False, scale)
    want, want_lse = fa.flash_attention_plain(q, k, v, False, scale)
    assert _err(out, want) <= 2e-2
    assert _err(lse, want_lse) <= 2e-2


@pytest.mark.cuda
def test_kernels_3_4_d64_causal_s1024_match_plain_on_card():
    """GPT-2 small's training attention: b 2, s 1024, 12 heads, d 64,
    causal; the backward pair against the plain version's one pass."""
    _need_card()
    q, k, v, do = _qkvo(2, 1024, 12, 64, 1)
    scale = 64 ** -0.5
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    wq, wk, wv = fa.flash_bwd_plain(q, k, v, do, lse, delta, True, scale)
    assert _err(out, fa.flash_attention_plain(q, k, v, True, scale)[0]) \
        <= 2e-2
    for got, want in ((dq, wq), (dk, wk), (dv, wv)):
        assert _err(got, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_bert_eval_forward_routes_on_card(masked):
    """BERT-base (12 layers, d 64) in eval, f32: kernel 2 launches 12 times
    without a mask and never with a padding mask; the card's logits equal
    the CPU's plain path within 1e-4 of the largest."""
    _need_card()
    cfg = BertConfig.base()
    trandom.seed(0)
    card = BertForSequenceClassification(cfg, device="cuda").eval()
    cpu = BertForSequenceClassification(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    mask = None
    if masked:
        mask = torch.ones(2, 128, dtype=torch.long)
        mask[1, 100:] = 0
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches)
    with torch.no_grad():
        got = card(ids.cuda(), None, None if mask is None else mask.cuda())
        torch.cuda.synchronize()
        moved = (fa.flash_fwd.launches - before[0],
                 fa.flash_bwd_dq.launches - before[1])
        want = cpu(ids, None, mask)
    assert moved == ((0, 0) if masked else (cfg.num_hidden_layers, 0))
    assert _err(got.cpu(), want) <= 1e-4 * float(want.abs().max())
