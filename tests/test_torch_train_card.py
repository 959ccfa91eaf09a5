"""Training beyond the defaults on the card (``cuda`` marker; skipped
without CUDA): activation recompute launches the flash forward twice a
layer a step under every policy and the backward pair once, with the same
loss and gradients as without; an fp16 AMP step sends fp16 to the flash
kernels (their counters move: no plain fallback) and GradScaler steps it.
No JAX here, so the file runs on a card host without it:
``python -m pytest tests/test_torch_train_card.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch import amp
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
from paddlepaddle_tpu_torch.optimizer import AdamW

CFG = dict(vocab_size=128, hidden_size=256, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
           max_position_embeddings=64)


def _counts():
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches)


def _ids(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 128, (3, 16))).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_recompute_launches_kernel_2_twice_a_layer_on_card(policy):
    """A recomputed step launches the flash forward twice a layer (the
    forward and the recompute; no policy caches it) and the backward pair
    once, with the loss and gradients of the step without recompute to the
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) to run the CUDA kernels")
    plain = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=1)
    remat = LlamaForCausalLM(LlamaConfig(**CFG, recompute=True,
                                         remat_policy=policy),
                             device="cuda", seed=1)
    ids = _ids(3)
    counts, losses = [], []
    for m in (plain, remat):
        before = _counts()
        loss = m(ids, ids)
        loss.backward()
        torch.cuda.synchronize()
        losses.append(loss.detach())
        counts.append(tuple(a - b for a, b in zip(_counts(), before)))
    L = CFG["num_hidden_layers"]
    assert counts == [(L, L, L), (2 * L, L, L)], counts
    assert torch.equal(losses[0], losses[1])
    for (n, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), n


@pytest.mark.cuda
def test_fp16_amp_step_launches_the_fp16_kernels_on_card():
    """An fp16 O1 step of an f32 model: every flash counter moves once a
    layer, the loss is finite and the scaler steps the optimizer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) to run the CUDA kernels")
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=2)
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    ids = _ids(4)
    before = _counts()
    w = model.lm_head.weight.detach().clone()
    with amp.auto_cast(level="O1", dtype="float16"):
        loss = model(ids, ids)
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    torch.cuda.synchronize()
    L = CFG["num_hidden_layers"]
    assert tuple(a - b for a, b in zip(_counts(), before)) == (L, L, L)
    assert torch.isfinite(loss) and not scaler._found_inf
    assert not torch.equal(model.lm_head.weight, w)
