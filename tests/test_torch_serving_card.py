"""The serving engine's kernel-free routes on the card (``cuda`` marker;
skipped without CUDA): ``fused_kernels=False`` (the paged kernel's plain
version, over bf16 or int8 pages) and ``kv_layout="contiguous"`` (the
model's cached attention) serve the fixed ragged workload of
``tests/test_torch_serving.py`` greedy-equal to the CPU engine in f32, and
the paged kernel's counters do not move. No JAX here, so the file runs on a
card host without it:
``python -m pytest tests/test_torch_serving_card.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import GenerationRequest
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96, dtype="float32")
SPECS = [(5, 8, None), (17, 4, None), (3, 10, 7), (40, 6, None)]
ENGINE = dict(max_slots=3, chunk=4, page_size=16)


def _serve(model, device, **kw):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32)
               for n, _, _ in SPECS]
    eng = BatchDecodeEngine(model, device=device, **dict(ENGINE, **kw))
    reqs = [GenerationRequest(p, mx, 0.0, 0, e)
            for p, (_, mx, e) in zip(prompts, SPECS)]
    eng.serve(reqs, timeout=240)
    return eng, [r.result.result(5) for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(fused_kernels=False),
                                dict(fused_kernels=False, kv_quant="int8"),
                                dict(kv_layout="contiguous")],
                         ids=["plain", "plain_int8", "contiguous"])
def test_plain_and_contiguous_on_card_equal_cpu(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_m = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=3,
                             init_std=0.1)
    card_m = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=3,
                              init_std=0.1)
    card_m.load_state_dict(cpu_m.state_dict())
    _, want = _serve(cpu_m, "cpu", **kw)
    n0, q0 = pa.paged_attention.launches, pa.paged_attention.int8_launches
    eng, got = _serve(card_m, "cuda", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pa.paged_attention.launches == n0
    assert pa.paged_attention.int8_launches == q0
    assert eng.kernel == "plain" and eng.capture_info()
