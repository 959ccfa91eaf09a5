"""Port serving path (paddlepaddle_tpu_torch/inference/) on the CPU against the
JAX reference engine ``BatchDecodeEngine(..., fused_kernels=False)``.

The workload is the fixed ragged one of tests/test_fused_kernels.py
(prompts 5/17/3/40, budgets 8/4/10/6, one eos) with max_slots=3, chunk=4,
page_size=16, so admission happens mid-flight. At fp32 greedy the two
engines must emit the same tokens.
"""

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.inference.decode_engine import \
    BatchDecodeEngine as JaxEngine
from paddlepaddle_tpu.inference.serving import \
    GenerationRequest as JaxRequest
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.robustness import (
    KVCapacityError,
    RequestValidationError,
)
from paddlepaddle_tpu_torch.inference.serving import (
    GenerationRequest,
    ServingEngine,
)
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96, dtype="float32")
SPECS = [(5, 8, None), (17, 4, None), (3, 10, 7), (40, 6, None)]
ENGINE = dict(max_slots=3, chunk=4, page_size=16)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (n,)).astype(np.int32) for n, _, _ in SPECS]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    convert.load_jax_state(
        tm, {k: np.asarray(v) for k, v in jm.functional_state().items()})
    return jm, tm


def _port_serve(tm, prompts, **kw):
    eng = BatchDecodeEngine(tm, device="cpu", **dict(ENGINE, **kw))
    reqs = [GenerationRequest(p, mx, 0.0, 0, e)
            for p, (_, mx, e) in zip(prompts, SPECS)]
    eng.serve(reqs, timeout=120)
    return eng, [r.result.result(5) for r in reqs]


def test_greedy_token_exact_vs_jax_reference_engine(models):
    jm, tm = models
    prompts = _prompts()
    jeng = JaxEngine(jm, fused_kernels=False, **ENGINE)
    jreqs = [JaxRequest(p, mx, 0.0, 0, e)
             for p, (_, mx, e) in zip(prompts, SPECS)]
    jeng.serve(jreqs, timeout=240)
    want = [np.asarray(r.result.result(5)) for r in jreqs]
    before = pa.paged_attention.launches
    eng, got = _port_serve(tm, prompts)
    assert pa.paged_attention.launches == before    # CPU: plain version
    assert eng.kernel == "plain"
    for g, w, p, (_, mx, e) in zip(got, want, prompts, SPECS):
        np.testing.assert_array_equal(g, w)
        assert g[: len(p)].tolist() == p.tolist()
        n_new = len(g) - len(p)
        assert 1 <= n_new <= mx
        if n_new < mx:
            assert e is not None and g[-1] == e
    # mid-flight admission really happened: 4 requests over 3 slots
    assert eng.stats["requests"] == 4 and eng.stats["peak_busy"] == 3


def test_pages_returned_after_serving(models):
    _, tm = models
    eng, _ = _port_serve(tm, _prompts(1))
    assert eng.pool.free_count == eng.pool.usable
    assert eng.pool.peak_used > 0
    assert int(eng.page_table.abs().sum()) == 0
    assert eng.busy_slots() == 0


def test_serving_engine_matches_direct_engine(models):
    _, tm = models
    prompts = _prompts(2)
    _, direct = _port_serve(tm, prompts)
    with ServingEngine(tm, max_batch_size=3, kv_page_size=16,
                       decode_chunk=4, device="cpu") as se:
        futs = [se.submit(p, max_new_tokens=mx, eos_token_id=e)
                for p, (_, mx, e) in zip(prompts, SPECS)]
        outs = [f.result(60) for f in futs]
        for f in futs:
            s = f.slo()
            assert s["ttft_s"] is not None and s["ttft_s"] > 0
    for a, b in zip(outs, direct):
        np.testing.assert_array_equal(a, b)
    assert se.engine.pool.free_count == se.engine.pool.usable


def test_kv_capacity_error_at_submit(models):
    _, tm = models
    se = ServingEngine(tm, max_batch_size=2, kv_page_size=16, kv_num_pages=4,
                       decode_chunk=4, device="cpu")
    try:
        with pytest.raises(KVCapacityError) as ei:
            se.submit(np.arange(40), max_new_tokens=20)   # 4 pages > 3
        assert ei.value.pages_needed == 4 and ei.value.pages_capacity == 3
        assert se.stats["shed"] == 1
        with pytest.raises(RequestValidationError):
            se.submit(np.arange(90), max_new_tokens=10)   # > max_len 96
        with pytest.raises(RequestValidationError):
            se.submit(np.arange(4), max_new_tokens=2, top_k=500)
        out = se.generate(np.arange(10), max_new_tokens=5, timeout=60)
        assert len(out) == 15
    finally:
        se.stop()


@pytest.mark.parametrize("kwargs,item", [
    (dict(kv_layout="contiguous"), "A4.2"),
    (dict(quant="weight_only_int8"), "A4.3"),
    (dict(kv_quant="int8"), "A4.4"),
    (dict(kv_host_bytes=1 << 20), "A4.4"),
    (dict(spec_k=2, draft=object()), "A4.5"),
    (dict(mode="static"), "A4.6"),
    (dict(default_deadline_s=1.0), "A4.6"),
    (dict(decode_timeout_s=1.0), "A4.6"),
    (dict(drain_on_sigterm=True), "A4.6"),
    (dict(bundle="x.bundle"), "A6"),
    (dict(mesh=object()), "A10"),
])
def test_unported_options_raise(models, kwargs, item):
    _, tm = models
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(tm, device="cpu", **kwargs)


def test_unported_submit_options_raise(models):
    _, tm = models
    se = ServingEngine(tm, max_batch_size=2, kv_page_size=16, device="cpu")
    with pytest.raises(NotImplementedError, match="A4.1"):
        se.submit(np.arange(40), max_new_tokens=4, prefix_len=32)
    with pytest.raises(NotImplementedError, match="A4.6"):
        se.submit(np.arange(4), max_new_tokens=4, deadline_s=1.0)
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="A4.1"):
        eng._admit(GenerationRequest(np.arange(40), 4, prefix_len=32))
    assert eng.pool.free_count == eng.pool.usable
    se.stop()


def test_sampled_tokens_inside_top_k(models):
    _, tm = models
    prompt = _prompts(3)[1]
    k = 5
    eng = BatchDecodeEngine(tm, device="cpu", seed=11, **ENGINE)
    reqs = [GenerationRequest(prompt, 12, temperature=0.8, top_k=k)
            for _ in range(3)]
    eng.serve(reqs, timeout=60)
    outs = [r.result.result(5) for r in reqs]
    for out in outs:
        assert len(out) == len(prompt) + 12
        with torch.no_grad():
            logits = tm(torch.from_numpy(out[None, :-1].astype(np.int64)))[0]
        for i in range(len(prompt), len(out)):
            top = torch.topk(logits[i - 1], k).indices.tolist()
            assert int(out[i]) in top
    # three draws from one generator do not all coincide
    assert len({tuple(o.tolist()) for o in outs}) > 1


def test_release_slot_mid_flight_returns_pages(models):
    _, tm = models
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    reqs = [GenerationRequest(p, 20) for p in _prompts(4)[:2]]
    assert eng._admit(reqs[0]) and eng._admit(reqs[1])
    eng._decode_chunk()
    slot = next(i for i, s in enumerate(eng._host_slots) if s.req is reqs[0])
    held = len(eng._slot_pages[slot])
    free0 = eng.pool.free_count
    eng.release_slot(slot)
    assert eng.pool.free_count == free0 + held
    assert not bool(eng.active[slot]) and int(eng.page_table[slot].sum()) == 0
    eng.serve([], timeout=60)                   # the other request finishes
    assert len(reqs[1].result.result(5)) == len(reqs[1].prompt_ids[0]) + 20
    assert not reqs[0].result.done()            # the caller owns its future
    assert eng.pool.free_count == eng.pool.usable
