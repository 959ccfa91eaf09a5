"""The port's serving options beyond the paged default, on the CPU against
the JAX package: the reference's positional order of both engines,
``SpeculativeDecoder`` and ``submit`` (C8); ``fused_kernels=False``; the
contiguous KV layout; ``ServingEngine(mode="static")``; and the model's
``generate_cached`` / ``generate``. Greedy tokens are the oracle, exact at
f32 on the fixed ragged workload of ``tests/test_torch_serving.py``. The
same options on the card: ``tests/test_torch_serving_card.py``.
"""

import inspect

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.inference import speculative as jspec
from paddlepaddle_tpu.inference.decode_engine import \
    BatchDecodeEngine as JaxEngine
from paddlepaddle_tpu.inference.serving import \
    GenerationRequest as JaxRequest
from paddlepaddle_tpu.inference.serving import ServingEngine as JaxServing
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.inference import speculative as tspec
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import (
    GenerationRequest,
    ServingEngine,
)
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.observability.reqtrace import Journey
from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96, dtype="float32")
SPECS = [(5, 8, None), (17, 4, None), (3, 10, 7), (40, 6, None)]
ENGINE = dict(max_slots=3, chunk=4, page_size=16)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    convert.load_jax_state(
        tm, {k: np.asarray(v) for k, v in jm.functional_state().items()})
    return jm, tm


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (n,)).astype(np.int32) for n, _, _ in SPECS]


def _jax_tokens(jm, prompts, **kw):
    eng = JaxEngine(jm, **dict(dict(ENGINE, fused_kernels=False), **kw))
    reqs = [JaxRequest(p, mx, 0.0, 0, e)
            for p, (_, mx, e) in zip(prompts, SPECS)]
    eng.serve(reqs, timeout=240)
    return eng, [np.asarray(r.result.result(5)) for r in reqs]


def _port_tokens(tm, prompts, **kw):
    eng = BatchDecodeEngine(tm, device="cpu", **dict(ENGINE, **kw))
    reqs = [GenerationRequest(p, mx, 0.0, 0, e)
            for p, (_, mx, e) in zip(prompts, SPECS)]
    eng.serve(reqs, timeout=240)
    return eng, [r.result.result(5) for r in reqs]


# -- C8: the reference's positional order -----------------------------------

def _params(fn, drop=("self",)):
    return [n for n in inspect.signature(fn).parameters if n not in drop]


@pytest.mark.parametrize("port,ref", [
    (BatchDecodeEngine.__init__, JaxEngine.__init__),
    (ServingEngine.__init__, JaxServing.__init__),
    (tspec.SpeculativeDecoder.__init__, jspec.SpeculativeDecoder.__init__),
    (ServingEngine.submit, JaxServing.submit),
])
def test_signatures_keep_reference_order(port, ref):
    sig = inspect.signature(port)
    assert _params(port, drop=("self", "device", "seed")) == _params(ref)
    for extra in ("device", "seed"):
        if extra in sig.parameters:
            assert sig.parameters[extra].kind \
                == inspect.Parameter.KEYWORD_ONLY


def test_reference_order_positional_engine_calls_bind_alike(models):
    jm, tm = models
    # the reference builds this; the port used to read -1 as kv_layout
    eng = BatchDecodeEngine(tm, 4, 64, 4, None, -1, "paged", device="cpu")
    assert eng.kv_layout == "paged" and eng.quant is None
    args = (3, 96, 4, "weight_only_int8", 16, "paged", 16, None, True,
            None, None, None, None, 0, None, None, "int8", 1 << 20)
    j = JaxEngine(jm, *args)
    t = BatchDecodeEngine(tm, *args, device="cpu")
    for name in ("S", "L", "chunk", "quant", "kv_layout", "page_size",
                 "prefix_enabled", "kv_quant", "quant_meta"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.kv_host.max_bytes == j.kv_host.max_bytes
    # fused_kernels=None then kv_quant="int8" by position (C8's second case)
    t2 = BatchDecodeEngine(tm, 2, 96, 4, None, -1, "paged", 16, None, True,
                           None, None, None, None, 0, None, None, "int8",
                           device="cpu")
    assert t2.kv_quant == "int8" and t2.kv_host is None
    # the serving engine: quant_group_size after quant, fused_kernels after
    # draft_quant
    sargs = (3, 5.0, "continuous", 96, 4, None, None, None, None, None,
             None, None, False, "weight_only_int8", 16, "paged", 16, None,
             True, None, None, None, None, 0, None, False, "int8", None)
    se = ServingEngine(tm, *sargs, device="cpu")
    js = JaxServing(jm, *sargs)
    try:
        assert se.engine.quant_meta == js._engine.quant_meta
        assert se.engine.kv_quant == js._engine.kv_quant == "int8"
        assert se.engine.fused == {"enabled": False,
                                   "paged_attention": "off"}
    finally:
        se.stop()
        js.stop()


def test_speculative_decoder_and_submit_positional(models):
    jm, tm = models
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    dec = tspec.SpeculativeDecoder(eng, tm, 2, "weight_only_int8")
    assert dec.k == 2 and dec.draft_quant == "weight_only_int8"
    assert dec.draft_quant_meta["quantized"]
    with pytest.raises(TypeError):
        tspec.SpeculativeDecoder(eng, tm, 2, None, 7)   # seed is keyword
    p = _prompts(1)[1]
    with ServingEngine(tm, max_batch_size=2, kv_page_size=16,
                       device="cpu") as se:
        # ..., eos_token_id, deadline_s, prefix_len, trace
        out = se.submit(p, 4, 0.0, 0, None, None, 16, None).result(60)
        assert len(out) == len(p) + 4
        # a caller's journey (the reference's router passes one) rides the
        # request; the caller owns it, so the future does not close it
        j = Journey(req_id="caller", max_spans=64)
        out = se.submit(p, 4, 0.0, 0, None, None, 16, j).result(60)
        assert len(out) == len(p) + 4
        names = [sp["name"] for sp in j.spans]
        assert names[:3] == ["engine.submit", "queue.wait", "admit"]
        assert not j.done
        assert se.engine.pool.free_count >= se.engine.pool.usable - 1


# -- fused_kernels ---------------------------------------------------------------

def test_fused_kernels_false_decodes_through_plain_version(models):
    jm, tm = models
    prompts = _prompts(2)
    _, want = _jax_tokens(jm, prompts)
    before = pa.paged_attention.launches
    eng, got = _port_tokens(tm, prompts, fused_kernels=False)
    assert eng._attend is pa.paged_attention_plain
    assert eng.fused_info() == {"enabled": False, "paged_attention": "off"}
    assert pa.paged_attention.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for fk in (None, True):
        e = BatchDecodeEngine(tm, device="cpu", fused_kernels=fk, **ENGINE)
        assert e._attend is pa.paged_attention and e.fused["enabled"]


# -- contiguous layout -------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(quant="weight_only_int8"),
                                dict(chunk=8)],
                         ids=["bf", "quant", "chunk8"])
def test_contiguous_token_exact_vs_jax(models, kw):
    jm, tm = models
    prompts = _prompts(3)
    kw = dict(kw, kv_layout="contiguous")
    jeng, want = _jax_tokens(jm, prompts, **kw)
    eng, got = _port_tokens(tm, prompts, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.kv_stats() == jeng.kv_stats() == {
        "layout": "contiguous",
        "kv_bytes": 3 * 96 * 2 * 2 * 16 * 4 * 2}
    assert eng.pool is None and eng.page_table is None
    assert eng._decode_key == "decode_contig"
    assert eng.stats["requests"] == 4 and eng.stats["peak_busy"] == 3


def test_contiguous_equals_paged_and_refusals(models):
    jm, tm = models
    prompts = _prompts(4)
    _, paged = _port_tokens(tm, prompts)
    eng, contig = _port_tokens(tm, prompts, kv_layout="contiguous",
                               fused_kernels=True)
    for a, b in zip(paged, contig):
        np.testing.assert_array_equal(a, b)
    jeng = JaxEngine(jm, kv_layout="contiguous", fused_kernels=True,
                     **ENGINE)
    assert eng.fused_info() == jeng.fused_info()
    for m, make in ((jm, JaxEngine),
                    (tm, lambda m, **k: BatchDecodeEngine(m, device="cpu",
                                                          **k))):
        with pytest.raises(ValueError, match="paged"):
            make(m, kv_layout="contiguous", kv_quant="int8")
        with pytest.raises(ValueError, match="paged"):
            make(m, kv_layout="contiguous", draft=m, spec_k=2)
        with pytest.raises(ValueError, match="kv_layout"):
            make(m, kv_layout="ring")


def test_serving_engine_contiguous(models):
    _, tm = models
    prompts = _prompts(5)
    _, direct = _port_tokens(tm, prompts, kv_layout="contiguous")
    with ServingEngine(tm, max_batch_size=3, decode_chunk=4,
                       kv_layout="contiguous", device="cpu") as se:
        assert se._kv_capacity is None
        # prefix_len is ignored by the contiguous layout
        futs = [se.submit(p, max_new_tokens=mx, eos_token_id=e,
                          prefix_len=min(len(p), 16))
                for p, (_, mx, e) in zip(prompts, SPECS)]
        outs = [f.result(60) for f in futs]
        h = se.health()
        assert h["kv"]["layout"] == "contiguous" and h["pages_free"] is None
    for a, b in zip(outs, direct):
        np.testing.assert_array_equal(a, b)


def test_slot_release_keeps_storage(models):
    """A captured chunk replays over fixed addresses: releasing one slot
    and resetting all of them write the slot state, the page table and
    the pools in place, under both layouts."""
    _, tm = models
    for layout in ("paged", "contiguous"):
        eng = BatchDecodeEngine(tm, device="cpu", kv_layout=layout, **ENGINE)

        def ptrs():
            names = ["tokens", "lens", "active", "budgets", "temps",
                     "top_ks", "eos_ids", "packed"]
            if layout == "paged":
                names.append("page_table")
            out = {n: getattr(eng, n).data_ptr() for n in names}
            out.update({f"kv{i}": c.data_ptr() for i, c in
                        enumerate(t for kv in eng.caches for t in kv)})
            return out

        before = ptrs()
        reqs = [GenerationRequest(p, 20) for p in _prompts(6)[:3]]
        for r in reqs:
            assert eng._admit(r)
        eng._decode_chunk()
        eng.release_slot(1, reason="deadline")
        assert not bool(eng.active[1]) and eng._host_slots[1].req is None
        eng._decode_chunk()
        eng.reset_slots()
        assert not bool(eng.active.any())
        assert ptrs() == before
        if layout == "paged":
            assert eng.pool.free_count == eng.pool.usable


# -- static mode and the model's loops ---------------------------------------------

@pytest.mark.parametrize("eos", [None, 9])
@pytest.mark.parametrize("fn", ["generate_cached", "generate"])
def test_generate_loops_token_exact_vs_jax(models, fn, eos):
    jm, tm = models
    ids = np.random.default_rng(7).integers(0, 128, (3, 11)).astype(np.int32)
    want = np.asarray(getattr(jm, fn)(paddle.to_tensor(ids),
                                      max_new_tokens=14, temperature=0.0,
                                      top_k=5, eos_token_id=eos).numpy())
    got = getattr(tm, fn)(ids, max_new_tokens=14, temperature=0.0, top_k=5,
                          eos_token_id=eos)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_loops_agree_and_sample_from_the_seed(models):
    _, tm = models
    ids = np.random.default_rng(8).integers(0, 128, (2, 6)).astype(np.int32)
    a = tm.generate(ids, max_new_tokens=10, temperature=0.0)
    b = tm.generate_cached(ids, max_new_tokens=10, temperature=0.0)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    s1 = tm.generate_cached(ids, max_new_tokens=10, temperature=0.9,
                            top_k=4, seed=3)
    s2 = tm.generate_cached(ids, max_new_tokens=10, temperature=0.9,
                            top_k=4, seed=3)
    torch.testing.assert_close(s1, s2, atol=0, rtol=0)
    with torch.no_grad():
        logits = tm(s1[:, :-1].long())
    for r in range(2):
        for i in range(6, 16):
            top = torch.topk(logits[r, i - 1], 4).indices.tolist()
            assert int(s1[r, i]) in top
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate_cached(np.zeros((1, 96), np.int32))


def test_static_mode_token_exact_vs_jax_static(models):
    jm, tm = models
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 128, (12,)).astype(np.int32)
               for _ in range(3)] + [rng.integers(0, 128, (5,))
                                     .astype(np.int32)]
    budgets = [6, 9, 4, 7]

    def run(se):
        futs = [se.submit(p, max_new_tokens=b) for p, b in
                zip(prompts, budgets)]
        outs = [np.asarray(f.result(120)) for f in futs]
        return futs, outs

    js = JaxServing(jm, mode="static", max_batch_size=4, max_wait_ms=200)
    try:
        _, want = run(js)
    finally:
        js.stop()
    with ServingEngine(tm, mode="static", max_batch_size=4,
                       max_wait_ms=200) as se:
        assert se.engine is None
        futs, got = run(se)
        h = se.health()
        assert h["mode"] == "static" and h["kv"] == {"layout": "none"}
        assert se.stats["batches"] == 2            # two prompt lengths
    for g, w, p, b in zip(got, want, prompts, budgets):
        np.testing.assert_array_equal(g, w)
        assert len(g) == len(p) + b
    for f in futs:
        s = f.slo()
        assert s["tpot_s"] is None and s["ttft_s"] is not None
        assert s["ttft_s"] <= s["latency_s"]


def test_static_mode_equals_continuous(models):
    _, tm = models
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 128, (16,)).astype(np.int32)
               for _ in range(3)]
    with ServingEngine(tm, mode="static", max_batch_size=3,
                       max_wait_ms=200) as se:
        static = [f.result(120) for f in
                  [se.submit(p, max_new_tokens=8) for p in prompts]]
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    reqs = [GenerationRequest(p, 8) for p in prompts]
    eng.serve(reqs, timeout=120)
    for a, r in zip(static, reqs):
        np.testing.assert_array_equal(a, r.result.result(5))


def test_static_mode_refusals_match_reference(models):
    jm, tm = models
    for kw in (dict(kv_quant="int8"), dict(kv_host_bytes=1 << 20),
               dict(draft="self", spec_k=2), dict(bundle="x.bundle"),
               dict(quant="weight_only_int8"), dict(mesh=object()),
               dict(plan=object())):
        for m, ctor in ((jm, JaxServing), (tm, ServingEngine)):
            k = dict(kw, draft=m) if kw.get("draft") == "self" else kw
            with pytest.raises(ValueError, match="continuous"):
                ctor(m, mode="static", **k)
