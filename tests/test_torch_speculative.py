"""Speculative decoding in the port (``inference/speculative.py`` and the
engine's spec chunk) and the decode engine's captured programs.

On the CPU, against the JAX engine ``BatchDecodeEngine(draft=...,
spec_k=k)`` on its reference path (``fused_kernels=False``): the same fp32
weights carried by ``convert.py``, the same requests (ragged prompts and
budgets, one eos request, a shared-prefix pair at page size 16), and equal
tokens, accepted counts and accepted-run-length histograms for k = 1..3,
with the target itself as the draft (every proposal accepted), a noisy copy
of the target (partial acceptance) and an independent small draft (nearly
every proposal rejected). Tokens are exact; there is no tolerance.

On the card (``cuda`` marker, skipped here): the decode chunk as a captured
CUDA graph against the same body called eagerly (bits of tokens, lengths,
payload and KV pools), launch counting per replay, sampled replays, the
capture under ``torch.cuda.set_sync_debug_mode("error")``, and spec at
W = 2..4 through kernel 1 and kernel 1q against the CPU engine. JAX is
imported inside the CPU comparisons only, so the card cases run where it
is not installed:
``python -m pytest tests/test_torch_speculative.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import (
    GenerationRequest,
    GenerationResult,
    ServingEngine,
)
from paddlepaddle_tpu_torch.inference.speculative import resolve_draft
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa


def _cfg(hidden=64, vocab=128, max_len=96, heads=4, kv_heads=2):
    return dict(vocab_size=vocab, hidden_size=hidden,
                intermediate_size=hidden * 3, num_hidden_layers=2,
                num_attention_heads=heads, num_key_value_heads=kv_heads,
                max_position_embeddings=max_len, dtype="float32")


ENGINE = dict(max_slots=3, chunk=8, page_size=16)


def _workload():
    """Ragged prompts and budgets, one eos request, one shared-prefix pair
    (page-aligned at page size 16: a miss, then a hit)."""
    rng = np.random.default_rng(3)
    reqs = []
    for plen, budget, eos in [(5, 8, None), (17, 4, None), (40, 6, None),
                              (9, 8, 3), (22, 5, None)]:
        reqs.append((rng.integers(0, 128, (plen,)).astype(np.int32),
                     budget, eos, None))
    system = rng.integers(0, 128, (16,)).astype(np.int32)
    for _ in range(2):
        tail = rng.integers(0, 128, (7,)).astype(np.int32)
        reqs.append((np.concatenate([system, tail]), 6, None, 16))
    return reqs


def _port_model(state, cfg, device="cpu"):
    m = LlamaForCausalLM(LlamaConfig(**cfg), device=device)
    convert.load_jax_state(m, state)
    return m


@pytest.fixture(scope="module")
def models():
    """(jax target, jax drafts, port target, port drafts, states): drafts
    ``self`` (the target), ``near`` (the target's weights plus noise of
    0.8x their scale: partial acceptance) and ``weak`` (an independent
    hidden-32 model: nearly every proposal rejected)."""
    import paddlepaddle_tpu as paddle
    from paddlepaddle_tpu.models import LlamaConfig as JConfig
    from paddlepaddle_tpu.models import LlamaForCausalLM as JLlama

    paddle.seed(0)
    jm = JLlama(JConfig(**_cfg()))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    rng = np.random.default_rng(5)
    near_state = {k: (v + 0.8 * v.std() * rng.standard_normal(v.shape)
                      ).astype(v.dtype) if "norm" not in k else v
                  for k, v in state.items()}
    jnear = JLlama(JConfig(**_cfg()))
    jnear.set_state_dict(near_state)
    paddle.seed(7)
    jweak = JLlama(JConfig(**_cfg(hidden=32)))
    weak_state = {k: np.asarray(v)
                  for k, v in jweak.functional_state().items()}
    tm = _port_model(state, _cfg())
    drafts_j = {"self": jm, "near": jnear, "weak": jweak}
    drafts_t = {"self": tm, "near": _port_model(near_state, _cfg()),
                "weak": _port_model(weak_state, _cfg(hidden=32))}
    return jm, drafts_j, tm, drafts_t


def _jax_serve(jm, draft, k, workload, **kw):
    from paddlepaddle_tpu.inference.decode_engine import \
        BatchDecodeEngine as JaxEngine
    from paddlepaddle_tpu.inference.serving import \
        GenerationRequest as JaxRequest

    eng = JaxEngine(jm, fused_kernels=False, draft=draft, spec_k=k,
                    **dict(ENGINE, **kw))
    reqs = [JaxRequest(p, b, 0.0, 0, e, prefix_len=x)
            for p, b, e, x in workload]
    eng.serve(reqs, timeout=300)
    return eng, reqs


def _port_serve(tm, workload, device="cpu", **kw):
    eng = BatchDecodeEngine(tm, device=device, **dict(ENGINE, **kw))
    reqs = [GenerationRequest(p, b, 0.0, 0, e, prefix_len=x)
            for p, b, e, x in workload]
    eng.serve(reqs, timeout=300)
    return eng, reqs


def _outs(reqs):
    return [np.asarray(r.result.result(5)) for r in reqs]


def _assert_no_leak(eng):
    """Every speculated page is back: the pool holds exactly the
    refcount-0 cached prefix pages, no entry holds a ref, no slot pages."""
    kv = eng.kv_stats()
    assert kv["pages_used"] == kv["prefix"]["cached_pages"]
    assert all(e.refcount == 0 for e in eng.prefix._entries.values())
    assert all(not pages for pages in eng._slot_pages)


# -- CPU: the port against the JAX engine ------------------------------------

@pytest.mark.parametrize("draft", ["self", "near", "weak"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_spec_matches_jax_engine(models, k, draft):
    jm, drafts_j, tm, drafts_t = models
    workload = _workload()
    jeng, jreqs = _jax_serve(jm, drafts_j[draft], k, workload)
    eng, reqs = _port_serve(tm, workload, draft=drafts_t[draft], spec_k=k)
    for g, w in zip(_outs(reqs), _outs(jreqs)):
        np.testing.assert_array_equal(g, w)
    assert eng.spec.stats == jeng.spec.stats
    assert eng.spec.runlen == jeng.spec.runlen
    assert [(r.result._spec_steps, r.result._spec_accepted) for r in reqs] \
        == [(r.result._spec_steps, r.result._spec_accepted) for r in jreqs]
    st = eng.spec.stats
    if draft == "self":
        assert st["accepted"] == st["proposed"] > 0
    if draft == "near":
        assert 0 < st["accepted"] < st["proposed"]
    assert eng.kernel == "plain"
    _assert_no_leak(eng)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_spec_tokens_equal_non_spec_engine(models, k):
    _, _, tm, drafts_t = models
    workload = _workload()
    _, plain = _port_serve(tm, workload)
    eng, spec = _port_serve(tm, workload, draft=drafts_t["near"], spec_k=k)
    for a, b in zip(_outs(spec), _outs(plain)):
        np.testing.assert_array_equal(a, b)
    info = eng.spec.info()
    assert info["k"] == k and info["tokens_per_target_step"] > 1.0
    assert info["acceptance_rate"] == round(
        info["accepted"] / info["proposed"], 4)


def test_spec_int8_kv_matches_jax_int8_engine(models):
    jm, drafts_j, tm, drafts_t = models
    workload = _workload()
    jeng, jreqs = _jax_serve(jm, drafts_j["near"], 2, workload,
                             kv_quant="int8")
    eng, reqs = _port_serve(tm, workload, draft=drafts_t["near"], spec_k=2,
                            kv_quant="int8")
    for g, w in zip(_outs(reqs), _outs(jreqs)):
        np.testing.assert_array_equal(g, w)
    assert eng.spec.stats == jeng.spec.stats
    assert eng.spec.runlen == jeng.spec.runlen
    _assert_no_leak(eng)


def test_spec_rollback_and_mid_speculation_reset_leak_nothing(models):
    _, _, tm, drafts_t = models
    eng = BatchDecodeEngine(tm, device="cpu", draft=drafts_t["weak"],
                            spec_k=3, **ENGINE)
    workload = _workload()
    reqs = [GenerationRequest(p, 20, 0.0, 0, None, prefix_len=x)
            for p, _, _, x in workload[:3]]
    for r in reqs:
        assert eng._admit(r)
    eng._decode_chunk()
    assert eng.spec.stats["rollbacks"] > 0
    victim = next(i for i, s in enumerate(eng._host_slots)
                  if s.req is reqs[1])
    held = len(eng._slot_pages[victim])
    free0 = eng.pool.free_count
    eng.release_slot(victim)
    assert eng.pool.free_count == free0 + held
    assert not bool(eng.active[victim])
    assert int(eng.page_table[victim].abs().sum()) == 0
    eng.serve([], timeout=120)
    assert not reqs[1].result.done()
    for r in (reqs[0], reqs[2]):
        assert len(r.result.result(5)) == r.prompt_ids.shape[1] + 20
    _assert_no_leak(eng)
    # the rest of the workload still serves token-exact after the reset
    _, plain = _port_serve(tm, workload)
    rest = [GenerationRequest(p, b, 0.0, 0, e, prefix_len=x)
            for p, b, e, x in workload]
    eng.serve(rest, timeout=120)
    for a, b in zip(_outs(rest), _outs(plain)):
        np.testing.assert_array_equal(a, b)
    _assert_no_leak(eng)


def test_spec_refuses_sampled_requests_and_keeps_pages(models):
    _, _, tm, drafts_t = models
    eng = BatchDecodeEngine(tm, device="cpu", draft=drafts_t["near"],
                            spec_k=2, **ENGINE)
    free0, table0 = eng.pool.free_count, eng.page_table.clone()
    req = GenerationRequest(np.arange(1, 9), 4, temperature=0.7)
    with pytest.raises(ValueError, match="temperature 0.7 with speculative"):
        eng._admit(req)
    assert eng.pool.free_count == free0 and eng.busy_slots() == 0
    assert torch.equal(eng.page_table, table0)
    with ServingEngine(tm, max_batch_size=3, kv_page_size=16,
                       decode_chunk=8, draft=drafts_t["near"], spec_k=2,
                       device="cpu") as se:
        with pytest.raises(ValueError, match="speculative"):
            se.generate(np.arange(1, 9), max_new_tokens=4, temperature=0.5,
                        timeout=60)
        out = se.generate(np.arange(1, 9), max_new_tokens=4, timeout=60)
        assert len(out) == 12
        assert se.engine.pool.free_count == se.engine.pool.usable


def test_spec_construction_errors(models):
    _, _, tm, drafts_t = models
    with pytest.raises(ValueError, match="BOTH draft"):
        BatchDecodeEngine(tm, device="cpu", spec_k=2, **ENGINE)
    with pytest.raises(ValueError, match="BOTH draft"):
        BatchDecodeEngine(tm, device="cpu", draft=tm, spec_k=0, **ENGINE)
    with pytest.raises(ValueError, match="paged"):
        BatchDecodeEngine(tm, device="cpu", draft=tm, spec_k=2,
                          kv_layout="contiguous", **ENGINE)
    small_vocab = LlamaForCausalLM(LlamaConfig(**_cfg(32, vocab=64)),
                                   device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        BatchDecodeEngine(tm, device="cpu", draft=small_vocab, spec_k=2,
                          **ENGINE)
    short = LlamaForCausalLM(LlamaConfig(**_cfg(32, max_len=64)),
                             device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        BatchDecodeEngine(tm, device="cpu", draft=short, spec_k=2, **ENGINE)
    with pytest.raises(ValueError, match="draft must be"):
        BatchDecodeEngine(tm, device="cpu", draft=object(), spec_k=2,
                          **ENGINE)
    # draft_quant: the draft's weights quantized into a view of the draft,
    # through both engines; its meta equals the reference's over the same
    # weights, and the target (here its own draft) is left full precision
    from paddlepaddle_tpu.inference.decode_engine import \
        BatchDecodeEngine as JaxEngine

    jm = models[0]
    jeng = JaxEngine(jm, fused_kernels=False, draft=jm, spec_k=2,
                     draft_quant="weight_only_int8", **ENGINE)
    for eng in (BatchDecodeEngine(tm, device="cpu", draft=tm, spec_k=2,
                                  draft_quant="weight_only_int8", **ENGINE),
                ServingEngine(tm, device="cpu", draft=tm, spec_k=2,
                              draft_quant="weight_only_int8").engine):
        assert eng.spec.draft_quant_meta == jeng.spec.draft_quant_meta
        assert eng.spec.describe_draft()["quant"] == "weight_only_int8"
        assert eng.spec.draft_model is tm and eng.net is tm
        assert eng.spec.draft_net is not tm
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(tm, device="cpu", mode="static", draft=tm, spec_k=2)
    # a config draft is built on the engine's device from the seed, with
    # its rope widened to max_len + k
    cfg = LlamaConfig(**_cfg(32, max_len=64))
    d = resolve_draft(cfg, tm.config, 96, 3, torch.device("cpu"), seed=4)
    assert d.config.max_position_embeddings == 99
    assert d.model.rope_cos.shape[0] == 99
    eng = BatchDecodeEngine(tm, device="cpu", draft=cfg, spec_k=3, seed=4,
                            **ENGINE)
    again = BatchDecodeEngine(tm, device="cpu", draft=cfg, spec_k=3, seed=4,
                              **ENGINE)
    for a, b in zip(eng.spec.draft_model.parameters(),
                    again.spec.draft_model.parameters()):
        assert torch.equal(a, b)
    assert eng.spec.facts()["k"] == 3
    assert eng.spec.describe_draft()["hidden_size"] == 32
    assert eng.spec.round_summary(np.array([2, -1, 0])) == {
        "k": 3, "steps": 2, "proposed": 6, "accepted": 2}
    assert eng.spec.runlen_pct(0.5) is None


def test_serving_engine_spec_matches_direct_engine(models):
    _, _, tm, drafts_t = models
    workload = _workload()
    _, direct = _port_serve(tm, workload, draft=drafts_t["near"], spec_k=3)
    with ServingEngine(tm, max_batch_size=3, kv_page_size=16,
                       decode_chunk=8, draft=drafts_t["near"], spec_k=3,
                       device="cpu") as se:
        futs = [se.submit(p, max_new_tokens=b, eos_token_id=e,
                          prefix_len=x) for p, b, e, x in workload]
        outs = [f.result(60) for f in futs]
        for f in futs:
            assert 1 <= f._n_at_first <= f._n_new
        assert se.engine.spec.stats["target_steps"] > 0
        _assert_no_leak(se.engine)
    for a, b in zip(outs, _outs(direct)):
        np.testing.assert_array_equal(a, b)


def test_tpot_divides_by_tokens_after_first_sync():
    r = GenerationResult()
    r._t_admit = r._t_submit
    r._t_first = r._t_submit + 1.0
    r._t_done = r._t_submit + 11.0
    r._n_new = 11
    assert r.slo()["tpot_s"] == pytest.approx(1.0)       # (11-1) tokens
    r._n_at_first = 6       # a speculative burst landed at the first sync
    assert r.slo()["tpot_s"] == pytest.approx(2.0)       # (11-6) tokens
    r._n_at_first = 11
    assert r.slo()["tpot_s"] is None                     # nothing after


# -- the card -----------------------------------------------------------------

CARD = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU to run the port on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_pair(dtype="float32", seed=1, **over):
    cfg = LlamaConfig(**dict(CARD, dtype=dtype, **over))
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed, init_std=0.1)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _admit_all(eng, prompts, budget, **kw):
    for p in prompts:
        assert eng._admit(GenerationRequest(p, budget, **kw))


def _card_prompts(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(m),)).astype(np.int32)
            for m in rng.integers(5, 40, n)]


def _pools(eng):
    out = []
    for kc, vc in eng.caches:
        for c in (kc, vc):
            out.extend(c if isinstance(c, tuple) else (c,))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_quant", [("bfloat16", None),
                                            ("bfloat16", "int8"),
                                            ("float32", None)])
def test_captured_chunk_equals_eager_body_on_card(dtype, kv_quant):
    """Engine A runs its decode program (warm-up + capture, then replays);
    engine B calls the same body eagerly: equal bits after every chunk,
    and the paged launch counters move by chunk x layers per chunk. Then
    the same with sampled requests (temperature 1.0) and one seed for both
    engines: a replay draws from the generator what the body draws."""
    _card()
    _, gpu = _card_pair(dtype)
    kw = dict(max_slots=3, chunk=4, page_size=16, device="cuda",
              kv_quant=kv_quant)
    a, b = BatchDecodeEngine(gpu, **kw), BatchDecodeEngine(gpu, **kw)
    prompts = _card_prompts()
    _admit_all(a, prompts, 40)
    _admit_all(b, prompts, 40)
    name = "int8_launches" if kv_quant else "launches"
    layers = gpu.config.num_hidden_layers
    for n in range(1, 5):
        before = getattr(pa.paged_attention, name)
        a._program("decode")()
        assert getattr(pa.paged_attention, name) - before == 4 * layers
        b._decode_body()
        torch.cuda.synchronize()
        for x, y in ((a.packed, b.packed), (a.tokens, b.tokens),
                     (a.lens, b.lens), (a.active, b.active),
                     (a.budgets, b.budgets)):
            assert torch.equal(x, y), n
        for x, y in zip(_pools(a), _pools(b)):
            assert torch.equal(x, y), n
    info = a.capture_info()["decode"]
    assert info["captured"] and info["replays"] == 3
    assert info["launches_per_replay"] == {name: 4 * layers}

    a, b = (BatchDecodeEngine(gpu, seed=11, **kw),
            BatchDecodeEngine(gpu, seed=11, **kw))
    _admit_all(a, prompts, 40, temperature=1.0)
    _admit_all(b, prompts, 40, temperature=1.0)
    payloads = []
    for n in range(1, 5):
        a._program("decode")()
        b._decode_body()
        torch.cuda.synchronize()
        for x, y in ((a.packed, b.packed), (a.tokens, b.tokens),
                     (a.lens, b.lens), (a.active, b.active)):
            assert torch.equal(x, y), n
        payloads.append(a.packed[:, :-1].clone())
    assert a.capture_info()["decode"]["replays"] == 3
    assert not torch.equal(payloads[1], payloads[2])


@pytest.mark.cuda
def test_capture_has_no_host_sync_and_sampled_replays_vary_on_card():
    _card()
    _, gpu = _card_pair("bfloat16")
    kw = dict(max_slots=2, chunk=4, page_size=16, device="cuda", seed=9)
    outs = []
    for _ in range(2):
        eng = BatchDecodeEngine(gpu, **kw)
        _admit_all(eng, _card_prompts(2, seed=4), 60, temperature=1.0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._program("decode")()           # warm-up body + capture
            eng._program("decode")()           # a replay
        finally:
            torch.cuda.set_sync_debug_mode(0)
        chunks = [eng.packed.clone()]
        for _ in range(2):
            eng._program("decode")()
            chunks.append(eng.packed.clone())
        outs.append(torch.stack(chunks).cpu())
    # replay to replay the draws move on; equal seeds give equal draws
    assert not torch.equal(outs[0][1, :, :4], outs[0][2, :, :4])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k,kv_quant", [(1, None), (2, None), (3, None),
                                        (3, "int8")])
def test_spec_on_card_equals_cpu_and_counts_wide_launches(k, kv_quant):
    """Spec at W = k+1 through kernel 1 (kernel 1q under int8) on the card
    gives the CPU engine's tokens (fp32) and launches the kernel layers
    times per verify step; no page leaks."""
    _card()
    cpu, gpu = _card_pair("float32")
    dcfg = dict(CARD, hidden_size=128, intermediate_size=256,
                num_attention_heads=2, num_key_value_heads=1,
                dtype="float32")
    dcpu = LlamaForCausalLM(LlamaConfig(**dcfg), device="cpu", seed=3,
                            init_std=0.1)
    dgpu = LlamaForCausalLM(LlamaConfig(**dcfg), device="cuda")
    dgpu.load_state_dict(dcpu.state_dict())
    prompts = _card_prompts(5, seed=2)
    outs, engines = {}, {}
    name = "int8_launches" if kv_quant else "launches"
    for dev, model, draft in (("cuda", gpu, dgpu), ("cpu", cpu, dcpu)):
        eng = BatchDecodeEngine(model, max_slots=3, chunk=8, page_size=16,
                                device=dev, draft=draft, spec_k=k,
                                kv_quant=kv_quant)
        reqs = [GenerationRequest(p, 12) for p in prompts]
        before = getattr(pa.paged_attention, name)
        eng.serve(reqs, timeout=300)
        engines[dev] = (eng, getattr(pa.paged_attention, name) - before)
        outs[dev] = [r.result.result(5).tolist() for r in reqs]
    assert outs["cuda"] == outs["cpu"]
    eng, launches = engines["cuda"]
    assert launches == gpu.config.num_hidden_layers * \
        eng.stats["decode_steps"] > 0
    assert eng.spec.stats == engines["cpu"][0].spec.stats
    info = eng.capture_info()
    assert info[f"verify_k{k}"]["launches_per_replay"] == {
        name: gpu.config.num_hidden_layers}
    assert eng.pool.free_count == eng.pool.usable


@pytest.mark.cuda
def test_spec_k_past_the_kernel_raises_at_construction_on_card():
    """W = k+1 beyond the kernel's 4 rows a slot (rep 2 here) raises when
    the engine is built, naming the open coverage; it never falls back."""
    _card()
    _, gpu = _card_pair("float32")
    with pytest.raises(ValueError, match="queue B row 1"):
        BatchDecodeEngine(gpu, max_slots=2, page_size=16, device="cuda",
                          draft=gpu, spec_k=4)
    eng = BatchDecodeEngine(gpu, max_slots=2, page_size=16, device="cuda",
                            draft=gpu, spec_k=3)
    assert eng.kernel == "cuda"
