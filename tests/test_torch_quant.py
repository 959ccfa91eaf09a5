"""Weight-only int8 in the port (``paddlepaddle_tpu_torch/nn/quant``, the
engines' ``quant=`` / ``quant_group_size=``) on the CPU against the JAX
package's ``paddlepaddle_tpu.nn.quant`` and its engines.

Codes and scales are compared bit for bit (both round half to even over the
same f32 divisions); products through ``weight_only_linear``,
``WeightOnlyLinear`` and ``F.linear`` within 2e-5 in f32 (the same operands
in another summation order). Engines over the fixed ragged workload of
``tests/test_torch_serving.py`` must emit the JAX engine's greedy tokens.
Dtypes are pinned on both sides (the JAX package turns x64 on).
"""

import warnings

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu.nn.quant as jq
from paddlepaddle_tpu.inference.decode_engine import \
    BatchDecodeEngine as JaxEngine
from paddlepaddle_tpu.inference.serving import \
    GenerationRequest as JaxRequest
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import (
    GenerationRequest,
    ServingEngine,
)
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.nn import functional as F
from paddlepaddle_tpu_torch.nn import quant as tq
from paddlepaddle_tpu_torch.nn.common import Linear

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96, dtype="float32")
SPECS = [(5, 8, None), (17, 4, None), (3, 10, 7), (40, 6, None)]
ENGINE = dict(max_slots=3, chunk=4, page_size=16)
ATOL = 2e-5      # f32 products of the same int8 operands, summation order


def _w(shape, seed=0, zero_col=None):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0.0           # an all-zero channel quantizes to 0
    return w


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


# -- codes, scales, products ---------------------------------------------------

@pytest.mark.parametrize("group_size", [-1, 16, 64, 128])
def test_codes_and_scales_bit_equal(group_size):
    w = _w((256, 48), seed=1, zero_col=3)
    jqq, js = jq.weight_quantize(paddle.to_tensor(w), group_size=group_size)
    tqq, ts = tq.weight_quantize(torch.from_numpy(w), group_size=group_size)
    assert tqq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqq.numpy(), np.asarray(jqq.numpy()))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    assert int(tqq[:, 3].abs().sum()) == 0
    for od in ("float32", "bfloat16"):
        jd = np.asarray(jq.weight_dequantize(
            jqq, js, out_dtype=od, group_size=group_size).numpy()
        ).astype(np.float32)
        td = tq.weight_dequantize(tqq, ts, out_dtype=od,
                                  group_size=group_size).float().numpy()
        np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("group_size", [-1, 16, 64])
def test_weight_only_linear_matches_reference(group_size):
    x = np.random.default_rng(2).standard_normal((3, 5, 128)).astype(
        np.float32)
    w = _w((128, 24), seed=3)
    b = np.random.default_rng(4).standard_normal(24).astype(np.float32)
    jqq, js = jq.weight_quantize(paddle.to_tensor(w), group_size=group_size)
    want = np.asarray(jq.weight_only_linear(
        paddle.to_tensor(x), jqq, bias=paddle.to_tensor(b), weight_scale=js,
        group_size=group_size).numpy())
    tqq, ts = tq.weight_quantize(torch.from_numpy(w), group_size=group_size)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    got = tq.weight_only_linear(xt, tqq, bias=bt, weight_scale=ts,
                                group_size=group_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    qw = tq.QuantizedWeight(tqq, ts, group_size=group_size)
    np.testing.assert_allclose(
        tq.weight_only_linear(xt, qw, bias=bt).numpy(), want, atol=ATOL,
        rtol=0)
    # F.linear lowers a QuantizedWeight through wo_matmul, the path the
    # reference engine binds
    np.testing.assert_allclose(F.linear(xt, qw, bt).numpy(), want,
                               atol=ATOL, rtol=0)
    # bf16 input: computed in bf16, returned as bf16
    yb = F.linear(xt.to(torch.bfloat16), qw)
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy(), want - b, atol=0.5,
                               rtol=0.05)


def test_weight_only_linear_layer_matches_reference():
    w = _w((64, 16), seed=5)
    jlin = paddle.nn.Linear(64, 16, bias_attr=False)
    jlin.weight.set_value(w)
    x = np.random.default_rng(6).standard_normal((3, 64)).astype(np.float32)
    want = np.asarray(jq.WeightOnlyLinear.from_linear(jlin)(
        paddle.to_tensor(x)).numpy())
    lin = Linear(64, 16, bias_attr=False, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    qlin = tq.WeightOnlyLinear.from_linear(lin)
    assert qlin.quant_weight.dtype == torch.int8
    assert {n for n, _ in qlin.named_buffers()} == {"quant_weight",
                                                    "weight_scale"}
    np.testing.assert_allclose(qlin(torch.from_numpy(x)).detach().numpy(),
                               want, atol=ATOL, rtol=0)
    assert "per-channel" in repr(qlin)
    g = tq.WeightOnlyLinear.from_linear(lin, group_size=16)
    assert "group_size=16" in repr(g) and g.weight_scale.shape == (4, 16)


def test_validation_errors_match_reference():
    w = _w((64, 8), seed=7)
    x = np.random.default_rng(8).standard_normal((4, 64)).astype(np.float32)
    jw, tw = paddle.to_tensor(w), torch.from_numpy(w)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    for kw in (dict(algo="weight_only_int4"), dict(group_size=48),
               dict(group_size=0), None):
        quantize = ((lambda m, a: m.weight_quantize(a[0])) if kw is None
                    else (lambda m, a: m.weight_quantize(a, **kw)))
        with pytest.raises(Exception) as je:
            quantize(jq, jw)
        with pytest.raises(type(je.value)):
            quantize(tq, tw)
    jqg, jsg = jq.weight_quantize(jw, group_size=16)
    tqg, tsg = tq.weight_quantize(tw, group_size=16)
    jqc, jsc = jq.weight_quantize(jw)
    tqc, tsc = tq.weight_quantize(tw)
    for (ja, ta), match in (
            (((jx, jqg, None, jsg), (tx, tqg, None, tsg)), "group_size"),
            (((jx, jqc, None, jsc, "int8", None, 16),
              (tx, tqc, None, tsc, "int8", None, 16)), "group"),
            (((jx, jqg, None, paddle.to_tensor(jsg.numpy()[:2]), "int8",
               None, 16), (tx, tqg, None, tsg[:2], "int8", None, 16)),
             "groups"),
            (((jx, jqc), (tx, tqc)), "weight_scale"),
            (((jx, jq.QuantizedWeight(jqc.numpy(), jsc.numpy()), None,
               jsc), (tx, tq.QuantizedWeight(tqc, tsc), None, tsc)),
             "already")):
        with pytest.raises(ValueError, match=match):
            jq.weight_only_linear(*ja)
        with pytest.raises(ValueError, match=match):
            tq.weight_only_linear(*ta)
    with pytest.raises(NotImplementedError):
        jq.weight_only_linear(jx, jqc, weight_scale=jsc, weight_dtype="int4")
    with pytest.raises(NotImplementedError):
        tq.weight_only_linear(tx, tqc, weight_scale=tsc, weight_dtype="int4")


# -- quantize_param_tree ---------------------------------------------------------

def _states(models):
    jm, tm = models
    tstate = dict(tm.named_parameters())
    tstate.update(dict(tm.named_buffers()))
    return jm.functional_state(), tstate


@pytest.mark.parametrize("group_size", [-1, 16, 64])
def test_quantize_param_tree_selection_meta_and_codes(models, group_size):
    jstate, tstate = _states(models)
    jp, jmeta = jq.quantize_param_tree(jstate, group_size=group_size)
    tp, tmeta = tq.quantize_param_tree(tstate, group_size=group_size)
    assert tmeta == jmeta
    assert "lm_head.weight" in tmeta["quantized"]
    assert not any("embed_tokens" in n or "norm" in n
                   for n in tmeta["quantized"])
    for name in tmeta["quantized"]:
        a, b = jp[name], tp[name]
        assert isinstance(b, tq.QuantizedWeight)
        assert b.group_size == group_size and b.out_dtype == torch.float32
        np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    assert set(tp) == set(tstate)


def test_quantize_param_tree_skips_warns_and_errors_like_reference(models):
    jstate, tstate = _states(models)
    # group 128 divides neither the hidden 64 nor the MLP width 192: every
    # weight is indivisible -> the same error
    for m, st in ((jq, jstate), (tq, tstate)):
        with pytest.raises(ValueError, match="selected NO weights"):
            m.quantize_param_tree(st, group_size=128)
    # group 48 divides the MLP width 192 only: down_proj stays quantized,
    # the rest warn as skipped
    metas = []
    for m, st in ((jq, jstate), (tq, tstate)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            _, meta = m.quantize_param_tree(st, group_size=48)
        assert any("FULL PRECISION" in str(r.message) for r in rec)
        metas.append(meta)
    assert metas[0] == metas[1]
    assert metas[1]["skipped_indivisible"]
    # include= picks names; a non-matrix pick is an error in both
    pick = lambda n, a: n.endswith("q_proj.weight")   # noqa: E731
    _, jmeta = jq.quantize_param_tree(jstate, include=pick)
    _, tmeta = tq.quantize_param_tree(tstate, include=pick)
    assert tmeta == jmeta and len(tmeta["quantized"]) == 2
    bad = lambda n, a: n.endswith("input_layernorm.weight")  # noqa: E731
    for m, st in ((jq, jstate), (tq, tstate)):
        with pytest.raises(ValueError, match="only 2-D floating"):
            m.quantize_param_tree(st, include=bad)
        with pytest.raises(NotImplementedError):
            m.quantize_param_tree(st, algo="int4")


def test_quantized_view_shares_and_leaves_the_model_alone(models):
    _, tm = models
    ids = torch.from_numpy(_prompts(9)[3][None].astype(np.int64))
    with torch.no_grad():
        before = tm(ids)
    view, meta = tq.quantized_view(tm)
    assert view is not tm and view.model is not tm.model
    assert view.model.embed_tokens is tm.model.embed_tokens
    assert view.model.norm is tm.model.norm
    assert view.model.rope_cos.data_ptr() == tm.model.rope_cos.data_ptr()
    layer = view.model.layers[0]
    assert isinstance(layer.self_attn.q_proj, tq.WeightOnlyLinear)
    assert layer.input_layernorm is tm.model.layers[0].input_layernorm
    assert isinstance(view.lm_head, tq.WeightOnlyLinear)
    assert isinstance(tm.lm_head, Linear)
    assert len(meta["quantized"]) == 2 * 7 + 1
    with torch.no_grad():
        after = tm(ids)
        q_logits = view(ids)
    torch.testing.assert_close(after, before, atol=0, rtol=0)
    # int8 weights move the logits a little, not a lot
    assert 0 < float((q_logits - before).abs().max()) < 0.1


# -- engines -----------------------------------------------------------------------

def _jax_tokens(jm, prompts, **kw):
    eng = JaxEngine(jm, fused_kernels=False, **dict(ENGINE, **kw))
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


@pytest.mark.parametrize("kw", [
    dict(quant="weight_only_int8"),
    dict(quant="weight_only_int8", quant_group_size=16),
    dict(quant="weight_only_int8", kv_quant="int8"),
    dict(quant="weight_only_int8", quant_group_size=32, kv_quant="int8"),
], ids=["per_channel", "group16", "kv_int8", "group32_kv_int8"])
def test_quantized_engine_token_exact_vs_jax(models, kw):
    jm, tm = models
    prompts = _prompts()
    jeng, want = _jax_tokens(jm, prompts, **kw)
    ids = torch.from_numpy(prompts[3][None].astype(np.int64))
    with torch.no_grad():
        before = tm(ids)
    eng, got = _port_tokens(tm, prompts, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.quant == "weight_only_int8"
    assert eng.quant_meta == jeng.quant_meta
    assert eng.pool.free_count == eng.pool.usable
    # the caller's model still computes in full precision
    with torch.no_grad():
        torch.testing.assert_close(tm(ids), before, atol=0, rtol=0)
    assert eng.model is tm and eng.net is not tm


def test_quantized_engine_refusals_match_reference(models):
    jm, tm = models
    for make in (lambda: JaxEngine(jm, quant="weight_only_int4"),
                 lambda: BatchDecodeEngine(tm, device="cpu",
                                           quant="weight_only_int4"),
                 lambda: ServingEngine(jm, quant="weight_only_int4"),
                 lambda: ServingEngine(tm, device="cpu",
                                       quant="weight_only_int4")):
        with pytest.raises(ValueError, match="weight_only_int8"):
            make()
    for make in (lambda: ServingEngine(jm, mode="static",
                                       quant="weight_only_int8"),
                 lambda: ServingEngine(tm, device="cpu", mode="static",
                                       quant="weight_only_int8")):
        with pytest.raises(ValueError, match="continuous"):
            make()


def test_serving_engine_quant_passthrough_and_health(models, capsys):
    jm, tm = models
    prompts = _prompts(2)
    _, direct = _port_tokens(tm, prompts, quant="weight_only_int8",
                             quant_group_size=16)
    with ServingEngine(tm, max_batch_size=3, kv_page_size=16,
                       decode_chunk=4, quant="weight_only_int8",
                       quant_group_size=16, device="cpu") as se:
        assert "weight-only quant armed" in capsys.readouterr().err
        futs = [se.submit(p, max_new_tokens=mx, eos_token_id=e)
                for p, (_, mx, e) in zip(prompts, SPECS)]
        outs = [f.result(60) for f in futs]
        h = se.health()
        assert h["quant"] == "weight_only_int8"
        assert se.engine.quant_meta["group_size"] == 16
    for a, b in zip(outs, direct):
        np.testing.assert_array_equal(a, b)
    with ServingEngine(tm, max_batch_size=2, kv_page_size=16,
                       device="cpu") as se:
        assert se.health()["quant"] == "off"
