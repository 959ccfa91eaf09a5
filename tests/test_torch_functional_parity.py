"""The port's public functional signatures against the JAX package
(``paddlepaddle_tpu.nn.functional``): ``rms_norm`` with a bias,
``flash_attention`` with the reference's positional order, ``name=`` on
``scaled_dot_product_attention``, and the attention configurations the JAX
package computes without a TPU kernel (d outside its kernel gate, causal
``s_q > s_k``), which the port computes in its plain version on either
device.

Inputs come from numpy seeds; dtypes are pinned on both sides (the JAX
package turns x64 on). Tolerances, each with its reason:

* rms_norm f32 1e-6: the same f32 mean, rsqrt and products in two
  libraries; bf16 one bf16 ulp of the reference value (both round the
  normalised row, the weight product and the bias sum to bf16);
* attention f32 1e-5: one f32 softmax in each library over the same
  logits, summed in other orders;
* dropout: the two packages draw from different generators, so the test
  compares behaviour (a changed output, a share of zeros near the rate),
  not bits.

JAX is imported inside the comparisons only, so the card case also runs
where JAX is not installed:
``python -m pytest tests/test_torch_functional_parity.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.core import random as prandom
from paddlepaddle_tpu_torch.nn import functional as tF
from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv


def _paddle():
    import paddlepaddle_tpu as paddle

    return paddle


def _attn_inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# C1: rms_norm(x, weight, bias, epsilon, begin_norm_axis, name)
# ---------------------------------------------------------------------------


def _rms_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32),
            (0.5 + 0.1 * rng.standard_normal(n)).astype(np.float32))


@pytest.mark.parametrize("by_keyword", [False, True])
@pytest.mark.parametrize("shape", [(2, 4), (3, 5, 64)])
def test_rms_norm_bias_matches_reference_f32(shape, by_keyword):
    paddle = _paddle()
    x, w, b = _rms_inputs(shape, seed=len(shape))
    if by_keyword:
        want = paddle.nn.functional.rms_norm(
            paddle.to_tensor(x), weight=paddle.to_tensor(w),
            bias=paddle.to_tensor(b), epsilon=1e-6, begin_norm_axis=-1)
        got = tF.rms_norm(torch.from_numpy(x), weight=torch.from_numpy(w),
                          bias=torch.from_numpy(b), epsilon=1e-6,
                          begin_norm_axis=-1, name="norm")
    else:
        want = paddle.nn.functional.rms_norm(
            paddle.to_tensor(x), paddle.to_tensor(w), paddle.to_tensor(b))
        got = tF.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    want = np.asarray(want.numpy(), np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the bias is added after the weight, not folded into the epsilon
    no_bias = tF.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose((got - no_bias).numpy(),
                               np.broadcast_to(b, shape), atol=1e-6, rtol=0)


def test_rms_norm_bias_matches_reference_bf16():
    import jax.numpy as jnp

    paddle = _paddle()
    x, w, b = _rms_inputs((3, 5, 64), seed=7)
    want = paddle.nn.functional.rms_norm(
        *(paddle.to_tensor(jnp.asarray(a, jnp.bfloat16)) for a in (x, w, b)))
    want = np.asarray(jnp.asarray(want.numpy(), jnp.float32))
    got = tF.rms_norm(*(torch.from_numpy(a).to(torch.bfloat16)
                        for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100)))
                  - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_rms_norm_other_axis_raises():
    """C17: an axis before the last no longer raises; it normalises the
    trailing axes (numpy oracle in the next test)."""
    x = torch.ones(2, 3, 4)
    assert tF.rms_norm(x, begin_norm_axis=2).shape == x.shape
    np.testing.assert_allclose(tF.rms_norm(x, begin_norm_axis=1).numpy(),
                               np.ones((2, 3, 4)), rtol=1e-6)


def _rms_oracle(x, w, b, axis, eps=1e-6):
    axes = tuple(range(axis, x.ndim))
    var = np.mean(np.square(x.astype(np.float64)), axis=axes, keepdims=True)
    return x / np.sqrt(var + eps) * w + b


@pytest.mark.parametrize("axis", [1, 2, -1])
def test_rms_norm_begin_norm_axis_against_numpy(axis):
    """C17: ``begin_norm_axis=k`` normalises over the axes ``k..-1`` with a
    weight and bias of that trailing shape (Paddle's definition), held
    against numpy at 1e-5 (f32 mean and rsqrt against f64). The reference
    always normalises the last axis alone: it differs at axis 1 by more
    than 1e-2 and agrees at axis 2 (ROADMAP, reference divergences). For
    the last axis the result is bit-equal to the last-axis formula."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    trail = x.shape[axis % 3:]
    w = rng.standard_normal(trail).astype(np.float32)
    b = rng.standard_normal(trail).astype(np.float32)
    got = tF.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), begin_norm_axis=axis).numpy()
    np.testing.assert_allclose(got, _rms_oracle(x, w, b, axis % 3),
                               rtol=1e-5, atol=1e-5)
    paddle = _paddle()
    ref = np.asarray(paddle.nn.functional.rms_norm(
        paddle.to_tensor(x), paddle.to_tensor(w), paddle.to_tensor(b),
        begin_norm_axis=axis).numpy())
    if axis % 3 == 1:
        assert np.abs(ref - got).max() > 1e-2
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        xt = torch.from_numpy(x)
        var = xt.square().mean(dim=-1, keepdim=True)
        last = (xt * torch.rsqrt(var + 1e-6)) * torch.from_numpy(w) \
            + torch.from_numpy(b)
        assert torch.equal(torch.from_numpy(got), last)


@pytest.mark.parametrize("fn", ["softmax", "log_softmax"])
@pytest.mark.parametrize("dtype", ["float64", torch.float64])
def test_softmax_float64_against_reference(fn, dtype):
    """C18: ``dtype="float64"`` (or ``torch.float64``) computes in f64, as
    the reference does with x64 on; held against it at 1e-12."""
    rng = np.random.default_rng(18)
    x = rng.standard_normal((3, 7)).astype(np.float32)
    got = getattr(tF, fn)(torch.from_numpy(x), axis=-1, dtype=dtype)
    assert got.dtype == torch.float64
    paddle = _paddle()
    ref = np.asarray(getattr(paddle.nn.functional, fn)(
        paddle.to_tensor(x), axis=-1, dtype="float64").numpy())
    assert ref.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_rmsnorm_module_passes_epsilon():
    from paddlepaddle_tpu_torch.nn.norm import RMSNorm

    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 16)).astype(np.float32))
    m = RMSNorm(16, 0.5, device="cpu", dtype=torch.float32)
    torch.testing.assert_close(m(x), tF.rms_norm(x, m.weight, epsilon=0.5),
                               atol=0, rtol=0)
    assert not torch.allclose(m(x), tF.rms_norm(x, m.weight))


# ---------------------------------------------------------------------------
# C2: flash_attention's positional order; name= on SDPA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_positional_matches_reference(causal):
    paddle = _paddle()
    q, k, v = _attn_inputs(2, 16, 16, 2, 64, seed=11)
    want, none_j = paddle.nn.functional.flash_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), 0.0, causal, False, None,
        "", True, None)
    got, none_t = tF.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), 0.0, causal, False, None,
        "", True, None)
    assert none_j is None and none_t is None
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.numpy(), np.float32),
                               atol=1e-5, rtol=0)


def test_flash_attention_seventh_positional_is_fixed_seed_offset():
    """The reference's seventh positional is ``fixed_seed_offset``: with
    ``dropout=0.5`` the call applies dropout (it used to land in
    ``training`` and switch dropout off)."""
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(2, 16, 16, 2, 64,
                                                         seed=12))
    clean, _ = tF.flash_attention(q, k, v, 0.0, False, False, None)
    prandom.seed(3)
    dropped, _ = tF.flash_attention(q, k, v, 0.5, False, False, None)
    assert dropped.numel() == 4096
    assert not torch.equal(dropped, clean)
    zeros = float((dropped == 0).float().mean())
    assert abs(zeros - 0.5) <= 0.05
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], 2 * clean[kept])


def test_flash_attention_dropout_seeding():
    """``fixed_seed_offset`` seeds the dropout (as ``flash_attn_unpadded``
    does); without it, ``rng_name`` picks the named generator."""
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(1, 8, 8, 2, 64,
                                                         seed=13))
    a, _ = tF.flash_attention(q, k, v, 0.5, True, False, 123)
    b, _ = tF.flash_attention(q, k, v, 0.5, True, False, 123)
    c, _ = tF.flash_attention(q, k, v, 0.5, True, False, 124)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    prandom.seed(5)
    named = prandom.get_generator("flash_parity_stream")
    state = named.get_state()
    d1, _ = tF.flash_attention(q, k, v, 0.5, True, rng_name="flash_parity_stream")
    named.set_state(state)
    d2, _ = tF.flash_attention(q, k, v, 0.5, True, rng_name="flash_parity_stream")
    torch.testing.assert_close(d1, d2, atol=0, rtol=0)
    # training=False (the eighth positional) turns dropout off
    off, _ = tF.flash_attention(q, k, v, 0.5, True, False, None, "", False)
    torch.testing.assert_close(off, tF.flash_attention(q, k, v, 0.0, True)[0],
                               atol=0, rtol=0)


def test_sdpa_accepts_name():
    paddle = _paddle()
    q, k, v = _attn_inputs(1, 12, 12, 2, 64, seed=14)
    want = paddle.nn.functional.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=True, name="x")
    got = tF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True, name="x")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.numpy(), np.float32),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# C3: what the reference computes without a TPU kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,causal,sq,sk,plain", [
    (96, True, 32, 32, True),           # d outside the TPU gate
    (96, False, 32, 32, True),
    (32, False, 16, 16, True),
    (64, True, 64, 32, True),           # causal s_q > s_k
    (128, True, 64, 32, True),
    (64, False, 64, 32, False),         # full s_q > s_k: a kernel takes it
    (64, True, 32, 64, False),
    (128, True, 2048, 2048, False),
    (256, True, 64, 64, False),         # TPU gate admits: queue B, raises
    (384, False, 64, 64, False),
])
def test_routing_predicate_mirrors_reference_gate(d, causal, sq, sk, plain):
    assert fa.routes_to_plain(d, causal, sq, sk) is plain
    assert fa.reference_kernel_head_dim(d) is (d % 128 == 0
                                               or d in (64, 128, 256))


@pytest.mark.parametrize("d,dtype,match,dense_takes", [
    (256, torch.bfloat16, "head_dim", False),
    (384, torch.float32, "head_dim", False),
    (64, torch.float16, "dtype", True),
])
def test_kernel_coverage_a_tpu_kernel_takes_still_raises(d, dtype, match,
                                                         dense_takes):
    """d 256 (and larger multiples of 128) reach the kernels' check on the
    card and raise there: the check itself, on host tensors. fp16 passes
    the dense kernels' check (their fp16 instantiation) and still raises at
    the varlen kernels' (queue B coverage)."""
    q = torch.zeros(1, 16, 2, d, dtype=dtype)
    assert not fa.routes_to_plain(d, True, 16, 16)
    if dense_takes:
        fa._check_cuda_args(True, q, q, q)
    else:
        with pytest.raises(ValueError, match=match):
            fa._check_cuda_args(True, q, q, q)
    assert fv.reference_kernel_head_dim(d)
    qv = q[0]
    cu = torch.tensor([0, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        fv._check_cuda_args(qv, qv, qv, cu, cu)


@pytest.mark.parametrize("d,causal,sq,sk", [(96, True, 24, 24),
                                            (96, False, 20, 36),
                                            (64, True, 64, 32)])
def test_plain_routes_match_reference(d, causal, sq, sk):
    """Where the reference takes ``_xla_attention``, so does the port (here
    on the CPU): the same answer, rows without a visible key included."""
    paddle = _paddle()
    q, k, v = _attn_inputs(2, sq, sk, 2, d, seed=d + sq)
    want, _ = paddle.nn.functional.flash_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), causal=causal)
    got, _ = tF.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.numpy(), np.float32),
                               atol=1e-5, rtol=0)


def test_varlen_head_dim_route_matches_reference():
    paddle = _paddle()
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((30, 2, 96)).astype(np.float32)
               for _ in range(3))
    cu = np.asarray([0, 7, 19, 30], np.int32)
    want, _ = paddle.nn.functional.flash_attn_unpadded(
        *(paddle.to_tensor(a) for a in (q, k, v)), paddle.to_tensor(cu),
        paddle.to_tensor(cu), causal=True)
    got, _ = tF.flash_attn_unpadded(*(torch.from_numpy(a) for a in (q, k, v)),
                                    torch.from_numpy(cu),
                                    torch.from_numpy(cu), causal=True)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.numpy(), np.float32),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_plain_routes_on_card_match_cpu():
    """On the card the routed configurations answer (they raised before)
    and agree with the CPU plain version; no kernel is launched for them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU to run the port on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = (fa.flash_fwd.launches, fv.varlen_fwd.launches)
    for d, causal, sq, sk in ((96, True, 48, 48), (96, False, 40, 72),
                              (64, True, 64, 32), (128, True, 64, 32)):
        q, k, v = (torch.from_numpy(a)
                   for a in _attn_inputs(2, sq, sk, 2, d, seed=31))
        want, _ = tF.flash_attention(q, k, v, causal=causal)
        got, _ = tF.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                    causal=causal)
        torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5, (d, causal, sq, sk, err)
    rng = np.random.default_rng(32)
    qv, kv, vv = (torch.from_numpy(rng.standard_normal((30, 2, 96)).astype(
        np.float32)) for _ in range(3))
    cu = torch.tensor([0, 7, 19, 30], dtype=torch.int32)
    want, _ = tF.flash_attn_unpadded(qv, kv, vv, cu, cu, causal=True)
    got, _ = tF.flash_attn_unpadded(qv.cuda(), kv.cuda(), vv.cuda(), cu, cu,
                                    causal=True)
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    assert (fa.flash_fwd.launches, fv.varlen_fwd.launches) == counts


# ---------------------------------------------------------------------------
# C4: Adam / AdamW in the reference's positional order
# ---------------------------------------------------------------------------

_OPT_ATTRS = ("_lr", "_beta1", "_beta2", "_eps", "_weight_decay",
              "_grad_clip", "_multi_precision", "_amsgrad")


def test_adam_adamw_take_reference_positional_order():
    """Both optimizers built with the reference's positional order on both
    sides bind every parameter alike; one AdamW update of a gradient of 100
    through a global-norm clip equals the JAX eager step."""
    import jax.numpy as jnp
    from paddlepaddle_tpu.core.tensor import Parameter as JParameter
    from paddlepaddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
    from paddlepaddle_tpu.optimizer.optimizers import Adam as JAdam
    from paddlepaddle_tpu.optimizer.optimizers import AdamW as JAdamW

    from paddlepaddle_tpu_torch import ClipGradByGlobalNorm
    from paddlepaddle_tpu_torch.optimizer import Adam, AdamW

    rng = np.random.default_rng(40)
    init = rng.standard_normal((4, 3)).astype(np.float32)
    grad = np.full((4, 3), 100.0, np.float32)
    jp = [JParameter(init.copy(), name="w")]
    tp = {"w": torch.nn.Parameter(torch.from_numpy(init.copy()))}
    # (lr, beta1, beta2, epsilon, parameters, weight_decay, grad_clip,
    #  lazy_mode, multi_precision, use_multi_tensor, amsgrad, name)
    ja = JAdam(0.1, 0.9, 0.999, 1e-8, jp, None, None, False, True, False,
               True, "adam")
    ta = Adam(0.1, 0.9, 0.999, 1e-8, tp, None, None, False, True, False,
              True, "adam")
    for a in _OPT_ATTRS:
        assert getattr(ta, a) == getattr(ja, a), a
    assert ta._multi_precision is True and ta._amsgrad is True
    # (lr, beta1, beta2, epsilon, parameters, weight_decay, lr_ratio,
    #  apply_decay_param_fun, grad_clip, lazy_mode, multi_precision,
    #  amsgrad, name)
    fun = (lambda n: True)
    jclip, tclip = JClip(1.0), ClipGradByGlobalNorm(1.0)
    jw = JAdamW(0.1, 0.9, 0.999, 1e-8, jp, 0.01, None, fun, jclip, False,
                False, False, "adamw")
    tw = AdamW(0.1, 0.9, 0.999, 1e-8, tp, 0.01, None, fun, tclip, False,
               False, False, "adamw")
    for a in _OPT_ATTRS:
        if a != "_grad_clip":
            assert getattr(tw, a) == getattr(jw, a), a
    assert tw._grad_clip is tclip and jw._grad_clip is jclip
    assert tw._wd == jw._wd == 0.01
    assert tw._apply_decay_param_fun is fun
    jp[0].grad = jnp.asarray(grad, jnp.float32)
    jw.step()
    tw.apply([torch.from_numpy(grad.copy())])
    got = tp["w"].detach().numpy()
    np.testing.assert_allclose(got, jp[0].numpy(), atol=1e-6, rtol=0)
    # the clip bound the step: Adam's first step moves each entry by ~lr
    assert np.abs(got - init).max() < 0.11


# ---------------------------------------------------------------------------
# C5: GenerationRequest and the Llama forwards in the reference's order
# ---------------------------------------------------------------------------


def _tiny_llama(**over):
    from paddlepaddle_tpu_torch.models.llama import (LlamaConfig,
                                                     LlamaForCausalLM)

    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64,
               dtype="float32")
    return LlamaForCausalLM(LlamaConfig(**dict(cfg, **over)), device="cpu",
                            seed=2, init_std=0.1)


def test_generation_request_takes_reference_order():
    import time

    from paddlepaddle_tpu.inference.serving import \
        GenerationRequest as JRequest

    from paddlepaddle_tpu_torch.inference.decode_engine import \
        BatchDecodeEngine
    from paddlepaddle_tpu_torch.inference.serving import GenerationRequest

    args = (np.arange(1, 9), 4, 0.0, 0, None)
    deadline = time.monotonic() + 30
    for extra in ((deadline,), (None, 5), (deadline, 5)):
        j = JRequest(*args, *extra)
        t = GenerationRequest(*args, *extra)
        for name in ("max_new_tokens", "temperature", "top_k",
                     "eos_token_id", "deadline", "prefix_len"):
            assert getattr(t, name) == getattr(j, name), name
        assert t.result._deadline == j.result._deadline
        assert t.batch_key() == j.batch_key()
        np.testing.assert_array_equal(t.prompt_ids, j.prompt_ids)
    t = GenerationRequest(*args, deadline, None)
    eng = BatchDecodeEngine(_tiny_llama(), max_slots=1, page_size=4,
                            device="cpu")
    eng.serve([t], timeout=60)
    assert len(t.result.result(5)) == 12


def test_llama_forward_takes_reference_order():
    model = _tiny_llama()
    ids = torch.from_numpy(np.random.default_rng(41).integers(
        0, 64, (2, 10)))
    mask = torch.ones(2, 1, 10, 10)     # a float mask: added to the logits
    with torch.no_grad():
        full = model(ids)
        # the second positional parameter is the mask, the third of the
        # causal LM too; adding 1 to every logit leaves the softmax alone
        torch.testing.assert_close(model.model(ids, mask),
                                   model.model(ids, attn_mask=mask))
        torch.testing.assert_close(model(ids, None, mask), full, atol=1e-5,
                                   rtol=1e-5)
    shape0 = (2, 10, model.config.num_key_value_heads, model.config.head_dim)
    with pytest.raises(NotImplementedError, match="causal masking only"):
        model.model(ids, mask, [(torch.zeros(shape0), torch.zeros(shape0))
                                for _ in range(model.config.num_hidden_layers)])
    with torch.no_grad():
        hidden = model.model(ids, None)
        cfg = model.config
        shape = (2, 10, cfg.num_key_value_heads, cfg.head_dim)
        caches = [(torch.zeros(shape), torch.zeros(shape))
                  for _ in range(cfg.num_hidden_layers)]
        cached, _ = model.model(ids, None, caches)        # pos None means 0
    torch.testing.assert_close(model.logits(hidden), full)
    torch.testing.assert_close(model.logits(cached), full, atol=1e-5,
                               rtol=1e-5)
    loss = model(ids, ids)
    assert loss.dim() == 0 and torch.isfinite(loss)


# ---------------------------------------------------------------------------
# C6: head dims the reference never sends to its paged kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [8, 16, 32, 48, 64, 80, 96, 128, 160, 192,
                                256, 384])
def test_paged_routing_predicate_mirrors_reference_gate(hd, monkeypatch):
    from paddlepaddle_tpu.core import flags as jflags
    from paddlepaddle_tpu.ops.kernels import paged_attention as jpa

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as tpa

    monkeypatch.setattr(jpa, "_HAS_PALLAS", True)
    monkeypatch.setattr(jpa, "flag_value",
                        lambda name: True if name == "fused_paged_attention"
                        else jflags.flag_value(name))
    ok, _ = jpa.paged_attention_supported(
        page_size=16, head_dim=hd, num_heads=4, num_kv_heads=2)
    assert tpa.reference_kernel_head_dim(hd) is ok


@pytest.mark.cuda
def test_engine_serves_head_dim_96_on_card_like_cpu():
    """hd 96: the reference's gate refuses it, so the card engine decodes
    through the plain paged attention (no kernel launch) and gives the CPU
    engine's greedy tokens; the captured chunk carries that path too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU to run the port on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddlepaddle_tpu_torch.inference.decode_engine import \
        BatchDecodeEngine
    from paddlepaddle_tpu_torch.inference.serving import GenerationRequest
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as tpa

    cpu = _tiny_llama(hidden_size=192, num_attention_heads=2,
                      num_key_value_heads=1, vocab_size=128)
    from paddlepaddle_tpu_torch.models.llama import LlamaForCausalLM

    gpu = LlamaForCausalLM(cpu.config, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 128, (n,)) for n in (5, 17, 30)]
    outs, counts = {}, (tpa.paged_attention.launches,
                        tpa.paged_attention.int8_launches)
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        eng = BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                                device=dev)
        assert eng.kernel == "plain"
        reqs = [GenerationRequest(p, 10) for p in prompts]
        eng.serve(reqs, timeout=300)
        outs[dev] = [r.result.result(5).tolist() for r in reqs]
        if dev == "cuda":
            assert eng.capture_info()["decode"]["replays"] > 0
    assert outs["cuda"] == outs["cpu"]
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.int8_launches) == counts


# ---------------------------------------------------------------------------
# C10: TrainStep in the reference's positional order; the keyword surface
# the Llama subset dropped; the masked attention path
# ---------------------------------------------------------------------------


def test_train_step_takes_reference_positional_order():
    """``TrainStep(m, opt, fn, 1, False)``: the fifth positional parameter
    is ``donate`` (recorded, unread, as the eager step has nothing to
    donate), ``device`` is keyword-only; the step trains as one built by
    keyword."""
    import inspect

    from paddlepaddle_tpu.jit.train import TrainStep as JTrainStep

    from paddlepaddle_tpu_torch import AdamW, TrainStep

    def fn(m, ids, labels):
        return m(ids, labels=labels)

    ids = np.random.default_rng(50).integers(0, 64, (2, 10))
    losses = []
    for args, kw in (((1, False), {}), ((1, True), {}), ((), {})):
        model = _tiny_llama()
        opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
        step = TrainStep(model, opt, fn, *args, device="cpu", **kw)
        assert step.donate is (args[1] if args else True)
        assert step.grad_accum == 1
        losses.append([float(step(ids, ids)) for _ in range(2)])
    assert losses[0] == losses[1] == losses[2]
    with pytest.raises(TypeError):
        TrainStep(_tiny_llama(), AdamW(), fn, 1, True, "cpu")
    tsig = inspect.signature(TrainStep.__init__).parameters
    jsig = inspect.signature(JTrainStep.__init__).parameters
    positional = [(n, p.default) for n, p in tsig.items()
                  if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional == [(n, p.default) for n, p in jsig.items()]
    assert tsig["device"].kind == inspect.Parameter.KEYWORD_ONLY


def _positional_sig(obj):
    import inspect

    fn = obj.__init__ if inspect.isclass(obj) else obj
    return [(p.name, p.default) for p in inspect.signature(fn).parameters
            .values() if p.kind == p.POSITIONAL_OR_KEYWORD]


@pytest.mark.parametrize("name", ["F.embedding", "F.swiglu", "F.linear",
                                  "Linear", "Embedding", "RMSNorm",
                                  "MoELayer", "ClipGradByGlobalNorm"])
def test_dropped_keyword_surface_matches_reference(name):
    """Each reference parameter, in the reference's order and with its
    default (the port's ``device`` / ``dtype`` / ``seed`` are keyword-only
    extras)."""
    paddle = _paddle()
    from paddlepaddle_tpu.parallel import moe as jmoe

    import paddlepaddle_tpu_torch as pt

    pairs = {
        "F.embedding": (tF.embedding, paddle.nn.functional.embedding),
        "F.swiglu": (tF.swiglu, paddle.nn.functional.swiglu),
        "F.linear": (tF.linear, paddle.nn.functional.linear),
        "Linear": (pt.nn.Linear, paddle.nn.Linear),
        "Embedding": (pt.nn.Embedding, paddle.nn.Embedding),
        "RMSNorm": (pt.nn.RMSNorm, paddle.nn.RMSNorm),
        "MoELayer": (pt.MoELayer, jmoe.MoELayer),
        "ClipGradByGlobalNorm": (pt.ClipGradByGlobalNorm,
                                 paddle.nn.ClipGradByGlobalNorm),
    }
    tobj, jobj = pairs[name]
    assert _positional_sig(tobj) == _positional_sig(jobj)


def test_embedding_padding_idx_and_swiglu_split_match_reference():
    """``padding_idx`` (also negative) reads zeros and sends its row no
    gradient; the one-argument ``swiglu`` splits the last axis; both
    against the JAX package, values and gradients (1e-6)."""
    import jax

    paddle = _paddle()
    from paddlepaddle_tpu.core import autograd as jag
    from paddlepaddle_tpu.core.dispatch import unwrap

    rng = np.random.default_rng(51)
    w = rng.standard_normal((7, 4)).astype(np.float32)
    ids = np.array([[0, 3, 6, 3], [2, 6, 1, 0]], np.int64)
    for pad in (3, -1):
        def jf(wa):
            with jag.no_grad():
                out = paddle.nn.functional.embedding(
                    paddle.to_tensor(ids), paddle.to_tensor(wa),
                    padding_idx=pad)
                return (unwrap(out) * np.arange(4)).sum()

        jv, jg = jax.value_and_grad(jf)(w)
        tw = torch.from_numpy(w.copy()).requires_grad_(True)
        out = tF.embedding(torch.from_numpy(ids), tw, padding_idx=pad,
                           sparse=True, name="e")
        tv = (out * torch.arange(4)).sum()
        tv.backward()
        np.testing.assert_allclose(float(tv), float(jv), atol=1e-6)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg),
                                   atol=1e-6)
        assert float(tw.grad[pad].abs().sum()) == 0.0
    x = rng.standard_normal((3, 10)).astype(np.float32)
    want = paddle.nn.functional.swiglu(paddle.to_tensor(x)).numpy()
    got = tF.swiglu(torch.from_numpy(x), None, "s")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    from paddlepaddle_tpu_torch.nn import Embedding

    e = Embedding(7, 4, 3, False, None, "e", device="cpu")
    assert float(e(torch.tensor([3])).abs().sum()) == 0.0


@pytest.mark.parametrize("layer,kw", [
    ("Linear", dict(weight_attr=object())),
    ("Linear", dict(bias_attr=object())),
    ("Embedding", dict(weight_attr=object())),
    ("RMSNorm", dict(weight_attr=object())),
])
def test_param_attrs_the_port_cannot_honour_raise(layer, kw):
    import paddlepaddle_tpu_torch as pt

    args = (4,) if layer == "RMSNorm" else (4, 3)
    with pytest.raises(NotImplementedError, match="A11"):
        getattr(pt.nn, layer)(*args, device="cpu", **kw)


def test_layers_build_like_the_reference():
    """``Linear`` has a zero bias unless ``bias_attr=False``; ``RMSNorm``
    takes a shape and a bias only for ``bias_attr=True``; the shapes and
    the bias values equal the reference's."""
    paddle = _paddle()
    import paddlepaddle_tpu_torch as pt

    for kw in ({}, {"bias_attr": False}):
        j = paddle.nn.Linear(5, 3, **kw)
        t = pt.nn.Linear(5, 3, device="cpu", **kw)
        assert (t.bias is None) == (j.bias is None)
        if t.bias is not None:
            np.testing.assert_array_equal(t.bias.detach().numpy(),
                                          np.asarray(j.bias.numpy()))
        assert tuple(t.weight.shape) == tuple(j.weight.shape)
    for kw in ({}, {"bias_attr": True}):
        j = paddle.nn.RMSNorm([6], **kw)
        t = pt.nn.RMSNorm([6], device="cpu", **kw)
        assert (t.bias is None) == (j.bias is None)
        np.testing.assert_array_equal(t.weight.detach().numpy(),
                                      np.asarray(j.weight.numpy()))
    m = pt.MoELayer(8, 16, 2, None, 1.25, "ep", "gelu", "sorted",
                    device="cpu")
    assert m.dispatch_mode == "sorted"


def _masks(b, s, kind, seed=52):
    rng = np.random.default_rng(seed)
    if kind == "bool_padding":          # [b, 1, 1, s] key padding
        keep = np.ones((b, s), bool)
        keep[0, -3:] = False
        return keep[:, None, None, :]
    if kind == "bool_full":             # [b, 1, s, s], the diagonal kept
        m = rng.random((b, 1, s, s)) > 0.3
        return m | np.eye(s, dtype=bool)
    return np.where(rng.random((b, 1, s, s)) > 0.3, 0.0,          # additive
                    -2.5).astype(np.float32)


@pytest.mark.parametrize("kind", ["bool_padding", "bool_full", "float"])
@pytest.mark.parametrize("family", ["llama", "moe"])
def test_masked_forward_and_loss_match_jax(family, kind):
    """``model(ids, labels, attn_mask)`` against the JAX model on the same
    weights: logits 1e-5, the loss and its gradients 1e-5 (f32; other
    summation orders)."""
    import jax

    paddle = _paddle()
    from paddlepaddle_tpu.core import autograd as jag
    from paddlepaddle_tpu.core.dispatch import unwrap

    from paddlepaddle_tpu_torch import convert

    if family == "llama":
        from paddlepaddle_tpu.models import llama as jmod

        from paddlepaddle_tpu_torch.models import llama as tmod
        cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=64)
        paddle.seed(3)
        jm = jmod.LlamaForCausalLM(jmod.LlamaConfig(**cfg))
        tm = tmod.LlamaForCausalLM(tmod.LlamaConfig(**cfg), device="cpu")
    else:
        from paddlepaddle_tpu.models import moe as jmod

        from paddlepaddle_tpu_torch.models import moe as tmod
        paddle.seed(3)
        jcfg, tcfg = jmod.MoEConfig.tiny(), tmod.MoEConfig.tiny()
        jm = jmod.MoEForCausalLM(jcfg)
        tm = tmod.MoEForCausalLM(tcfg, device="cpu")
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    convert.load_jax_state(tm, state)
    b, s = 2, 12
    rng = np.random.default_rng(53)
    ids = rng.integers(0, 64, (b, s)).astype(np.int64)
    mask = _masks(b, s, kind)
    jlogits = jm(paddle.to_tensor(ids), attn_mask=paddle.to_tensor(mask))
    tlogits = tm(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits.numpy()), atol=1e-5,
                               rtol=0)
    params = jm.functional_state(trainable_only=True)
    buffers = {k: v for k, v in jm.functional_state().items()
               if k not in params}

    def loss_of(p):
        with jag.no_grad(), jm.bind_state({**p, **buffers}):
            return unwrap(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(ids),
                             attn_mask=paddle.to_tensor(mask)))

    jloss, jgrads = jax.value_and_grad(loss_of)(params)
    loss = tm(torch.from_numpy(ids), torch.from_numpy(ids),
              torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# C11: LlamaConfig in the reference's positional order
# ---------------------------------------------------------------------------


def test_llama_config_takes_reference_positional_order():
    """``LlamaConfig``'s fields are the reference's, in its order and with
    its defaults (``context_parallel_axis`` and ``data_parallel_axis``
    before ``recompute``), so a reference-order call binds alike: the 14th
    positional argument is ``recompute``. A context-parallel axis (ring
    attention) is taken, positionally too, as the reference takes it, and
    read by each attention call (``tests/test_torch_context_parallel.py``
    holds the values); ``MoEConfig`` keeps the reference's order too."""
    import inspect

    from paddlepaddle_tpu.models.llama import LlamaConfig as JConfig
    from paddlepaddle_tpu.models.moe import MoEConfig as JMoEConfig

    from paddlepaddle_tpu_torch import LlamaConfig, MoEConfig

    for port, ref in ((LlamaConfig, JConfig), (MoEConfig, JMoEConfig)):
        psig = inspect.signature(port).parameters
        rsig = inspect.signature(ref).parameters
        assert [(n, p.default) for n, p in psig.items()] == [
            (n, p.default) for n, p in rsig.items()]
    args = (256, 64, 192, 2, 4, 2, 128, 1e-6, 10000.0, False, "float32",
            None, None, True)
    port, ref = LlamaConfig(*args), JConfig(*args)
    assert port.recompute is True and ref.recompute is True
    assert port.remat_policy is None and ref.remat_policy is None
    assert LlamaConfig(*args[:13]).recompute is False
    assert LlamaConfig(*args, "dots").remat_policy == "dots"
    assert LlamaConfig().data_parallel_axis == JConfig().data_parallel_axis
    for cfg in (LlamaConfig(*args[:11], "sp"), JConfig(*args[:11], "sp")):
        assert cfg.context_parallel_axis == "sp"
        assert cfg.data_parallel_axis == "dp" and cfg.recompute is False
    port = LlamaConfig(context_parallel_axis="sp")
    ref = JConfig(context_parallel_axis="sp")
    names = inspect.signature(LlamaConfig).parameters
    assert [getattr(port, n) for n in names] == [getattr(ref, n)
                                                 for n in names]
