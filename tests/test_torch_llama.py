"""Port Llama (paddlepaddle_tpu_torch/models/llama.py + convert.py) against
the JAX model on the same weights and inputs.

Tolerances, each with its reason:
* rope tables: 1e-6 absolute — the fp32 power/cos/sin of two libraries
  may differ by an ulp;
* rms_norm f32: 1e-6;
* full-model logits at fp32: 1e-4 absolute — matmul summation order
  differs between XLA and PyTorch over two layers;
* full-model logits at bf16: 0.05 absolute on logits of magnitude ~3 —
  bf16 rounds at different points in the two frameworks (XLA may fuse an
  elementwise chain in f32 before one rounding, PyTorch rounds after each
  op); one bf16 ulp at that magnitude is 0.016, and 0.05 allows three. The
  f32 check is the one that pins the algorithm;
* ``_cached_attention``: 2e-6 at fp32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu.nn import functional as jF
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.nn import functional as tF

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96)


def _pair(dtype="float32", **over):
    cfg = dict(CFG, dtype=dtype, **over)
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**cfg), device="cpu")
    convert.load_jax_state(tm, state)
    return jm, tm, state


@pytest.mark.parametrize("dtype,over", [
    ("float32", {}),
    ("bfloat16", {}),
    ("float32", {"tie_word_embeddings": True}),
])
def test_convert_round_trip(dtype, over):
    _, tm, state = _pair(dtype, **over)
    sd = tm.state_dict()
    assert set(sd) == set(state) - set(convert.SKIPPED)
    for name, t in sd.items():
        back = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        ref = state[name].view(np.int16) if t.dtype == torch.bfloat16 \
            else state[name]
        np.testing.assert_array_equal(back, ref, err_msg=name)
    # the skipped rope buffers: recomputed by the port, equal to the JAX ones
    np.testing.assert_allclose(tm.model.rope_cos.numpy(),
                               state["model.rope_cos"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm.model.rope_sin.numpy(),
                               state["model.rope_sin"], atol=1e-6, rtol=0)


def test_rope_tables_llama3_theta():
    c_j, s_j = jl.rope_tables(128, 8192, 500000.0)
    c_t, s_t = tl.rope_tables(128, 8192, 500000.0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    want = jF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w),
                       epsilon=1e-6).numpy()
    got = tF.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_logits_match_jax(dtype, atol):
    jm, tm, _ = _pair(dtype)
    ids = np.random.default_rng(3).integers(0, 128, (2, 23)).astype(np.int32)
    want = np.asarray(jnp.asarray(jm(paddle.to_tensor(ids)).numpy(),
                                  jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids.astype(np.int64))).float().numpy()
    assert got.shape == want.shape == (2, 23, 128)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if dtype == "float32":
        assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("per_row", [False, True])
def test_cached_attention_prefill_matches_jax(per_row):
    rng = np.random.default_rng(5)
    b, s, h, kvh, d, L = 3, 4, 4, 2, 16, 12
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    vn = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    kc = rng.standard_normal((b, L, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((b, L, kvh, d)).astype(np.float32)
    pos = np.asarray([0, 3, 8], np.int32) if per_row else 2
    jo, jk, jv = jl._cached_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos, jnp.int32), 2, 0.25)
    tpos = torch.from_numpy(pos) if per_row else pos
    to, tk, tv = tl._cached_attention(
        *(torch.from_numpy(a) for a in (q, kn, vn, kc.copy(), vc.copy())),
        tpos, 2, 0.25)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6, rtol=0)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_apply_rope_per_row_offsets_match_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 2, 16)).astype(np.float32)
    cos, sin = jl.rope_tables(16, 32, 10000.0)
    off = np.asarray([0, 5, 30], np.int32)
    jq, jk = jl._apply_rope(paddle.to_tensor(q), paddle.to_tensor(k),
                            paddle.to_tensor(np.asarray(cos)),
                            paddle.to_tensor(np.asarray(sin)),
                            offset=jnp.asarray(off))
    tc, ts = tl.rope_tables(16, 32, 10000.0)
    tq, tk = tl._apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts,
                            offset=torch.from_numpy(off))
    np.testing.assert_allclose(tq.numpy(), jq.numpy(), atol=2e-6, rtol=0)
    np.testing.assert_allclose(tk.numpy(), jk.numpy(), atol=2e-6, rtol=0)
