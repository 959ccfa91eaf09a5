"""AMP (``amp.auto_cast`` / ``decorate`` / ``GradScaler``) against the JAX
package on the CPU: the per-op casts by name, a tiny Llama's loss and
gradients under O1 and O2 in bf16 and fp16, recompute under ``auto_cast``,
and the loss scaler's skip / backoff / growth sequence.

Tolerances, each with its reason:
* op outputs: the same dtype on both sides exactly; values within 1e-6 in
  f32 and within 2 ulps of the low dtype relative to the largest output
  (bf16 2^-7, fp16 2^-10) — the two frameworks round the low-precision
  products and elementwise ops at other points;
* a tiny Llama's loss: 3e-2 absolute in bf16 and 8e-3 in fp16 on losses of
  ~5 (the rounding differences of two layers in the low dtype; measured
  at most 0.0144 and 0.0037, both with tied embeddings); gradients within
  5% (bf16) / 1% (fp16) of the largest gradient of each parameter: a
  gradient is a sum of low-precision products whose roundings differ
  (measured at most 1.7% / 0.18%);
* recompute against no recompute under ``auto_cast``: bit-equal (the same
  ops in the same order, the AMP state re-entered for the recompute);
* GradScaler: exact (the same Python float arithmetic on the scale; the
  parameters after the steps 1e-6, one Adam update's f32 ulps).
"""

import inspect
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu import amp as jamp
from paddlepaddle_tpu.core import autograd as jag
from paddlepaddle_tpu.core.dispatch import unwrap
from paddlepaddle_tpu.core.tensor import Parameter as JParameter
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu.nn import functional as JF
from paddlepaddle_tpu.optimizer.optimizers import AdamW as JAdamW
from paddlepaddle_tpu_torch import amp as tamp
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.nn import functional as TF
from paddlepaddle_tpu_torch.optimizer import AdamW

LOW = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2 ** -7),
       "float16": (torch.float16, jnp.float16, 2 ** -10)}
LEVELS = [("O1", "bfloat16"), ("O1", "float16"), ("O2", "bfloat16"),
          ("O2", "float16")]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tdt(jdtype):
    return {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
            jnp.float16: torch.float16}[jnp.dtype(jdtype).type]


# op name -> (JAX call, port call, inputs)
IDS = np.array([[1, 5, 7, 2]], np.int64)
LAB = np.array([[3, 1, -100, 2]], np.int64)
OPS = {
    "linear": (lambda x, w, b: JF.linear(x, w, b),
               lambda x, w, b: TF.linear(x, w, b),
               lambda: [_rand(1, (2, 4, 16)), _rand(2, (16, 8)),
                        _rand(3, (8,))]),
    "embedding": (lambda i, w: JF.embedding(i, w),
                  lambda i, w: TF.embedding(i, w),
                  lambda: [IDS, _rand(4, (10, 8))]),
    "rms_norm": (lambda x, w: JF.rms_norm(x, w),
                 lambda x, w: TF.rms_norm(x, w),
                 lambda: [_rand(5, (2, 4, 16)), _rand(6, (16,))]),
    "fused_rope": (lambda q, k, c, s: jl._apply_rope(q, k, c, s)[0],
                   lambda q, k, c, s: tl._apply_rope(q, k, c, s)[0],
                   lambda: [_rand(7, (1, 4, 2, 8)), _rand(8, (1, 4, 2, 8)),
                            np.cos(_rand(9, (16, 8))),
                            np.sin(_rand(9, (16, 8)))]),
    "flash_attention": (lambda q, k, v: JF.flash_attention(q, k, v,
                                                           causal=True)[0],
                        lambda q, k, v: TF.flash_attention(q, k, v,
                                                           causal=True)[0],
                        lambda: [_rand(10, (1, 6, 2, 8)),
                                 _rand(11, (1, 6, 2, 8)),
                                 _rand(12, (1, 6, 2, 8))]),
    "masked_attention": (lambda q, k, v, m: JF.scaled_dot_product_attention(
                             q, k, v, attn_mask=m, is_causal=True),
                         lambda q, k, v, m: TF.scaled_dot_product_attention(
                             q, k, v, attn_mask=m, is_causal=True),
                         lambda: [_rand(13, (1, 6, 2, 8)),
                                  _rand(14, (1, 6, 2, 8)),
                                  _rand(15, (1, 6, 2, 8)),
                                  np.where(_rand(16, (1, 1, 6, 6)) > 0, 0.0,
                                           -30.0).astype(np.float32)]),
    "cross_entropy": (lambda x, t: JF.cross_entropy(x, t),
                      lambda x, t: TF.cross_entropy(x, t),
                      lambda: [_rand(17, (4, 5)), np.array([0, 4, 2, -100],
                                                           np.int64)]),
    "loss_from_logits": (jl.LlamaForCausalLM.loss_from_logits,
                         tl.loss_from_logits,
                         lambda: [_rand(18, (1, 4, 6)), LAB]),
    "softmax": (lambda x: JF.softmax(x), lambda x: TF.softmax(x),
                lambda: [_rand(19, (3, 5))]),
    "log_softmax": (lambda x: JF.log_softmax(x), lambda x: TF.log_softmax(x),
                    lambda: [_rand(20, (3, 5))]),
    "swiglu_unnamed": (lambda x, y: JF.swiglu(x, y),
                       lambda x, y: TF.swiglu(x, y),
                       lambda: [_rand(21, (3, 8)), _rand(22, (3, 8))]),
    "swiglu_split_unnamed": (lambda x: JF.swiglu(x), lambda x: TF.swiglu(x),
                             lambda: [_rand(23, (3, 8))]),
    "mse_loss_unnamed": (lambda x, y: JF.mse_loss(x, y),
                         lambda x, y: TF.mse_loss(x, y),
                         lambda: [_rand(24, (3, 8)), _rand(25, (3, 8))]),
}


@pytest.mark.parametrize("inputs_low", [False, True])
@pytest.mark.parametrize("level,dtype", LEVELS)
@pytest.mark.parametrize("op", sorted(OPS))
def test_named_op_casts_like_the_reference(op, level, dtype, inputs_low):
    """Each op's output dtype and value under ``auto_cast``, from f32 inputs
    and from inputs already in the low dtype."""
    jcall, tcall, make = OPS[op]
    tlow, jlow, ulp = LOW[dtype]
    arrays = make()
    jin, tin = [], []
    for a in arrays:
        if a.dtype == np.float32 and inputs_low:
            jin.append(paddle.to_tensor(jnp.asarray(a, jlow)))
            tin.append(torch.from_numpy(a).to(tlow))
        else:
            jin.append(paddle.to_tensor(a))
            tin.append(torch.from_numpy(a))
    with jamp.auto_cast(level=level, dtype=dtype):
        want = jcall(*jin)
    with tamp.auto_cast(level=level, dtype=dtype):
        got = tcall(*tin)
    wd = _tdt(unwrap(want).dtype)
    assert got.dtype == wd, (op, level, dtype, got.dtype, wd)
    w = np.asarray(unwrap(want), np.float32)
    g = got.detach().float().numpy()
    tol = 1e-6 if wd == torch.float32 and not inputs_low else \
        2 * ulp * max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=op)


def test_off_and_o0_leave_every_op_alone():
    x = torch.from_numpy(_rand(30, (2, 16)))
    w = torch.from_numpy(_rand(31, (16, 4)))
    assert TF.linear(x, w).dtype == torch.float32
    with tamp.auto_cast(enable=False):
        assert TF.linear(x, w).dtype == torch.float32
    with tamp.auto_cast(level="O0"):
        assert TF.linear(x, w).dtype == torch.float32
    with tamp.auto_cast():
        assert TF.linear(x, w).dtype == torch.bfloat16
    assert TF.linear(x, w).dtype == torch.float32


def test_custom_lists_and_precedence_match_the_reference():
    """A custom white name casts at O1; a name both white and black is white
    at O1 and black at O2, on both sides; the lists last only for the
    block."""
    x = _rand(32, (2, 16))
    w = _rand(33, (16,))
    lw = _rand(34, (16, 4))
    for level, kw, op in (("O1", dict(custom_white_list=["rms_norm"]),
                           "rms_norm"),
                          ("O1", dict(custom_black_list=["linear"]),
                           "linear"),
                          ("O2", dict(custom_black_list=["linear"]),
                           "linear")):
        with jamp.auto_cast(level=level, **kw):
            if op == "rms_norm":
                want = JF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w))
            else:
                want = JF.linear(paddle.to_tensor(x), paddle.to_tensor(lw))
        with tamp.auto_cast(level=level, **kw):
            if op == "rms_norm":
                got = TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
            else:
                got = TF.linear(torch.from_numpy(x), torch.from_numpy(lw))
        assert got.dtype == _tdt(unwrap(want).dtype), (level, kw)
    with tamp.auto_cast():
        assert TF.rms_norm(torch.from_numpy(x),
                           torch.from_numpy(w)).dtype == torch.float32


def test_amp_state_is_per_thread():
    seen = {}
    x = torch.from_numpy(_rand(35, (2, 16)))
    w = torch.from_numpy(_rand(36, (16, 4)))

    def other():
        seen["other"] = TF.linear(x, w).dtype

    with tamp.auto_cast():
        t = threading.Thread(target=other)
        t.start()
        t.join()
        seen["main"] = TF.linear(x, w).dtype
    assert seen == {"other": torch.float32, "main": torch.bfloat16}


# -- a tiny Llama under auto_cast ------------------------------------------

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)
LOSS_TOL = {"bfloat16": 3e-2, "float16": 8e-3}
GRAD_TOL = {"bfloat16": 0.05, "float16": 0.01}


def _llamas(level, dtype, **over):
    cfg = dict(CFG, **over)
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**cfg), device="cpu")
    convert.load_jax_state(tm, state)
    if level == "O2":
        jamp.decorate(jm, level="O2", dtype=dtype)
        tamp.decorate(tm, level="O2", dtype=dtype)
    return jm, tm


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (2, 12)).astype(np.int64)
    labels = ids.copy()
    labels[0, 3] = -100
    return ids, labels


def _jax_amp_loss_grads(jm, ids, labels, level, dtype):
    params = jm.functional_state(trainable_only=True)
    buffers = {k: v for k, v in jm.functional_state().items()
               if k not in params}

    def loss_of(p):
        with jag.no_grad(), jm.bind_state({**p, **buffers}), \
                jamp.auto_cast(level=level, dtype=dtype):
            return unwrap(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(labels)))

    return jax.value_and_grad(loss_of)(params)


def _port_amp_loss_grads(tm, ids, labels, level, dtype):
    tm.zero_grad()
    with tamp.auto_cast(level=level, dtype=dtype):
        loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in
                           tm.named_parameters()}


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("level,dtype", LEVELS)
def test_tiny_llama_loss_and_grads_match_jax(level, dtype, tied):
    jm, tm = _llamas(level, dtype, tie_word_embeddings=tied)
    ids, labels = _ids()
    jloss, jgrads = _jax_amp_loss_grads(jm, ids, labels, level, dtype)
    loss, grads = _port_amp_loss_grads(tm, ids, labels, level, dtype)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss),
                               atol=LOSS_TOL[dtype], rtol=0)
    for name, g in jgrads.items():
        g = np.asarray(g, np.float32)
        got = grads[name]
        assert got.dtype == _tdt(jgrads[name].dtype), name
        err = float(np.abs(got.float().numpy() - g).max())
        assert err <= GRAD_TOL[dtype] * float(np.abs(g).max()), (name, err)


@pytest.mark.parametrize("policy", [None, "dots"])
@pytest.mark.parametrize("level,dtype", LEVELS)
def test_recompute_under_auto_cast_is_bit_equal(level, dtype, policy):
    """Trouble spot (b): the recompute runs inside ``backward()``, outside
    the ``auto_cast`` block, and re-enters the forward's AMP state."""
    _, plain = _llamas(level, dtype)
    _, remat = _llamas(level, dtype, recompute=True, remat_policy=policy)
    ids, labels = _ids(1)
    l0, g0 = _port_amp_loss_grads(plain, ids, labels, level, dtype)
    l1, g1 = _port_amp_loss_grads(remat, ids, labels, level, dtype)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_decorate_o2_casts_in_place_and_sets_masters():
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**CFG), device="cpu")
    params = list(tm.parameters())
    opt = AdamW(parameters=tm.named_parameters())
    m, o = tamp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert m is tm and o is opt and opt._multi_precision is True
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(a is b for a, b in zip(params, tm.parameters()))
    assert tamp.decorate(tm, level="O1") is tm
    opt2 = AdamW(parameters=tm.named_parameters())
    tamp.decorate(tm, opt2, level="O2", master_weight=False)
    assert opt2._multi_precision is False
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()
    assert tamp.amp_guard is tamp.auto_cast


# -- GradScaler ---------------------------------------------------------------

def test_grad_scaler_sequence_matches_jax():
    """Skip, backoff and growth against the JAX scaler over one sequence of
    gradients (finite, inf, finite, finite, nan, finite x 3), with
    ``incr_every_n_steps=2``: the same scale, counters and parameters after
    every step; a skipped step leaves the parameters, the f32 masters and
    the slots untouched."""
    rng = np.random.default_rng(40)
    init = rng.standard_normal((4, 3)).astype(np.float32)
    kinds = ["ok", "inf", "ok", "ok", "nan", "ok", "ok", "ok"]
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jp = [JParameter(init.copy(), name="w")]
    tp = {"w": torch.nn.Parameter(torch.from_numpy(init.copy()))}
    jo = JAdamW(learning_rate=0.01, parameters=jp)
    to = AdamW(learning_rate=0.01, parameters=tp)
    scales = []
    for i, kind in enumerate(kinds):
        g = rng.standard_normal((4, 3)).astype(np.float32) * ts._scale
        if kind != "ok":
            g[1, 2] = np.inf if kind == "inf" else np.nan
        jp[0].grad = jnp.asarray(g)
        tp["w"].grad = torch.from_numpy(g.copy())
        before = {k: v.clone() for k, v in to.state_dict().items()
                  if isinstance(v, torch.Tensor)}
        w_before = tp["w"].detach().clone()
        js.step(jo)
        js.update()
        ts.step(to)
        ts.update()
        scales.append(ts._scale)
        assert ts.state_dict() == js.state_dict(), i
        np.testing.assert_allclose(tp["w"].detach().numpy(),
                                   np.asarray(jp[0].numpy()), atol=1e-6,
                                   rtol=0)
        if kind != "ok":
            assert torch.equal(tp["w"], w_before)
            after = to.state_dict()
            for k, v in before.items():
                assert torch.equal(after[k], v), k
    assert scales == [1024.0, 512.0, 512.0, 1024.0, 512.0, 512.0, 1024.0,
                      1024.0]
    assert float(ts.get_loss_scaling()) == 1024.0


def test_grad_scaler_unscale_bf16_masters_and_state_dict():
    """``unscale_`` multiplies in f32 by 1/scale and casts back; a skipped
    step leaves a bf16 parameter, its f32 master and its slots untouched;
    ``state_dict`` / ``load_state_dict`` carry the scale and counters."""
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    o = AdamW(learning_rate=0.1, parameters={"p": p}, multi_precision=True)
    s = tamp.GradScaler(init_loss_scaling=8.0)
    loss = (p.float() * torch.tensor([1.0, 2.0, 3.0])).sum()
    s.scale(loss).backward()
    assert torch.equal(p.grad, torch.tensor([8.0, 16.0, 24.0],
                                            dtype=torch.bfloat16))
    s.unscale_(o)
    assert torch.equal(p.grad, torch.tensor([1.0, 2.0, 3.0],
                                            dtype=torch.bfloat16))
    s.step(o)
    stepped = {k: v.clone() for k, v in o.state_dict().items()
               if isinstance(v, torch.Tensor)}
    p.grad = torch.tensor([1.0, float("inf"), 0.0], dtype=torch.bfloat16)
    w = p.detach().clone()
    s.step(o)
    assert torch.equal(p, w) and s._scale == 4.0
    for k, v in stepped.items():
        assert torch.equal(o.state_dict()[k], v), k
    fresh = tamp.GradScaler()
    fresh.load_state_dict(s.state_dict())
    assert fresh.state_dict() == s.state_dict()
    off = tamp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()


@pytest.mark.parametrize("name", ["auto_cast", "decorate", "GradScaler",
                                  "is_bfloat16_supported",
                                  "is_float16_supported"])
def test_amp_signature_matches_reference(name):
    t, j = getattr(tamp, name), getattr(jamp, name)
    t = t.__init__ if inspect.isclass(t) else getattr(t, "__wrapped__", t)
    j = j.__init__ if inspect.isclass(j) else getattr(j, "__wrapped__", j)
    ts, js = inspect.signature(t), inspect.signature(j)
    assert [(p.name, p.default) for p in ts.parameters.values()] == \
        [(p.name, p.default) for p in js.parameters.values()], name
