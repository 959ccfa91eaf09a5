"""The port's training path (loss, gradients, AdamW, clip, LR schedule,
TrainStep, resume) against the JAX package on the CPU, on a tiny Llama whose
weights are carried across with ``convert.load_jax_state``.

Tolerances, each with its reason:
* fp32 loss: 2e-6 absolute plus 1e-6 relative — the two frameworks sum the
  matmuls and the vocabulary's log-sum-exp in other orders (a few f32 ulps;
  tied embeddings give losses of ~43);
* fp32 gradients: 2e-6 absolute on gradients up to ~0.1 — the same orders,
  carried back through two layers;
* one optimizer update: 1e-6 absolute on parameters of ~1 — the update rule
  is the same f32 arithmetic op for op, but the decay factor ``1 - lr*wd`` is
  formed in double on the port's side and in f32 on the reference's (one
  f32 ulp of the factor), and the global norm sums in another order;
* TrainStep parameters after 3 steps: 1e-4 absolute (a tenth of one step's
  move) — Adam moves a weight by ``lr * m / (sqrt(v) + eps)``, which for a
  gradient near zero amplifies its f32 rounding noise (measured: one element
  in 4096 off by 4.5e-5, the rest within 1e-6); losses 2e-5;
* bf16: 3e-2 absolute on losses of ~5.5 — bf16 rounds at other points in
  the two frameworks (see tests/test_torch_llama.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.core import autograd as jag
from paddlepaddle_tpu.core.dispatch import unwrap
from paddlepaddle_tpu.core.tensor import Parameter as JParameter
from paddlepaddle_tpu.jit.train import TrainStep as JTrainStep
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddlepaddle_tpu.optimizer import lr as jlr
from paddlepaddle_tpu.optimizer.optimizers import AdamW as JAdamW
from paddlepaddle_tpu_torch import ClipGradByGlobalNorm, TrainStep, convert
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.optimizer import AdamW, lr as tlr

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)


def _pair(dtype="float32", **over):
    cfg = dict(CFG, dtype=dtype, **over)
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**cfg), device="cpu", seed=7)
    convert.load_jax_state(tm, state)
    return jm, tm


def _batch(b=4, s=16, ignore=True, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (b, s)).astype(np.int32)
    labels = ids.copy()
    if ignore:
        labels[0, 3:6] = -100
        labels[2, -4:] = -100
    return ids, labels


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.mark.parametrize("over", [{}, {"tie_word_embeddings": True}])
def test_loss_and_grads_match_jax(over):
    jm, tm = _pair(**over)
    ids, labels = _batch()
    params = jm.functional_state(trainable_only=True)
    buffers = {k: v for k, v in jm.functional_state().items()
               if k not in params}

    def loss_of(p):
        with jag.no_grad(), jm.bind_state({**p, **buffers}):
            return unwrap(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(labels)))

    jloss, jgrads = jax.value_and_grad(loss_of)(params)
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-6,
                               rtol=1e-6)
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(_np(named[name].grad), np.asarray(g),
                                   atol=2e-6, rtol=0, err_msg=name)


def test_loss_from_logits_masks_and_all_ignored():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6)).astype(np.int64)
    labels[1, 2] = -100
    want = jl.LlamaForCausalLM.loss_from_logits(
        paddle.to_tensor(logits), paddle.to_tensor(labels)).numpy()
    got = tl.loss_from_logits(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    none = tl.loss_from_logits(torch.from_numpy(logits),
                               torch.full((2, 6), -100))
    assert float(none) == 0.0


def test_ce_rows_backward_keeps_no_f32_vocab_residual():
    """The CE Function saves the logits and the [B, S] lse only, and its
    gradient equals autograd's through a plain f32 log-softmax."""
    rng = np.random.default_rng(2)
    lg = torch.from_numpy(rng.standard_normal((2, 5, 13)).astype(np.float32)) \
        .to(torch.bfloat16).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, 13, (2, 5)))
    g = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        nll = tl._CERows.apply(lg, labels)
    assert (torch.float32, (2, 5, 13)) not in saved
    got, = torch.autograd.grad(nll, lg, g)
    lg2 = lg.detach().clone().requires_grad_(True)
    ref = -torch.log_softmax(lg2.float(), -1).gather(-1, labels[..., None])[..., 0]
    want, = torch.autograd.grad(ref, lg2, g)
    torch.testing.assert_close(nll, ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(got.float(), want.float(), atol=8e-3, rtol=0)


def _opt_params(rng, names):
    shapes = {"w": (8, 4), "norm.weight": (4,), "b": (3,)}
    return {n: rng.standard_normal(shapes[n]).astype(np.float32)
            for n in names}


@pytest.mark.parametrize("decay_fun,clip,amsgrad", [
    (False, None, False),
    (True, 0.5, False),
    (True, 0.5, True),
])
def test_adamw_update_matches_jax(decay_fun, clip, amsgrad):
    """Two updates of the port's ``AdamW.apply`` against the JAX optimizer's
    eager step (the reference path that honours ``apply_decay_param_fun``)
    on named parameters, with and without the global-norm clip."""
    rng = np.random.default_rng(3)
    names = ["w", "norm.weight", "b"]
    init = _opt_params(rng, names)
    grads = [_opt_params(rng, names) for _ in range(2)]
    fun = (lambda n: "norm" not in n) if decay_fun else None
    kw = dict(learning_rate=0.01, weight_decay=0.1,
              apply_decay_param_fun=fun, amsgrad=amsgrad)
    jparams = [JParameter(init[n], name=n) for n in names]
    jopt = JAdamW(parameters=jparams,
                  grad_clip=JClip(clip) if clip else None, **kw)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(init[n].copy()))
               for n in names}
    topt = AdamW(parameters=tparams,
                 grad_clip=ClipGradByGlobalNorm(clip) if clip else None, **kw)
    for g in grads:
        for p in jparams:
            p.grad = jnp.asarray(g[p.name], jnp.float32)
        jopt.step()
        topt.apply([torch.from_numpy(g[n].copy()) for n in names])
    for p in jparams:
        np.testing.assert_allclose(_np(tparams[p.name]), p.numpy(),
                                   atol=1e-6, rtol=0, err_msg=p.name)
    if decay_fun:   # the excluded parameter moved by the Adam rule only
        assert not np.allclose(_np(tparams["norm.weight"]), init["norm.weight"])
    sd = topt.state_dict()
    assert sd["@step"] == 2 and "w_moment1" in sd
    assert ("w_moment2_max" in sd) is amsgrad


def test_optimizer_state_dict_round_trip():
    """The flat paddle-style ``state_dict`` carries slots, masters and the
    step count into a fresh optimizer: the next update is identical."""
    rng = np.random.default_rng(6)
    init = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2)]
    pa = {"w": torch.nn.Parameter(torch.from_numpy(init.copy())
                                  .to(torch.bfloat16))}
    oa = AdamW(learning_rate=0.01, parameters=pa, multi_precision=True)
    oa.apply([torch.from_numpy(grads[0]).to(torch.bfloat16)])
    pb = {"w": torch.nn.Parameter(pa["w"].detach().clone())}
    ob = AdamW(learning_rate=0.01, parameters=pb, multi_precision=True)
    sd = oa.state_dict()
    assert sd["w_master"].dtype == torch.float32 and sd["@step"] == 1
    ob.set_state_dict(sd)
    for o, p in ((oa, pa), (ob, pb)):
        o.apply([torch.from_numpy(grads[1]).to(torch.bfloat16)])
    assert torch.equal(pa["w"], pb["w"])
    assert torch.equal(oa.state_dict()["w_master"],
                       ob.state_dict()["w_master"])


def test_clip_scale_and_bf16_rounding():
    g32 = torch.tensor([3.0, 4.0])
    g16 = torch.tensor([[0.0, 12.0]], dtype=torch.bfloat16)
    ClipGradByGlobalNorm(1.0).clip_grads([g32, None, g16])
    norm = 13.0
    torch.testing.assert_close(g32, torch.tensor([3.0, 4.0]) / norm)
    assert g16.dtype == torch.bfloat16
    torch.testing.assert_close(
        g16, (torch.tensor([[0.0, 12.0]]) / norm).to(torch.bfloat16))
    small = torch.tensor([0.1, 0.2])
    ClipGradByGlobalNorm(1.0).clip_grads([small])
    torch.testing.assert_close(small, torch.tensor([0.1, 0.2]))


def test_linear_warmup_cosine_schedule_matches_jax():
    j = jlr.LinearWarmup(jlr.CosineAnnealingDecay(3e-4, T_max=15, eta_min=1e-5),
                         warmup_steps=5, start_lr=0.0, end_lr=3e-4)
    t = tlr.LinearWarmup(tlr.CosineAnnealingDecay(3e-4, T_max=15, eta_min=1e-5),
                         warmup_steps=5, start_lr=0.0, end_lr=3e-4)
    got, want = [], []
    for _ in range(20):
        got.append(t())
        want.append(j())
        t.step()
        j.step()
    assert got == want
    assert got[0] == 0.0 and got[5] == pytest.approx(3e-4)
    again = tlr.LinearWarmup(tlr.CosineAnnealingDecay(3e-4, T_max=15,
                                                      eta_min=1e-5),
                             warmup_steps=5, start_lr=0.0, end_lr=3e-4)
    again.set_state_dict(t.state_dict())
    assert again() == t() and again.last_epoch == 20


def _jax_step(jm, lr=1e-3, accum=1):
    opt = JAdamW(learning_rate=lr, parameters=jm.parameters(),
                 weight_decay=0.01, grad_clip=JClip(1.0))
    return JTrainStep(jm, opt, _loss_fn, grad_accum_steps=accum)


def _port_step(tm, lr=1e-3, accum=1, **kw):
    opt = AdamW(learning_rate=lr, parameters=tm.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    return TrainStep(tm, opt, _loss_fn, grad_accum_steps=accum, device="cpu")


def test_train_step_three_fp32_steps_match_jax():
    jm, tm = _pair()
    ids, labels = _batch()
    jstep, tstep = _jax_step(jm), _port_step(tm)
    for _ in range(3):
        jl_ = float(jstep(ids, labels).numpy())
        tl_ = float(tstep(ids, labels))
        np.testing.assert_allclose(tl_, jl_, atol=2e-5, rtol=0)
    jparams = jstep.state_dict()["params"]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), jparams[name], atol=1e-4, rtol=0,
                                   err_msg=name)
    assert tstep.state_dict()["opt_state"]["step"] == 3


def test_grad_accum_two_equals_one():
    """Equal valid-token counts per microbatch, so the mean of the two
    microbatch means is the full-batch mean: same loss and same update."""
    _, tm1 = _pair()
    _, tm2 = _pair()
    ids, labels = _batch(ignore=False)
    s1, s2 = _port_step(tm1), _port_step(tm2, accum=2)
    for _ in range(2):
        l1, l2 = float(s1(ids, labels)), float(s2(ids, labels))
        np.testing.assert_allclose(l2, l1, atol=2e-6, rtol=0)
    for (name, p1), p2 in zip(tm1.named_parameters(), tm2.parameters()):
        np.testing.assert_allclose(_np(p2), _np(p1), atol=1e-5, rtol=0,
                                   err_msg=name)
    with pytest.raises(ValueError, match="divisible"):
        s2(ids[:3], labels[:3])


def test_bf16_multi_precision_step():
    jm, tm = _pair("bfloat16")
    ids, labels = _batch()
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(tm, opt, _loss_fn, device="cpu")
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  multi_precision=True, grad_clip=JClip(1.0))
    jstep = JTrainStep(jm, jopt, _loss_fn)
    for _ in range(2):
        np.testing.assert_allclose(float(step(ids, labels)),
                                   float(jstep(ids, labels).numpy()),
                                   atol=3e-2, rtol=0)
    state = step.state_dict()
    for name, p in tm.named_parameters():
        m = state["opt_state"]["master"][name]
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(m.to(torch.bfloat16), p.detach()), name
        assert state["opt_state"]["slots"][name]["moment1"].dtype \
            == torch.float32


def test_resume_from_jax_train_state():
    """2 JAX steps, then the state carried into the port and 1 port step,
    equals 3 JAX steps (bf16 masters included)."""
    jm, _ = _pair()
    _, tm = _pair()
    with torch.no_grad():                 # the resume must overwrite these
        for p in tm.parameters():
            p.normal_()
    ids, labels = _batch(seed=4)
    jstep = _jax_step(jm)
    jstep(ids, labels)
    jstep(ids, labels)
    tstep = _port_step(tm)
    convert.load_jax_train_state(tstep, jstep.state_dict())
    assert tstep.state_dict()["opt_state"]["step"] == 2
    jl3 = float(jstep(ids, labels).numpy())
    tl3 = float(tstep(ids, labels))
    np.testing.assert_allclose(tl3, jl3, atol=2e-5, rtol=0)
    jparams = jstep.state_dict()["params"]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), jparams[name], atol=1e-4, rtol=0,
                                   err_msg=name)


def test_resume_bf16_masters_from_jax():
    jm, tm = _pair("bfloat16")
    ids, labels = _batch(seed=5)
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  multi_precision=True)
    jstep = JTrainStep(jm, jopt, _loss_fn)
    jstep(ids, labels)
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                multi_precision=True)
    tstep = TrainStep(tm, opt, _loss_fn, device="cpu")
    jsd = jstep.state_dict()
    convert.load_jax_train_state(tstep, jsd)
    state = tstep.state_dict()["opt_state"]
    for name, m in jsd["opt_state"]["master"].items():
        np.testing.assert_array_equal(_np(state["master"][name]),
                                      np.asarray(m), err_msg=name)
        np.testing.assert_array_equal(
            _np(state["slots"][name]["moment2"]),
            np.asarray(jsd["opt_state"]["slots"][name]["moment2"]))


def test_train_step_refuses_other_device():
    _, tm = _pair()
    opt = AdamW(parameters=tm.named_parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TrainStep(tm, opt, _loss_fn)
