"""Activation recompute (``LlamaConfig.recompute`` / ``remat_policy`` and
``distributed.fleet.recompute``) against the port without recompute and
against the JAX package, on the CPU.

Tolerances, each with its reason:
* recompute against no recompute in the port: bit-equal — the recomputed
  forward runs the same ops on the same inputs in the same order, and a
  selective policy hands back the very tensors the forward computed;
* against the JAX package's ``recompute=True`` step: 1e-5 on the loss and
  the gradients (f32; the two frameworks sum in other orders, and the tied
  and untied tiny Llamas' losses and gradients agree to ~2e-6 without
  recompute, tests/test_torch_train.py).

``tests/test_torch_train_card.py`` checks kernel 2's launch count under
recompute on the card.
"""

import importlib

import numpy as np
import pytest
import torch
from torch import nn

import jax

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.core import autograd as jag
from paddlepaddle_tpu.core.dispatch import unwrap
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.core import random as prandom
from paddlepaddle_tpu_torch.distributed import fleet
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.nn import functional as TF

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)
POLICIES = [None, "dots", "dots_no_batch"]
trc = importlib.import_module(
    "paddlepaddle_tpu_torch.distributed.fleet.recompute")


def _models(policy, recompute=True, **over):
    cfg = dict(CFG, **over)
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg, recompute=recompute,
                                            remat_policy=policy))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    plain = tl.LlamaForCausalLM(tl.LlamaConfig(**cfg), device="cpu")
    remat = tl.LlamaForCausalLM(tl.LlamaConfig(**cfg, recompute=recompute,
                                               remat_policy=policy),
                                device="cpu")
    convert.load_jax_state(plain, state)
    convert.load_jax_state(remat, state)
    return jm, plain, remat


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (3, 16)).astype(np.int64)
    labels = ids.copy()
    labels[1, 4:7] = -100
    return ids, labels


def _loss_and_grads(model, ids, labels, mask=None):
    model.zero_grad()
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels),
                 None if mask is None else torch.from_numpy(mask))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in
                           model.named_parameters()}


def _jax_loss_and_grads(jm, ids, labels, mask=None):
    params = jm.functional_state(trainable_only=True)
    buffers = {k: v for k, v in jm.functional_state().items()
               if k not in params}

    def loss_of(p):
        with jag.no_grad(), jm.bind_state({**p, **buffers}):
            return unwrap(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(labels),
                             attn_mask=None if mask is None
                             else paddle.to_tensor(mask)))

    return jax.value_and_grad(loss_of)(params)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("masked", [False, True])
def test_recompute_bit_equal_to_no_recompute(policy, masked):
    _, plain, remat = _models(policy)
    ids, labels = _batch()
    mask = (np.tril(np.ones((16, 16), bool))[None, None]
            & (np.arange(16) > 2)[None, None, None, :]) if masked else None
    if mask is not None:
        mask = np.broadcast_to(mask | np.eye(16, dtype=bool), (3, 1, 16,
                                                                16)).copy()
    l0, g0 = _loss_and_grads(plain, ids, labels, mask)
    l1, g1 = _loss_and_grads(remat, ids, labels, mask)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), (policy, name)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_matches_jax_recompute(policy):
    jm, _, remat = _models(policy)
    ids, labels = _batch(1)
    jloss, jgrads = _jax_loss_and_grads(jm, ids, labels)
    loss, grads = _loss_and_grads(remat, ids, labels)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(g),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_bad_remat_policy_raises_the_reference_error():
    jm, _, remat = _models("bogus")
    ids, labels = _batch()
    with pytest.raises(ValueError) as jerr:
        jm(paddle.to_tensor(ids))
    with pytest.raises(ValueError) as terr:
        remat(torch.from_numpy(ids))
    assert str(terr.value) == str(jerr.value)
    assert "['dots', 'dots_no_batch'] or None" in str(terr.value)


def test_recompute_keeps_fewer_activations_and_policies_save_dots():
    """What the forward keeps for backward through autograd, in elements:
    less under recompute than without. What the backward recomputes, in
    matrix products (aten ``mm`` and ``bmm`` calls during ``backward()``):
    ``"dots"`` saves them all and reruns none, ``"dots_no_batch"`` reruns
    the batched ones (the plain attention's), the full remat reruns both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    ids, labels = _batch(2)
    kept, products = {}, {}
    for name, (policy, on) in {"none": (None, False), "full": (None, True),
                               "dots": ("dots", True),
                               "dots_no_batch": ("dots_no_batch",
                                                 True)}.items():
        _, _, m = _models(policy, recompute=on)
        total = [0]

        def pack(t):
            total[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = m(torch.from_numpy(ids), torch.from_numpy(labels))
        kept[name] = total[0]
        with Count() as c:
            loss.backward()
        products[name] = c.n
    assert kept["full"] < kept["none"], kept
    assert products["dots"] == products["none"], products
    assert products["dots_no_batch"]["mm"] == products["none"]["mm"]
    assert products["dots_no_batch"]["bmm"] > products["none"]["bmm"]
    assert products["full"]["mm"] > products["none"]["mm"]
    assert products["full"]["bmm"] == products["dots_no_batch"]["bmm"]


class _DropoutBlock(nn.Module):
    """Attention with dropout 0.3 over projections of x: the dropout mask is
    drawn from the port's streams (:mod:`core.random`)."""

    def __init__(self, rng_name=""):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.w = nn.Parameter(torch.randn(16, 3 * 16, generator=g) * 0.2)
        self.rng_name = rng_name

    def forward(self, x):
        q, k, v = (x @ self.w).reshape(2, 12, 3, 2, 8).unbind(2)
        out, _ = TF.flash_attention(q, k, v, dropout=0.3, causal=True,
                                    rng_name=self.rng_name)
        return out


@pytest.mark.parametrize("where", ["default", "named", "scope"])
def test_recomputed_dropout_draws_the_forward_mask(where):
    """A recomputed block with attention dropout: its gradients equal the
    un-recomputed block's from the same seed, although the stream moves on
    between the forward and the backward; the backward leaves every
    stream where it found it."""
    block = _DropoutBlock("attn" if where == "named" else "")
    x = torch.randn(2, 12, 16, generator=torch.Generator().manual_seed(4))
    scope_gen = prandom.Generator(99)

    def run(remat):
        prandom.seed(7)
        scope_gen.manual_seed(99)
        xr = x.clone().requires_grad_(True)
        if where == "scope":
            with prandom.generator_scope(scope_gen):
                y = fleet.recompute(block, xr) if remat else block(xr)
        else:
            y = fleet.recompute(block, xr) if remat else block(xr)
        # the streams move on before the backward
        torch.rand(5, generator=prandom.torch_generator("cpu"))
        torch.rand(5, generator=prandom.torch_generator("cpu", "attn"))
        torch.rand(5, generator=scope_gen.torch_generator("cpu"))
        before = (prandom.get_rng_state(), scope_gen.get_state())
        y.backward(torch.ones_like(y))
        after = (prandom.get_rng_state(), scope_gen.get_state())
        return y.detach(), xr.grad, block.w.grad.clone(), before, after

    block.w.grad = None
    y0, gx0, gw0, _, _ = run(False)
    block.w.grad = None
    y1, gx1, gw1, before, after = run(True)
    assert torch.equal(y0, y1)
    assert torch.equal(gx0, gx1) and torch.equal(gw0, gw1)
    assert (y0 == 0).any()                  # the dropout did drop
    for a, b in zip(before[0], after[0]):
        for k in a["states"]:
            assert torch.equal(a["states"][k], b["states"][k])
    for k in before[1]["states"]:
        assert torch.equal(before[1]["states"][k], after[1]["states"][k])


def test_plain_callable_runs_unrematted_and_sequential(monkeypatch):
    """A plain callable runs as it is (no checkpoint), as the reference's
    eager tape runs one; a module runs under the checkpoint;
    ``recompute_sequential`` chains segments and matches the plain chain."""
    calls = []
    real = trc._ckpt.checkpoint

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(trc._ckpt, "checkpoint", spy)
    lin = nn.Linear(4, 4)
    x = torch.randn(3, 4, requires_grad=True)
    fleet.recompute(lambda t: lin(t) * 2, x)
    assert not calls
    fleet.recompute(lin, x)
    assert len(calls) == 1
    with torch.no_grad():
        fleet.recompute(lin, x)
    assert len(calls) == 1
    layers = nn.Sequential(nn.Linear(4, 4), nn.Tanh(), nn.Linear(4, 4),
                           nn.Tanh())
    want = layers(x)
    got = fleet.recompute_sequential({"segments": 2}, layers, x)
    assert torch.equal(got, want)
    gw, = torch.autograd.grad(want.sum(), layers[0].weight)
    gg, = torch.autograd.grad(got.sum(), layers[0].weight)
    assert torch.equal(gw, gg)


@pytest.mark.parametrize("name", ["recompute", "recompute_sequential"])
def test_recompute_signature_matches_reference(name):
    import inspect

    from paddlepaddle_tpu.distributed.fleet import recompute as jrc

    t = inspect.signature(getattr(trc, name)).parameters
    j = inspect.signature(getattr(jrc, name)).parameters
    assert [(p.name, p.kind) for p in t.values()] == \
        [(p.name, p.kind) for p in j.values()]
