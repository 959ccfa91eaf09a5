"""The rest of the model zoo (``paddlepaddle_tpu_torch.models``: ResNet,
BERT, GPT) against the JAX package on the CPU, weights carried across by
``convert.load_jax_state`` (strict), inputs from ``np.random.default_rng``,
dtypes pinned on both sides (the JAX package turns x64 on).

Tolerances, each with its reason:
* BERT and GPT (f32): logits and losses within 1e-5 of the reference's
  largest value; parameters after two AdamW ``TrainStep`` updates within
  1e-4 of each tensor's largest, except the key projections' biases: they
  shift every logit of a row alike, so their gradient is zero up to
  rounding and Adam moves them by up to ``lr`` a step in a direction set by
  that rounding; they are held to that bound. Greedy tokens exact.
* ResNet (f32, ``ResNet(BottleneckBlock, 50, width=16, num_classes=10)``,
  4 x 3 x 64 x 64): eval-mode logits within 1e-5 of the largest. In train
  mode layer4's batch norms normalise 16 values a channel, and a rounding
  difference flips the sign of pre-ReLU values near zero there: measured on
  this model, the JAX package's own f32 gradients are 4–5% of the largest
  gradient away from an f64 evaluation of the same network (and so are the
  port's), and moving the input by one f32 ulp moves the JAX step's
  second loss by 0.12 at lr 0.01. So each ``TrainStep`` update is held
  from a shared state (the port's parameters and momentum moved into the
  JAX step before each step): the step's loss within 5e-4 of its value,
  the update ``p1 - p0`` within 15% of its norm per tensor (the gradient
  noise above), the running statistics of the eager update within 5e-4 of
  each buffer's largest, and eval logits after training within 1e-5.
  Measured on the CPU: 8.2e-5 and 1.7e-5, 0.083 and 0.042, 1.2e-4 and
  4.0e-5 for the two steps.
"""

import copy

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.jit.train import TrainStep as JTrainStep
from paddlepaddle_tpu.models import bert as jb, gpt as jg, resnet as jr
from paddlepaddle_tpu.nn import functional as jF
from paddlepaddle_tpu.optimizer import AdamW as JAdamW, Momentum as JMomentum
from paddlepaddle_tpu_torch import AdamW, Momentum, TrainStep, convert
from paddlepaddle_tpu_torch import models as tmodels
from paddlepaddle_tpu_torch.models import bert as tb, gpt as tg, resnet as tr
from paddlepaddle_tpu_torch.nn import functional as tF


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.functional_state().items()}


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.detach().numpy().copy()
    return t


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", ["resnet18", "resnet50", "resnext50_32x4d",
                                   "wide_resnet50_2"])
def test_resnet_builders_have_the_reference_state(build):
    """Every parameter and buffer name and shape of the builders equals the
    reference's (``groups`` / ``width`` variants included)."""
    jm = getattr(jr, build)(num_classes=7)
    tm = getattr(tmodels, build)(num_classes=7, device="cpu")
    want = {k: tuple(v.shape) for k, v in jm.functional_state().items()}
    assert want == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert sum(1 for k in want if k.endswith("._mean")) == sum(
        1 for m in tm.modules() if isinstance(m, tmodels.resnet.BatchNorm2D))


def test_resnet_without_pool_or_head_and_basic_block_check():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    m = tmodels.resnet18(num_classes=0, with_pool=False, device="cpu")
    assert m(x).shape == (1, 512, 2, 2)
    with pytest.raises(ValueError):
        tr.BasicBlock(64, 64, groups=2, device="cpu")


def _resnet_pair():
    paddle.seed(0)
    jm = jr.ResNet(jr.BottleneckBlock, 50, width=16, num_classes=10)
    tm = tr.ResNet(tr.BottleneckBlock, 50, width=16, num_classes=10,
                   device="cpu")
    convert.load_jax_state(tm, _state(jm))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int64)
    return jm, tm, x, y


def _ce(model, x, y):
    return tF.cross_entropy(model(x), y).mean()


def _jce(model, x, y):
    return jF.cross_entropy(model(x), y).mean()


def test_resnet50_eval_forward_matches_reference():
    jm, tm, x, _ = _resnet_pair()
    assert sum(p.numel() for p in tm.parameters()) == 5_887_754
    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, jm(paddle.to_tensor(x)).numpy(), 1e-5)


def test_resnet50_train_steps_and_running_stats_match_reference():
    jm, tm, x, y = _resnet_pair()
    lr = 0.01
    jstep = JTrainStep(jm, JMomentum(learning_rate=lr, momentum=0.9,
                                     parameters=jm.parameters()), _jce,
                       donate=False)
    tstep = TrainStep(tm, Momentum(learning_rate=lr, momentum=0.9,
                                   parameters=tm.named_parameters()), _ce,
                      device="cpu")
    stat_names = [k for k in tm.state_dict()
                  if k.endswith(("._mean", "._variance"))]
    for _ in range(2):
        start = _numpy_tree(tstep.state_dict())
        start["opt_state"]["step"] = np.int32(start["opt_state"]["step"])
        jstep.set_state_dict(copy.deepcopy(start))
        sd = tm.state_dict()
        jm.set_state_dict({k: paddle.to_tensor(sd[k].numpy())
                           for k in stat_names})
        with paddle.no_grad():               # the reference's eager update
            jm(paddle.to_tensor(x))
        jloss = float(jstep(x, y).numpy())
        tloss = float(tstep(x, y))
        assert abs(tloss - jloss) <= 5e-4 * abs(jloss), (tloss, jloss)
        jparams = jstep.state_dict()["params"]
        for n, p in tm.named_parameters():
            moved = np.asarray(jparams[n]) - start["params"][n]
            diff = p.detach().numpy() - np.asarray(jparams[n])
            assert np.linalg.norm(diff) <= 0.15 * np.linalg.norm(moved), n
        jstats = jm.functional_state()
        for k in stat_names:
            _close(tm.state_dict()[k].numpy(), np.asarray(jstats[k]), 5e-4)
    assert tm.bn1._mean.abs().max() > 0      # the port's step updated them
    # eval over the trained state, the same in both packages
    jm.set_state_dict({k: paddle.to_tensor(v.numpy())
                       for k, v in tm.state_dict().items()})
    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, jm(paddle.to_tensor(x)).numpy(), 1e-5)


def test_reference_train_step_keeps_running_stats():
    """The divergence the port does not copy: the JAX ``TrainStep`` binds
    the buffers as constants, so its batch norms' running statistics never
    move; the port's step updates them in place, as the reference's eager
    forward does."""
    paddle.seed(0)
    jm = jr.resnet18(num_classes=4)
    tm = tmodels.resnet18(num_classes=4, device="cpu")
    convert.load_jax_state(tm, _state(jm))
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    y = np.array([0, 3], np.int64)
    jstep = JTrainStep(jm, JMomentum(0.01, 0.9, parameters=jm.parameters()),
                       _jce)
    jstep(x, y)
    assert float(np.abs(np.asarray(jstep.buffers["bn1._mean"])).max()) == 0
    TrainStep(tm, Momentum(0.01, 0.9, parameters=tm.named_parameters()),
              _ce, device="cpu")(x, y)
    assert float(tm.bn1._mean.abs().max()) > 0


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------


def _bert_pair(dropout=0.0):
    cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=128,
               max_position_embeddings=64, hidden_dropout_prob=dropout,
               attention_probs_dropout_prob=dropout)
    paddle.seed(3)
    jm = jb.BertForSequenceClassification(jb.BertConfig(**cfg))
    tm = tb.BertForSequenceClassification(tb.BertConfig(**cfg), device="cpu")
    convert.load_jax_state(tm, _state(jm))
    return jm, tm


def _bert_batch(seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (3, 12)).astype(np.int64)
    types = rng.integers(0, 2, (3, 12)).astype(np.int64)
    mask = np.ones((3, 12), np.int64)
    mask[1, 8:] = 0
    mask[2, 3:] = 0
    labels = rng.integers(0, 2, (3,)).astype(np.int64)
    return ids, types, mask, labels


def test_bert_configs_match_reference():
    for preset in ("base", "tiny"):
        assert vars(getattr(tb.BertConfig, preset)()) == vars(
            getattr(jb.BertConfig, preset)())


@pytest.mark.parametrize("with_types", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bert_forward_matches_reference(with_types, with_mask):
    jm, tm = _bert_pair(dropout=0.1)
    jm.eval()
    tm.eval()
    ids, types, mask, labels = _bert_batch()
    args = (types if with_types else None, mask if with_mask else None)
    want = jm(paddle.to_tensor(ids), *(None if a is None else
                                       paddle.to_tensor(a) for a in args))
    got = tm(torch.from_numpy(ids), *(None if a is None else
                                      torch.from_numpy(a) for a in args))
    _close(got.detach().numpy(), want.numpy(), 1e-5)
    jl = jm(*(paddle.to_tensor(a) for a in (ids, types, mask, labels)))
    tl = tm(*(torch.from_numpy(a) for a in (ids, types, mask, labels)))
    assert abs(float(tl) - float(jl.numpy())) <= 1e-5 * abs(float(jl.numpy()))


def _held_to_adam_bound(name):
    return name.endswith("self_attn.k_proj.bias")


def test_bert_train_steps_match_reference():
    jm, tm = _bert_pair()
    ids, types, mask, labels = _bert_batch()
    lr = 1e-3

    def loss(m, *b):
        return m(*b)

    jstep = JTrainStep(jm, JAdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jm.parameters()), loss)
    tstep = TrainStep(tm, AdamW(learning_rate=lr, weight_decay=0.01,
                                parameters=tm.named_parameters()), loss,
                      device="cpu")
    batch = (ids, types, mask, labels)
    for _ in range(2):
        jl = float(jstep(*batch).numpy())
        tl = float(tstep(*batch))
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    jparams = jstep.state_dict()["params"]
    for n, p in tm.named_parameters():
        want = np.asarray(jparams[n])
        if _held_to_adam_bound(n):
            assert np.abs(p.detach().numpy() - want).max() <= 2 * 2 * lr
        else:
            _close(p.detach().numpy(), want, 1e-4)


# ---------------------------------------------------------------------------
# GPT
# ---------------------------------------------------------------------------


def _gpt_pair(**over):
    cfg = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=48, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, **over)
    paddle.seed(5)
    jm = jg.GPTForCausalLM(jg.GPTConfig(**cfg))
    tm = tg.GPTForCausalLM(tg.GPTConfig(**cfg), device="cpu")
    convert.load_jax_state(tm, _state(jm))
    return jm, tm


def test_gpt_configs_match_reference():
    for preset in ("gpt2_small", "tiny"):
        assert vars(getattr(tg.GPTConfig, preset)()) == vars(
            getattr(jg.GPTConfig, preset)())


@pytest.mark.parametrize("tied", [True, False])
def test_gpt_logits_and_loss_match_reference(tied):
    jm, tm = _gpt_pair(tie_word_embeddings=tied)
    assert (tm.lm_head is None) == tied
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 96, (3, 20)).astype(np.int64)
    labels = ids.copy()
    labels[0, :4] = -100
    _close(tm(torch.from_numpy(ids)).detach().numpy(),
           jm(paddle.to_tensor(ids)).numpy(), 1e-5)
    jl = float(jm(paddle.to_tensor(ids), paddle.to_tensor(labels)).numpy())
    tl = float(tm(torch.from_numpy(ids), torch.from_numpy(labels)))
    assert abs(tl - jl) <= 1e-5 * abs(jl)


def test_gpt_train_steps_match_reference():
    jm, tm = _gpt_pair()
    ids = np.random.default_rng(7).integers(0, 96, (4, 16)).astype(np.int64)
    lr = 1e-3

    def loss(m, a, b):
        return m(a, b)

    jstep = JTrainStep(jm, JAdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jm.parameters()), loss)
    tstep = TrainStep(tm, AdamW(learning_rate=lr, weight_decay=0.01,
                                parameters=tm.named_parameters()), loss,
                      device="cpu")
    for _ in range(2):
        jl = float(jstep(ids, ids).numpy())
        tl = float(tstep(ids, ids))
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    jparams = jstep.state_dict()["params"]
    h = tm.config.hidden_size
    for n, p in tm.named_parameters():
        got, want = p.detach().numpy(), np.asarray(jparams[n])
        if n.endswith("qkv_proj.bias"):       # the key third: see above
            assert np.abs(got[h:2 * h] - want[h:2 * h]).max() <= 2 * 2 * lr
            got = np.concatenate([got[:h], got[2 * h:]])
            want = np.concatenate([want[:h], want[2 * h:]])
        _close(got, want, 1e-4)


def test_gpt_greedy_generate_equals_reference():
    jm, tm = _gpt_pair()
    prompt = np.random.default_rng(8).integers(0, 96, (3, 9)).astype(np.int32)
    want = np.asarray(jm.generate(paddle.to_tensor(prompt), max_new_tokens=12,
                                  temperature=0.0).numpy())
    got = tm.generate(prompt, max_new_tokens=12, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)
    # an eos pads each row after its first eos, as the reference's does
    eos = int(want[0, 12])
    want = np.asarray(jm.generate(paddle.to_tensor(prompt), max_new_tokens=12,
                                  temperature=0.0,
                                  eos_token_id=eos).numpy())
    got = tm.generate(prompt, max_new_tokens=12, temperature=0.0,
                      eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)


def test_gpt_refuses_sequences_past_its_positions():
    _, tm = _gpt_pair()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm(torch.zeros((1, 49), dtype=torch.long))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(np.zeros((1, 48), np.int32), 4)
