"""``F.cross_entropy``, ``softmax_with_cross_entropy``, the other functional
losses and the twelve loss layers against the JAX package on the CPU: the
same numpy inputs, values and gradients.

Tolerances, each with its reason:
* values and gradients: 2e-6 absolute plus 2e-6 relative — both sides
  compute in f32 with the same formulas, summed in other orders (a
  log-softmax over 11 classes, means over a few dozen rows);
* bf16 logits: the loss is computed in f32 from the same bf16 values on
  both sides, so the same 2e-6 holds for the value; the bf16 gradient to
  one bf16 ulp of ~0.1 (2^-10), one rounding of an f32 value that differs
  by a few ulps.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.core import autograd as jag
from paddlepaddle_tpu.core.dispatch import unwrap
from paddlepaddle_tpu.nn import functional as JF
from paddlepaddle_tpu.nn import loss as jloss
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.nn import functional as TF
from paddlepaddle_tpu_torch.nn import loss as tloss

ATOL = RTOL = 2e-6
N, C = 12, 11


def _jax_value_grad(fn, arrays, diff=(0,)):
    """Value of ``fn(*tensors)`` in the JAX package and its gradient with
    respect to the arrays at ``diff``."""
    def f(*diffs):
        vals = list(arrays)
        for i, d in zip(diff, diffs):
            vals[i] = d
        with jag.no_grad():
            return unwrap(fn(*(paddle.to_tensor(v) if isinstance(
                v, (np.ndarray, jax.Array)) else v for v in vals))).sum()

    val, grads = jax.value_and_grad(f, argnums=tuple(range(len(diff))))(
        *(jnp.asarray(arrays[i]) for i in diff))
    return np.asarray(val), [np.asarray(g, np.float32) for g in grads]


def _torch_value_grad(fn, arrays, diff=(0,)):
    ts = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a for a in arrays]
    for i in diff:
        ts[i] = ts[i].clone().requires_grad_(True)
    out = fn(*ts).sum()
    grads = torch.autograd.grad(out, [ts[i] for i in diff])
    return out.detach().numpy(), [g.float().numpy() for g in grads]


def _check(jfn, tfn, arrays, diff=(0,), atol=ATOL):
    jv, jg = _jax_value_grad(jfn, arrays, diff)
    tv, tg = _torch_value_grad(tfn, arrays, diff)
    np.testing.assert_allclose(tv, jv, atol=atol, rtol=RTOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=atol, rtol=RTOL)


def _logits(seed=0, shape=(N, C)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 2


def _labels(seed=1, ignore=True):
    lab = np.random.default_rng(seed).integers(0, C, (N,)).astype(np.int64)
    if ignore:
        lab[[2, 7]] = -100
    return lab


WEIGHT = np.linspace(0.5, 2.0, C).astype(np.float32)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_hard_labels(reduction, weighted, smoothing, ignore):
    """Hard labels over ``weight`` (the weighted mean divides by
    ``sum(w[label] * valid)``), ``ignore_index`` and ``label_smoothing``,
    for each ``reduction``: value and gradient."""
    arrays = [_logits(), _labels(ignore=ignore),
              WEIGHT if weighted else None]

    def jfn(x, lab, w):
        return JF.cross_entropy(x, lab, weight=w, reduction=reduction,
                                label_smoothing=smoothing)

    def tfn(x, lab, w):
        return TF.cross_entropy(x, lab, weight=w, reduction=reduction,
                                label_smoothing=smoothing)

    _check(jfn, tfn, arrays)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_cross_entropy_soft_labels(reduction, smoothing):
    soft = np.random.default_rng(3).random((N, C)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    for flag in (True, False):          # soft_label=True, or by shape
        _check(lambda x, t: JF.cross_entropy(
                   x, t, soft_label=flag, reduction=reduction,
                   label_smoothing=smoothing),
               lambda x, t: TF.cross_entropy(
                   x, t, soft_label=flag, reduction=reduction,
                   label_smoothing=smoothing),
               [_logits(4), soft], diff=(0, 1))


def test_cross_entropy_trailing_label_axis_probabilities_and_axis():
    lab = _labels(ignore=True)[:, None]
    _check(lambda x, t: JF.cross_entropy(x, t),
           lambda x, t: TF.cross_entropy(x, t), [_logits(5), lab])
    probs = np.random.default_rng(6).random((N, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    _check(lambda x, t: JF.cross_entropy(x, t, use_softmax=False),
           lambda x, t: TF.cross_entropy(x, t, use_softmax=False),
           [probs, _labels(ignore=False)])
    # a leading batch with the classes last, ignore_index other than -100
    x3 = _logits(7, (3, 4, C))
    lab3 = np.random.default_rng(8).integers(0, C, (3, 4)).astype(np.int64)
    lab3[0, 1] = 5
    _check(lambda x, t: JF.cross_entropy(x, t, ignore_index=5),
           lambda x, t: TF.cross_entropy(x, t, ignore_index=5), [x3, lab3])


def test_cross_entropy_bf16_logits_and_all_ignored():
    x = _logits(9)
    lab = _labels()
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    jv, jg = _jax_value_grad(lambda a, b: JF.cross_entropy(a, b), [jx, lab])
    tv = TF.cross_entropy(tx, torch.from_numpy(lab))
    tg, = torch.autograd.grad(tv, tx)
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(float(tv), float(jv), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tg.float().numpy(), jg[0], atol=2 ** -10,
                               rtol=0)
    none = TF.cross_entropy(torch.from_numpy(x),
                            torch.full((N,), -100, dtype=torch.long))
    assert float(none) == 0.0


def test_cross_entropy_agrees_with_the_model_loss():
    """``F.cross_entropy`` over the shifted labels equals the Llama
    ``loss_from_logits`` (ignored labels included)."""
    rng = np.random.default_rng(10)
    logits = torch.from_numpy(rng.standard_normal((2, 9, C)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, C, (2, 9)))
    labels[1, 4] = -100
    want = tl.loss_from_logits(logits, labels)
    nxt = labels[:, 1:]
    got = TF.cross_entropy(logits[:, :-1].reshape(-1, C), nxt.reshape(-1))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy(return_softmax):
    x, lab = _logits(11), _labels(12)[:, None]
    jout = JF.softmax_with_cross_entropy(paddle.to_tensor(x),
                                         paddle.to_tensor(lab),
                                         return_softmax=return_softmax)
    tout = TF.softmax_with_cross_entropy(torch.from_numpy(x),
                                         torch.from_numpy(lab),
                                         return_softmax=return_softmax)
    jouts = jout if return_softmax else (jout,)
    touts = tout if return_softmax else (tout,)
    for a, b in zip(touts, jouts):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   atol=ATOL, rtol=RTOL)


def _pos(seed, shape=(N, 5)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pm1(seed, n=N):
    return np.where(np.random.default_rng(seed).random(n) > 0.5, 1.0,
                    -1.0).astype(np.float32)


def _prob(seed, shape=(N, 5)):
    return np.random.default_rng(seed).uniform(0.05, 0.95, shape).astype(
        np.float32)


def _logp(seed):
    x = _pos(seed, (N, 5))
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


# name -> (arrays, differentiated positions, keywords)
LOSSES = {
    "mse_loss": (lambda: [_pos(1), _pos(2)], (0, 1), {}),
    "l1_loss": (lambda: [_pos(3), _pos(4)], (0, 1), {}),
    "smooth_l1_loss": (lambda: [_pos(5), _pos(6)], (0, 1), {"delta": 0.7}),
    "nll_loss": (lambda: [_logp(7), np.array(
        [0, 1, 2, 3, 4, -100, 1, 2, 3, 4, 0, 1], np.int64)], (0,), {}),
    "nll_loss_weighted": (lambda: [_logp(8), np.array(
        [0, 1, 2, 3, 4, -100, 1, 2, 3, 4, 0, 1], np.int64),
        np.linspace(0.5, 1.5, 5).astype(np.float32)], (0,), {}),
    "binary_cross_entropy": (lambda: [_prob(9), _prob(10)], (0,), {}),
    "binary_cross_entropy_with_logits": (
        lambda: [_pos(11), _prob(12)], (0,), {}),
    "binary_cross_entropy_with_logits_pos": (
        lambda: [_pos(13), _prob(14), None, "mean",
                 np.linspace(0.5, 3.0, 5).astype(np.float32)], (0,), {}),
    "kl_div": (lambda: [_logp(15), _prob(16)], (0,), {}),
    "kl_div_batchmean": (lambda: [_logp(17), _prob(18), "batchmean"], (0,),
                         {}),
    "kl_div_log_target": (lambda: [_logp(19), _logp(20)], (0, 1),
                          {"log_target": True}),
    "cosine_embedding_loss": (lambda: [_pos(21), _pos(22), _pm1(23)], (0, 1),
                              {"margin": 0.1}),
    "margin_ranking_loss": (lambda: [_pos(24, (N,)), _pos(25, (N,)),
                                     _pm1(26)], (0, 1), {"margin": 0.2}),
    "hinge_embedding_loss": (lambda: [_pos(27, (N,)), _pm1(28)], (0,), {}),
    "triplet_margin_loss": (lambda: [_pos(29), _pos(30), _pos(31)],
                            (0, 1, 2), {}),
    "triplet_margin_loss_swap": (lambda: [_pos(32), _pos(33), _pos(34)],
                                 (0, 1, 2), {"swap": True, "p": 1}),
}


# the cases that pass their reduction positionally run once, the rest for
# each reduction
FIXED = ("kl_div_batchmean", "binary_cross_entropy_with_logits_pos")
LOSS_CASES = [(c, r) for c in sorted(LOSSES)
              for r in ((None,) if c in FIXED else ("mean", "sum", "none"))]


@pytest.mark.parametrize("case,reduction", LOSS_CASES)
def test_functional_loss_matches_jax(case, reduction):
    make, diff, kw = LOSSES[case]
    arrays = make()
    fname = next(n for n in sorted(LOSSES, key=len, reverse=True)
                 if case.startswith(n) and hasattr(TF, n))
    kw = dict(kw)
    if reduction is not None:
        kw["reduction"] = reduction
    _check(lambda *a: getattr(JF, fname)(*a, **kw),
           lambda *a: getattr(TF, fname)(*a, **kw), arrays, diff)


LAYERS = {
    "CrossEntropyLoss": (dict(weight=None, label_smoothing=0.1),
                         lambda: [_logits(40), _labels(41)]),
    "MSELoss": ({}, lambda: [_pos(42), _pos(43)]),
    "L1Loss": ({"reduction": "sum"}, lambda: [_pos(44), _pos(45)]),
    "SmoothL1Loss": ({"delta": 0.5}, lambda: [_pos(46), _pos(47)]),
    "NLLLoss": ({}, lambda: [_logp(48), np.arange(N, dtype=np.int64) % 5]),
    "BCELoss": ({}, lambda: [_prob(49), _prob(50)]),
    "BCEWithLogitsLoss": ({}, lambda: [_pos(51), _prob(52)]),
    "KLDivLoss": ({"reduction": "batchmean"}, lambda: [_logp(53),
                                                       _prob(54)]),
    "CosineEmbeddingLoss": ({"margin": 0.1}, lambda: [_pos(55), _pos(56),
                                                      _pm1(57)]),
    "MarginRankingLoss": ({"margin": 0.3}, lambda: [_pos(58, (N,)),
                                                    _pos(59, (N,)),
                                                    _pm1(60)]),
    "HingeEmbeddingLoss": ({"margin": 0.5}, lambda: [_pos(61, (N,)),
                                                     _pm1(62)]),
    "TripletMarginLoss": ({"margin": 0.5}, lambda: [_pos(63), _pos(64),
                                                    _pos(65)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_loss_layer_matches_jax(name):
    kw, make = LAYERS[name]
    arrays = make()
    jlayer = getattr(jloss, name)(**kw)
    tlayer = getattr(tloss, name)(**kw)
    _check(lambda *a: jlayer(*a), lambda *a: tlayer(*a), arrays)


@pytest.mark.parametrize("name", sorted(LAYERS) + [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "smooth_l1_loss", "nll_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "cosine_similarity",
    "cosine_embedding_loss", "margin_ranking_loss", "hinge_embedding_loss",
    "triplet_margin_loss", "softmax", "log_softmax"])
def test_loss_signature_matches_reference(name):
    tobj = getattr(tloss, name, None) or getattr(TF, name)
    jobj = getattr(jloss, name, None) or getattr(JF, name)
    t = tobj.__init__ if inspect.isclass(tobj) else tobj
    j = jobj.__init__ if inspect.isclass(jobj) else jobj
    assert list(inspect.signature(t).parameters) == \
        list(inspect.signature(j).parameters), name
    assert [p.default for p in inspect.signature(t).parameters.values()] == \
        [p.default for p in inspect.signature(j).parameters.values()], name


def test_model_loss_matches_reference_loss_from_logits():
    rng = np.random.default_rng(70)
    logits = rng.standard_normal((2, 6, C)).astype(np.float32)
    labels = rng.integers(0, C, (2, 6)).astype(np.int64)
    labels[0, 2] = -100
    _check(lambda a, b: jl.LlamaForCausalLM.loss_from_logits(a, b),
           lambda a, b: tl.loss_from_logits(a, b), [logits, labels])


def _np_ce_axis1(x, lab, weight=None, ignore_index=-100, ls=0.0):
    """Paddle's hard-label cross entropy over axis 1 of ``[N, C, ...]`` in
    float64 numpy: ``-logp[label]`` mixed with the row's mean ``logp`` by
    ``ls``, ignored rows 0, the mean over ``weight[label]`` of valid rows
    (or their count)."""
    x = x.astype(np.float64)
    m = x.max(axis=1, keepdims=True)
    logp = x - m - np.log(np.exp(x - m).sum(axis=1, keepdims=True))
    valid = lab != ignore_index
    safe = np.where(valid, lab, 0)
    picked = np.take_along_axis(logp, safe[:, None], axis=1)[:, 0]
    if ls:
        picked = (1 - ls) * picked + ls * logp.mean(axis=1)
    loss = -picked * valid
    w = valid.astype(np.float64)
    if weight is not None:
        loss = loss * weight[safe]
        w = weight[safe] * valid
    return loss.sum() / w.sum()


@pytest.mark.parametrize("case", ["plain", "weight", "ignore_index",
                                  "label_smoothing"])
def test_cross_entropy_class_axis_1_against_numpy(case):
    """C15 (ROADMAP, the third reference divergence): with the classes on
    axis 1 of ``[2, 3, 6, 6]`` logits, the port gives Paddle's cross
    entropy (a numpy log-softmax over axis 1, within 2e-6); the reference's
    ``take_along_axis`` broadcasts the label's trailing axis against W and
    reads other entries, so its value differs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    lab = rng.integers(0, 3, size=(2, 6, 6)).astype(np.int64)
    kw, oracle = {}, {}
    if case == "weight":
        w = np.array([0.2, 1.0, 2.5], np.float32)
        kw["weight"], oracle["weight"] = w, w.astype(np.float64)
    elif case == "ignore_index":
        lab[0, :2] = 1
        lab[1, 3] = -1
        kw["ignore_index"] = oracle["ignore_index"] = -1
    elif case == "label_smoothing":
        kw["label_smoothing"] = oracle["ls"] = 0.1
    want = _np_ce_axis1(x, lab, **oracle)
    targs = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()}
    got = float(TF.cross_entropy(torch.tensor(x), torch.tensor(lab), axis=1,
                                 **targs))
    assert abs(got - want) <= ATOL + RTOL * abs(want), (got, want)
    jargs = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()}
    ref = float(np.asarray(unwrap(JF.cross_entropy(
        paddle.to_tensor(x), paddle.to_tensor(lab), axis=1, **jargs))))
    assert abs(ref - want) > 1e-2, (ref, want)
