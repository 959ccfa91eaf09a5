"""The port's optimizers, regularizers, LR schedulers and gradient clips
against the JAX package on the CPU.

Every case builds both sides from one numpy seed with the same arguments,
names its parameters alike (the names key the slots and what ``Lars``'
exclusions read) and feeds both the same gradients.

Tolerances, each with its reason:
* optimizer updates: 2e-6 absolute plus 1e-6 relative on parameters of ~1
  after 8 steps (enough for ``RAdam`` to pass from its momentum branch to
  its rectified branch at t 6) — the rules are the same f32 arithmetic, but
  the port updates in place (``x.mul_(b).add_(y)``) where the reference
  forms ``b * x + y``, and the scalar factors are Python doubles on one
  side and f32 on the other: a few f32 ulps a step;
* a bf16 parameter with an f32 master: the master to 2e-6, the parameter
  to one bf16 ulp of ~1 (2^-7), since a master a few f32 ulps apart can
  round to the neighbouring bf16 value;
* resume through ``convert.py``: the port's step after 2 JAX steps against
  the third JAX step, 1e-5 on parameters (the loss and the gradients of a
  tiny Llama differ by a few ulps, see tests/test_torch_train.py);
* LR schedulers: exact (the same Python float arithmetic);
* clips: 1e-6 absolute on gradients of ~1 (the norms sum in other orders).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu import regularizer as jreg
from paddlepaddle_tpu.core.tensor import Parameter as JParameter
from paddlepaddle_tpu.jit.train import TrainStep as JTrainStep
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu.nn import clip as jclip
from paddlepaddle_tpu.optimizer import lr as jlr
from paddlepaddle_tpu.optimizer import optimizers as jopt
from paddlepaddle_tpu_torch import TrainStep, convert, regularizer as treg
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.nn import clip as tclip
from paddlepaddle_tpu_torch.optimizer import lr as tlr
from paddlepaddle_tpu_torch.optimizer import optimizers as topt

NAMES = ("w", "norm.b")
STEPS = 8

# name -> (class name, constructor keywords, takes weight_decay)
OPTIMIZERS = {
    "SGD": ("SGD", dict(learning_rate=0.1), True),
    "Momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9), True),
    "Momentum_nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                           use_nesterov=True), True),
    "Adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1), True),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, rho=0.9, momentum=0.5),
                True),
    "RMSProp_centered": ("RMSProp", dict(learning_rate=0.01, rho=0.9,
                                         momentum=0.5, centered=True), True),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0), True),
    "Adamax": ("Adamax", dict(learning_rate=0.01), True),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.05,
                          exclude_from_weight_decay_fn=lambda n: True),
             False),
    "Lars": ("Lars", dict(learning_rate=0.5, lars_coeff=0.01,
                          lars_weight_decay=0.01,
                          exclude_from_weight_decay=["norm"]), False),
    "NAdam": ("NAdam", dict(learning_rate=0.01), True),
    "RAdam": ("RAdam", dict(learning_rate=0.01), True),
}

DECAYS = {"none": None, "l2": ("L2Decay", 0.05), "l1": ("L1Decay", 0.05)}

CASES = [(o, d) for o, (_, _, wd) in OPTIMIZERS.items()
         for d in (DECAYS if wd else ["none"])]


def _decay(mod, which):
    spec = DECAYS[which]
    return None if spec is None else getattr(mod, spec[0])(spec[1])


def _arrays(rng):
    shapes = {"w": (6, 4), "norm.b": (4,)}
    return {n: rng.standard_normal(shapes[n]).astype(np.float32)
            for n in NAMES}


def _np(t):
    return t.detach().float().cpu().numpy()


def _run_pair(opt_name, decay, dtype=np.float32, multi_precision=False):
    cls, kw, _ = OPTIMIZERS[opt_name]
    rng = np.random.default_rng(sorted(OPTIMIZERS).index(opt_name))
    init = _arrays(rng)
    grads = [_arrays(rng) for _ in range(STEPS)]
    extra = {} if decay == "none" else {"weight_decay": None}
    jkw = dict(kw, multi_precision=multi_precision)
    tkw = dict(kw, multi_precision=multi_precision)
    if extra:
        jkw["weight_decay"] = _decay(jreg, decay)
        tkw["weight_decay"] = _decay(treg, decay)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jparams = [JParameter(jnp.asarray(init[n], jdt), name=n) for n in NAMES]
    tparams = {n: torch.nn.Parameter(torch.from_numpy(init[n].copy())
                                     .to(tdt)) for n in NAMES}
    jo = getattr(jopt, cls)(parameters=jparams, **jkw)
    to = getattr(topt, cls)(parameters=tparams, **tkw)
    for g in grads:
        for p in jparams:
            p.grad = jnp.asarray(g[p.name], jdt)
        jo.step()
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n].copy()).to(tdt)
        to.step()
    return jo, to, jparams, tparams


@pytest.mark.parametrize("opt_name,decay", CASES)
def test_optimizer_steps_match_jax_eager(opt_name, decay):
    jo, to, jparams, tparams = _run_pair(opt_name, decay)
    for p in jparams:
        np.testing.assert_allclose(_np(tparams[p.name]), np.asarray(p.numpy()),
                                   atol=2e-6, rtol=1e-6,
                                   err_msg=f"{opt_name} {decay} {p.name}")
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert tsd["@step"] == jsd["@step"] == STEPS
    for key, val in jsd.items():
        if key in ("@step", "LR_Scheduler"):
            continue
        np.testing.assert_allclose(_np(tsd[key]), np.asarray(val,
                                                             np.float32),
                                   atol=2e-6, rtol=1e-6, err_msg=key)
    assert set(tsd) == set(jsd)


def test_lars_exclusion_and_lamb_quirk():
    """``Lars`` leaves the excluded parameter undecayed (its update equals
    a run with no decay); ``Lamb`` keeps ``exclude_from_weight_decay_fn``
    and, as the reference's rule, never reads it."""
    _, to, _, tp = _run_pair("Lars", "none")
    cls, kw, _ = OPTIMIZERS["Lars"]
    rng = np.random.default_rng(sorted(OPTIMIZERS).index("Lars"))
    init = _arrays(rng)
    grads = [_arrays(rng) for _ in range(STEPS)]
    nodecay = {n: torch.nn.Parameter(torch.from_numpy(init[n].copy()))
               for n in NAMES}
    o2 = topt.Lars(parameters=nodecay, **dict(kw, lars_weight_decay=0.0))
    for g in grads:
        for n, p in nodecay.items():
            p.grad = torch.from_numpy(g[n].copy())
        o2.step()
    torch.testing.assert_close(tp["norm.b"], nodecay["norm.b"])
    assert not torch.allclose(tp["w"], nodecay["w"])
    assert topt.LarsMomentumOptimizer is topt.Lars
    fn = OPTIMIZERS["Lamb"][1]["exclude_from_weight_decay_fn"]
    _, lamb, _, _ = _run_pair("Lamb", "none")
    assert lamb._exclude_fn is fn


def test_multi_precision_bf16_momentum_matches_jax():
    jo, to, jparams, tparams = _run_pair("Momentum", "l2", dtype="bfloat16",
                                         multi_precision=True)
    jsd, tsd = jo.state_dict(), to.state_dict()
    for p in jparams:
        assert tparams[p.name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tsd[f"{p.name}_master"]),
                                   np.asarray(jsd[f"{p.name}_master"]),
                                   atol=2e-6, rtol=1e-6, err_msg=p.name)
        np.testing.assert_allclose(
            _np(tparams[p.name]), np.asarray(p.numpy(), np.float32),
            atol=2 ** -7, rtol=0, err_msg=p.name)


def test_decay_term_l1_is_sign():
    """The base folds ``coeff * sign(w)`` for ``L1Decay`` and ``coeff * w``
    for ``L2Decay`` or a float (the reference's ``_decay_term``)."""
    w = torch.tensor([-2.0, 0.0, 3.0])
    assert float(treg.L2Decay(0.5)) == 0.5
    for wd, want in ((treg.L1Decay(0.5), [-0.5, 0.0, 0.5]),
                     (treg.L2Decay(0.5), [-1.0, 0.0, 1.5]),
                     (0.5, [-1.0, 0.0, 1.5])):
        o = topt.SGD(parameters={"w": torch.nn.Parameter(w.clone())},
                     weight_decay=wd)
        assert o._decay_term(w).tolist() == want
    assert repr(treg.L1Decay(0.5)) == repr(jreg.L1Decay(0.5))


# -- resume from a JAX train state through convert.py ------------------------

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)


@pytest.mark.parametrize("opt_name,kw", [
    ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                      weight_decay=("L2Decay", 1e-4))),
    ("Adagrad", dict(learning_rate=0.05, weight_decay=("L1Decay", 1e-4))),
    ("Lamb", dict(learning_rate=0.01)),
])
def test_resume_from_jax_optimizer_state(opt_name, kw):
    """2 JAX TrainStep steps with the optimizer, its state carried into the
    port's TrainStep by ``convert.load_jax_train_state``, then one step on
    each side: the same parameters (1e-5)."""
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**CFG))
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**CFG), device="cpu", seed=3)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, CFG["vocab_size"], (4, 16)).astype(np.int64)

    def build(mod, reg, params):
        k = dict(kw)
        if "weight_decay" in k:
            k["weight_decay"] = getattr(reg, k["weight_decay"][0])(
                k["weight_decay"][1])
        return getattr(mod, opt_name)(parameters=params, **k)

    jstep = JTrainStep(jm, build(jopt, jreg, jm.parameters()), _loss_fn)
    jstep(ids, ids)
    jstep(ids, ids)
    tstep = TrainStep(tm, build(topt, treg, tm.named_parameters()), _loss_fn,
                      device="cpu")
    convert.load_jax_train_state(tstep, jstep.state_dict())
    assert tstep.state_dict()["opt_state"]["step"] == 2
    jl3 = float(jstep(ids, ids).numpy())
    tl3 = float(tstep(ids, ids))
    np.testing.assert_allclose(tl3, jl3, atol=2e-5, rtol=0)
    jparams = jstep.state_dict()["params"]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), jparams[name], atol=1e-5, rtol=0,
                                   err_msg=name)


# -- LR schedulers ------------------------------------------------------------

SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=2.0),
    "PiecewiseDecay": dict(boundaries=[3, 7, 12], values=[0.1, 0.05, 0.01,
                                                          0.001]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.2),
    "PolynomialDecay": dict(learning_rate=0.5, decay_steps=10, end_lr=0.01,
                            power=2.0),
    "PolynomialDecay_cycle": dict(learning_rate=0.5, decay_steps=6,
                                  end_lr=0.01, cycle=True),
    "LinearWarmup": dict(learning_rate=0.3, warmup_steps=6, start_lr=0.0,
                         end_lr=0.3),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[4, 9, 15],
                           gamma=0.5),
    "StepDecay": dict(learning_rate=0.5, step_size=4, gamma=0.7),
    "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": dict(learning_rate=0.5,
                                lr_lambda=lambda e: 0.9),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=12, eta_min=0.01),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=4, T_mult=2,
                                        eta_min=0.01),
    "LinearLR": dict(learning_rate=0.5, total_steps=10, start_factor=0.25),
    "OneCycleLR": dict(max_learning_rate=0.5, total_steps=18),
    "OneCycleLR_linear": dict(max_learning_rate=0.5, total_steps=18,
                              anneal_strategy="linear"),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.1,
                     step_size_up=3, step_size_down=5),
    "CyclicLR_triangular2": dict(base_learning_rate=0.01,
                                 max_learning_rate=0.1, step_size_up=3,
                                 mode="triangular2"),
    "CyclicLR_exp_range": dict(base_learning_rate=0.01,
                               max_learning_rate=0.1, step_size_up=3,
                               mode="exp_range", exp_gamma=0.9),
}


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_first_20_values_match_jax(case):
    cls = case.split("_")[0]
    j = getattr(jlr, cls)(**SCHEDULERS[case])
    t = getattr(tlr, cls)(**SCHEDULERS[case])
    got, want = [], []
    for _ in range(20):
        got.append(t())
        want.append(j())
        t.step()
        j.step()
    assert got == want, case
    assert t.state_dict() == j.state_dict()


def test_reduce_on_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9,
               0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9]
    kw = dict(learning_rate=0.1, factor=0.5, patience=2, cooldown=1,
              min_lr=0.01)
    j, t = jlr.ReduceOnPlateau(**kw), tlr.ReduceOnPlateau(**kw)
    got, want = [], []
    for m in metrics:
        j.step(m)
        t.step(m)
        got.append(t())
        want.append(j())
    assert got == want and min(got) < 0.1
    assert t.state_dict() == j.state_dict()


def test_scheduler_drives_an_optimizer():
    sched = tlr.StepDecay(0.5, step_size=2, gamma=0.5)
    o = topt.SGD(learning_rate=sched,
                 parameters={"w": torch.nn.Parameter(torch.ones(2))})
    seen = []
    for _ in range(5):
        seen.append(o.get_lr())
        sched.step()
    assert seen == [0.5, 0.5, 0.25, 0.25, 0.125]
    assert o.state_dict()["LR_Scheduler"]["last_epoch"] == 5


# -- clips ---------------------------------------------------------------------

def _grads(rng, scale):
    return [(rng.standard_normal((5, 3)) * scale).astype(np.float32),
            (rng.standard_normal((7,)) * scale).astype(np.float32)]


@pytest.mark.parametrize("clip,args", [
    ("ClipGradByValue", (0.5,)),
    ("ClipGradByValue", (0.5, -0.2)),
    ("ClipGradByNorm", (1.0,)),
    ("ClipGradByNorm", (100.0,)),
    ("ClipGradByGlobalNorm", (1.0,)),
    ("ClipGradByGlobalNorm", (100.0,)),
])
def test_clip_matches_jax(clip, args):
    rng = np.random.default_rng(21)
    gs = _grads(rng, 2.0)
    jp = [JParameter(np.zeros_like(g), name=f"p{i}") for i, g in
          enumerate(gs)]
    want = getattr(jclip, clip)(*args)(
        [(p, paddle.to_tensor(g)) for p, g in zip(jp, gs)])
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    got = getattr(tclip, clip)(*args)(
        [(p, torch.from_numpy(g.copy())) for p, g in zip(tp, gs)])
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b.numpy()), atol=1e-6,
                                   rtol=0)
    # the list form the optimizers call clips the same
    listed = getattr(tclip, clip)(*args).clip_grads(
        [torch.from_numpy(g.copy()) for g in gs] + [None])
    assert listed[-1] is None
    for a, (_, b) in zip(listed, want):
        np.testing.assert_allclose(_np(a), np.asarray(b.numpy()), atol=1e-6,
                                   rtol=0)


def test_clip_skips_need_clip_false_and_any_clip_drives_an_optimizer():
    p, q = torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(
        torch.zeros(2))
    q.need_clip = False
    out = tclip.ClipGradByValue(1.0)([(p, torch.tensor([3.0, -3.0])),
                                      (q, torch.tensor([3.0, -3.0]))])
    assert out[0][1].tolist() == [1.0, -1.0] and out[1][1].tolist() == [3.0,
                                                                      -3.0]
    for clip in (tclip.ClipGradByValue(0.1), tclip.ClipGradByNorm(0.1),
                 tclip.ClipGradByGlobalNorm(0.1)):
        w = torch.nn.Parameter(torch.zeros(3))
        o = topt.SGD(learning_rate=1.0, parameters={"w": w}, grad_clip=clip)
        w.grad = torch.tensor([3.0, 4.0, 0.0])
        o.step()
        assert float(w.detach().norm()) <= 0.1 * 3 ** 0.5 + 1e-6


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    rng = np.random.default_rng(22)
    gs = _grads(rng, 3.0)
    jp = [JParameter(np.zeros_like(g), name=f"p{i}") for i, g in
          enumerate(gs)]
    for p, g in zip(jp, gs):
        p._grad = jnp.asarray(g)
    jtot = jclip.clip_grad_norm_(jp, 1.5, norm_type)
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(tp, gs):
        p.grad = torch.from_numpy(g.copy())
    ttot = tclip.clip_grad_norm_(tp, 1.5, norm_type)
    np.testing.assert_allclose(float(ttot), float(jtot.numpy()), atol=1e-5,
                               rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a.grad), np.asarray(b._grad),
                                   atol=1e-6, rtol=0)


# -- signatures ------------------------------------------------------------------

def _positional(obj):
    fn = obj.__init__ if inspect.isclass(obj) else obj
    return [(p.name, p.default) for p in inspect.signature(fn).parameters
            .values() if p.kind in (p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL)
            and p.name != "self"]


def _same_defaults(a, b):
    return [(n, d if not callable(d) else "fn") for n, d in a] == \
        [(n, d if not callable(d) else "fn") for n, d in b]


@pytest.mark.parametrize("mod_pair,name", [
    ((topt, jopt), n) for n in ("SGD", "Momentum", "Adagrad", "RMSProp",
                                "Adadelta", "Adamax", "Lamb", "Lars",
                                "LarsMomentumOptimizer", "NAdam", "RAdam",
                                "Adam", "AdamW")
] + [((tlr, jlr), n) for n in ("NoamDecay", "PiecewiseDecay",
                               "NaturalExpDecay", "InverseTimeDecay",
                               "PolynomialDecay", "LinearWarmup",
                               "ExponentialDecay", "MultiStepDecay",
                               "StepDecay", "LambdaDecay",
                               "MultiplicativeDecay", "CosineAnnealingDecay",
                               "CosineAnnealingWarmRestarts", "LinearLR",
                               "OneCycleLR", "CyclicLR", "ReduceOnPlateau")
] + [((tclip, jclip), n) for n in ("ClipGradByValue", "ClipGradByNorm",
                                   "ClipGradByGlobalNorm",
                                   "clip_grad_norm_")
] + [((treg, jreg), n) for n in ("L1Decay", "L2Decay")])
def test_signature_matches_reference(mod_pair, name):
    tmod, jmod = mod_pair
    assert _same_defaults(_positional(getattr(tmod, name)),
                          _positional(getattr(jmod, name))), name
