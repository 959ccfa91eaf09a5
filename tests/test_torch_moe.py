"""The port's MoE layer and MoE decoder (paddlepaddle_tpu_torch/parallel/moe.py,
models/moe.py) against the JAX package on the CPU, on the same numpy inputs
and carried weights. The JAX fused mode runs its Pallas kernel in interpret
mode, as the JAX package's own tests run it.

Tolerances, each with its reason:
* slot maps (slots_of_entry, slot_valid, slot_entry): equal — integer index
  maps from the same argmax decisions. Inputs are planted with top-k
  margins far above f32 noise, since a near tie can flip an argmax between
  two libraries' softmax without any port fault;
* FFN outputs, aux losses and gradients of each dispatch mode at f32:
  1e-5 absolute — the same f32 products summed in other orders;
* the port's fused mode against its sorted mode on the CPU: 1e-6 (the same
  plain arithmetic in both);
* the tiny MoE decoder: loss 1e-5, every gradient 1e-4 (two layers of the
  orders above); after 3 TrainStep steps parameters 1e-4 (a tenth of one
  step's move; Adam amplifies the noise of near-zero gradients, see
  tests/test_torch_train.py) and losses 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.core import autograd as jag
from paddlepaddle_tpu.core.dispatch import apply_op, unwrap
from paddlepaddle_tpu.jit.train import TrainStep as JTrainStep
from paddlepaddle_tpu.models import moe as jm_moe
from paddlepaddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddlepaddle_tpu.optimizer.optimizers import AdamW as JAdamW
from paddlepaddle_tpu.parallel import moe as jmoe
from paddlepaddle_tpu_torch import (AdamW, ClipGradByGlobalNorm, MoEConfig,
                                    MoEForCausalLM, MoELayer, TrainStep,
                                    convert)
from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg
from paddlepaddle_tpu_torch.parallel import moe as tmoe

MODES = ("sorted", "fused", "dropless", "einsum")


def _np(t):
    return t.detach().float().cpu().numpy()


def _separated_logits(T, E, seed, heavy=0, empty=None):
    """Logits whose every row is a permutation of 0..E-1 plus noise below
    0.1 (top-k margins > 0.8), with expert ``heavy`` first for half the
    tokens (drops at a tight capacity) and expert ``empty`` never chosen."""
    rng = np.random.default_rng(seed)
    lg = np.argsort(rng.random((T, E)), axis=1).astype(np.float32)
    lg += rng.uniform(0, 0.1, (T, E)).astype(np.float32)
    lg[: (T + 1) // 2, heavy] = E + 1.0
    if empty is not None:
        lg[:, empty] = -10.0
    return lg


# (T, E, k, C): planted drops with an empty expert; N = 768 = 3 x 256 takes
# the JAX blocked prefix-sum branch; one token; top-1
@pytest.mark.parametrize("T,E,k,C,empty", [
    (48, 4, 2, 8, 3), (384, 8, 2, 80, None), (1, 4, 2, 4, None),
    (64, 6, 1, 9, 5)])
def test_capacity_slot_maps_bit_equal(T, E, k, C, empty):
    lg = _separated_logits(T, E, seed=T, empty=empty)
    jg, jaux, jsoe, jvalid, jentry = jax.jit(
        jmoe._capacity_slot_maps, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(lg, jnp.float32), k, E, C, T)
    tg, taux, tsoe, tvalid, tentry = tmoe._capacity_slot_maps(
        torch.from_numpy(lg), k, E, C, T)
    np.testing.assert_array_equal(tsoe.numpy(), np.asarray(jsoe))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tentry.numpy(), np.asarray(jentry))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)
    assert (tsoe < 0).any() or T * k <= E * C


# ---------------------------------------------------------------------------
# the four modes' FFN functions, forward and backward
# ---------------------------------------------------------------------------

T_FFN, D, H, E_FFN, K, CAP = 40, 16, 24, 4, 2, 16


def _jax_ffn(mode, x, gw, wg, wu, wd):
    logits = x.astype(jnp.float32) @ gw.astype(jnp.float32)
    if mode == "sorted":
        return jmoe._gathered_capacity_moe_ffn(x, logits, wg, wu, wd, K, CAP)
    if mode == "fused":
        return jmoe._fused_gather_gemm_moe_ffn(x, logits, wg, wu, wd, K, CAP)
    if mode == "dropless":
        return jmoe._dropless_moe_ffn(x, logits, wg, wu, wd, K)
    disp, comb, aux = jmoe._topk_routing(logits, CAP, K)
    xin = jnp.einsum("tec,td->ecd", disp, x)
    hm = jax.nn.silu(jnp.einsum("ecd,edh->ech", xin, wg)) \
        * jnp.einsum("ecd,edh->ech", xin, wu)
    out = jnp.einsum("ech,ehd->ecd", hm, wd)
    return jnp.einsum("tec,ecd->td", comb, out), aux


def _port_ffn(mode, x, gw, wg, wu, wd):
    logits = x.float() @ gw.float()
    if mode == "sorted":
        return tmoe._gathered_capacity_moe_ffn(x, logits, wg, wu, wd, K, CAP)
    if mode == "fused":
        return tmoe._fused_gather_gemm_moe_ffn(x, logits, wg, wu, wd, K, CAP)
    if mode == "dropless":
        return tmoe._dropless_moe_ffn(x, logits, wg, wu, wd, K)
    disp, comb, aux = tmoe._topk_routing(logits, CAP, K)
    xin = torch.einsum("tec,td->ecd", disp, x)
    hm = torch.nn.functional.silu(torch.einsum("ecd,edh->ech", xin, wg)) \
        * torch.einsum("ecd,edh->ech", xin, wu)
    out = torch.einsum("ech,ehd->ecd", hm, wd)
    return torch.einsum("tec,ecd->td", comb, out), aux


@pytest.fixture(scope="module")
def ffn_inputs():
    """x, gate weight, banks and an output cotangent; the routing logits
    x @ gw have top-3 margins above 1e-3 (checked), and expert 0 is
    overloaded so the capacity modes drop entries."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T_FFN, D)).astype(np.float32)
    gw = rng.standard_normal((D, E_FFN)).astype(np.float32)
    gw[:, 0] += 0.6 * x[: T_FFN // 2].mean(0) / np.linalg.norm(
        x[: T_FFN // 2].mean(0))
    lg = np.sort(x @ gw, axis=1)
    assert np.diff(lg[:, -3:], axis=1).min() > 1e-3
    banks = [(rng.standard_normal(s) / 4).astype(np.float32)
             for s in ((E_FFN, D, H), (E_FFN, D, H), (E_FFN, H, D))]
    cot = rng.standard_normal((T_FFN, D)).astype(np.float32)
    return [x, gw] + banks + [cot]


def _ffn_value_and_grads_jax(mode, arrays):
    *ins, cot = [jnp.asarray(a, jnp.float32) for a in arrays]

    def loss(*a):
        y, aux = _jax_ffn(mode, *a)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*ins)
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _ffn_value_and_grads_port(mode, arrays):
    *ins, cot = [torch.from_numpy(a.copy()) for a in arrays]
    for t in ins:
        t.requires_grad_(True)
    y, aux = _port_ffn(mode, *ins)
    ((y * cot).sum() + aux).backward()
    return _np(y), float(aux), [_np(t.grad) for t in ins]


@pytest.mark.parametrize("mode", MODES)
def test_ffn_mode_matches_jax(mode, ffn_inputs):
    jy, jaux, jgrads = _ffn_value_and_grads_jax(mode, ffn_inputs)
    ty, taux, tgrads = _ffn_value_and_grads_port(mode, ffn_inputs)
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=1e-5, rtol=0)
    for name, a, b in zip(("x", "gate", "wg", "wu", "wd"), tgrads, jgrads):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
    if mode != "dropless":         # the capacity modes drop entries here
        assert ty.shape == (T_FFN, D)


def test_port_fused_equals_port_sorted_on_cpu(ffn_inputs):
    fy, faux, fgrads = _ffn_value_and_grads_port("fused", ffn_inputs)
    sy, saux, sgrads = _ffn_value_and_grads_port("sorted", ffn_inputs)
    np.testing.assert_allclose(fy, sy, atol=1e-6, rtol=0)
    assert faux == saux
    for a, b in zip(fgrads, sgrads):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_dropless_align_pads_groups_without_changing_the_result(ffn_inputs):
    x, gw, wg, wu, wd, _ = (torch.from_numpy(a) for a in ffn_inputs)
    logits = x @ gw
    y1, a1 = tmoe._dropless_moe_ffn(x, logits, wg, wu, wd, K)
    y8, a8 = tmoe._dropless_moe_ffn(x, logits, wg, wu, wd, K, align=8)
    torch.testing.assert_close(y8, y1, atol=1e-6, rtol=0)
    assert float(a8) == float(a1)


# ---------------------------------------------------------------------------
# MoELayer with carried weights
# ---------------------------------------------------------------------------


class _JCustomGate(jmoe.NaiveGate):
    """A gate overriding routing(): sharper logits, GShard top-2."""

    def routing(self, x_flat, capacity):
        def f(x, w):
            lg = 2.0 * (x.astype(jnp.float32) @ w.astype(jnp.float32))
            return jmoe._topk_routing(lg, capacity, 2)

        return apply_op(f, x_flat, self.weight, op_name="custom_gate")


class _TCustomGate(tmoe.NaiveGate):
    def routing(self, x_flat, capacity):
        lg = 2.0 * (x_flat.float() @ self.weight.float())
        return tmoe._topk_routing(lg, capacity, 2)


@pytest.mark.parametrize("mode,custom", [(m, False) for m in MODES]
                         + [("fused", True)])
def test_moe_layer_matches_jax(mode, custom):
    d, h, E = 16, 32, 4
    paddle.seed(3)
    gate = _JCustomGate(d, E) if custom else jmoe.GShardGate(d, E)
    jl = jmoe.MoELayer(d, h, E, gate=gate, capacity_factor=1.0,
                       dispatch_mode=mode)
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    tgate = _TCustomGate(d, E, device="cpu") if custom else None
    tl = MoELayer(d, h, E, gate=tgate, capacity_factor=1.0,
                  dispatch_mode=mode, device="cpu")
    tl.load_state_dict(convert.convert_state(state), strict=True)
    x = np.random.default_rng(5).standard_normal((2, 12, d)).astype(
        np.float32)

    def forward(st):
        with jag.no_grad(), jl.bind_state(st):
            return unwrap(jl(paddle.to_tensor(x))), unwrap(jl.l_aux)

    jy, jaux = jax.jit(forward)(jl.functional_state())
    ty = tl(torch.from_numpy(x))
    assert tl.capacity(24) == jl.capacity(24)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tl.l_aux), float(jaux), atol=1e-6,
                               rtol=0)


def test_moe_layer_rejects_unknown_mode_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="dispatch_mode"):
        MoELayer(8, 16, 2, dispatch_mode="ragged", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MoELayer(8, 16, 2)


# ---------------------------------------------------------------------------
# the tiny MoE decoder: loss, gradients, TrainStep, resume
# ---------------------------------------------------------------------------


def _cfg(mode, config_cls):
    """``MoEConfig.tiny`` with one shared expert, of either package."""
    cfg = config_cls.tiny()
    cfg.num_shared_experts = 1
    cfg.dispatch_mode = mode
    return cfg


def _batch(b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[1, 4:7] = -100
    return ids, labels


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)


def _port_model(mode, state):
    tm = MoEForCausalLM(_cfg(mode, MoEConfig), device="cpu", seed=9)
    convert.load_jax_state(tm, state)
    return tm


def _port_step(tm):
    opt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    return TrainStep(tm, opt, _loss_fn, device="cpu")


def _snapshot(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module", params=["fused", "sorted"])
def jax_run(request):
    """One JAX tiny MoE per mode: its initial state, the loss and every
    gradient on a batch, and 3 TrainStep steps (losses, the state after 2
    steps, the parameters after 3)."""
    mode = request.param
    paddle.seed(0)
    jm = jm_moe.MoEForCausalLM(_cfg(mode, jm_moe.MoEConfig))
    state = {k: np.asarray(v).copy() for k, v in jm.functional_state().items()}
    ids, labels = _batch()
    params = jm.functional_state(trainable_only=True)
    buffers = {k: v for k, v in jm.functional_state().items()
               if k not in params}

    def loss_of(p):
        with jag.no_grad(), jm.bind_state({**p, **buffers}):
            return unwrap(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(labels)))

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    out = {"mode": mode, "state": state, "loss": float(loss),
           "grads": {k: np.asarray(v) for k, v in grads.items()}}
    opt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                 weight_decay=0.01, grad_clip=JClip(1.0))
    jstep = JTrainStep(jm, opt, _loss_fn)
    losses = []
    for i in range(3):
        if i == 2:
            out["state_after_2"] = _snapshot(jstep.state_dict())
        losses.append(float(jstep(ids, labels).numpy()))
    out["losses"] = losses
    out["params_after_3"] = _snapshot(jstep.state_dict()["params"])
    return out


def test_tiny_moe_loss_and_grads_match_jax(jax_run):
    tm = _port_model(jax_run["mode"], jax_run["state"])
    ids, labels = _batch()
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), jax_run["loss"], atol=1e-5,
                               rtol=0)
    named = dict(tm.named_parameters())
    assert set(named) == set(jax_run["grads"])
    for name, g in jax_run["grads"].items():
        np.testing.assert_allclose(_np(named[name].grad), g, atol=1e-4,
                                   rtol=0, err_msg=name)
    assert all(float(layer.mlp.l_aux) > 0 for layer in tm.layers)


def test_tiny_moe_three_train_steps_match_jax(jax_run):
    tm = _port_model(jax_run["mode"], jax_run["state"])
    ids, labels = _batch()
    step = _port_step(tm)
    before = gg.gather_gemm_ffn.launches
    for want in jax_run["losses"]:
        np.testing.assert_allclose(float(step(ids, labels)), want, atol=2e-5,
                                   rtol=0)
    assert gg.gather_gemm_ffn.launches == before      # CPU: plain version
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), jax_run["params_after_3"][name],
                                   atol=1e-4, rtol=0, err_msg=name)


def test_tiny_moe_resumes_from_jax_train_state(jax_run):
    """The JAX state after 2 steps, carried into the port, then 1 port step,
    equals 3 JAX steps."""
    tm = _port_model(jax_run["mode"], jax_run["state"])
    with torch.no_grad():                 # the resume must overwrite these
        for p in tm.parameters():
            p.normal_()
    step = _port_step(tm)
    convert.load_jax_train_state(step, jax_run["state_after_2"])
    assert step.state_dict()["opt_state"]["step"] == 2
    ids, labels = _batch()
    np.testing.assert_allclose(float(step(ids, labels)),
                               jax_run["losses"][2], atol=2e-5, rtol=0)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), jax_run["params_after_3"][name],
                                   atol=1e-4, rtol=0, err_msg=name)


def test_convert_takes_moe_state_strictly():
    """The JAX MoE model keeps its rope tables at the root; convert skips
    them, so a strict load covers every port parameter."""
    paddle.seed(1)
    jm = jm_moe.MoEForCausalLM(_cfg("sorted", jm_moe.MoEConfig))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    assert "rope_cos" in state and "rope_sin" in state
    tm = MoEForCausalLM(_cfg("sorted", MoEConfig), device="cpu")
    convert.load_jax_state(tm, state)
    sd = tm.state_dict()
    assert set(sd) == set(state) - set(convert.SKIPPED)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), state[name], err_msg=name)
    np.testing.assert_allclose(tm.rope_cos.numpy(), state["rope_cos"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm.rope_sin.numpy(), state["rope_sin"],
                               atol=1e-6, rtol=0)


def test_moe_model_device_rules():
    cfg = _cfg("fused", MoEConfig)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MoEForCausalLM(cfg)
    tm = MoEForCausalLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tm(torch.zeros(1, 4, dtype=torch.long),
           attn_mask=torch.ones(1, 1, 4, 4, dtype=torch.bool))
    assert tm(torch.zeros(2, 4, dtype=torch.long)).shape == (2, 4, 128)
