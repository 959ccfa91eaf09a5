"""The port's vision and transformer layers (``paddlepaddle_tpu_torch.nn``:
activations, containers, dropout, layer norm, batch norm with its
hand-written backward, convolutions, pools, multi-head attention and the
encoder) against the JAX package on the CPU. Inputs come from
``np.random.default_rng``; dtypes are pinned on both sides (the JAX package
turns x64 on).

Tolerances, each with its reason:
* f32 elementwise activations: 1e-6 of the largest value (one f32 rounding
  of transcendental functions that the two libraries evaluate with other
  polynomials);
* f32 reductions and products (layer norm, batch norm, convolutions, pools,
  attention): 1e-5 of the largest value, gradients 1e-5 of each gradient's
  largest — sums in other orders; the encoder's parameter gradients, summed
  over the batch, the heads and two layers, 1e-4 of each gradient's largest
  (a gradient that is zero up to rounding against 1% of the largest one, as
  its test says);
* bf16 layer norm: equal to the bit on all but a few elements, and no
  element more than one bf16 ulp (2^-7 relative) off — both round the
  normalised value to bf16 before the affine; elsewhere the two libraries'
  bf16 products round the same f32 value;
* running statistics: 1e-6 relative — the update is one multiply-add, but
  the reference forms ``n / (n - 1)`` in double.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu import nn as jnn
from paddlepaddle_tpu.nn import functional as jF
from paddlepaddle_tpu_torch import convert, nn as tnn
from paddlepaddle_tpu_torch.core import random as trandom
from paddlepaddle_tpu_torch.nn import functional as tF


def _rng(seed=0):
    return np.random.default_rng(seed)


def _j(a):
    return paddle.to_tensor(a)


def _close(got, want, rel, floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

ACTS = [("relu", {}), ("relu6", {}), ("sigmoid", {}), ("tanh", {}),
        ("silu", {}), ("swish", {}), ("mish", {}), ("softsign", {}),
        ("tanhshrink", {}), ("log_sigmoid", {}), ("gelu", {}),
        ("gelu", {"approximate": True}), ("leaky_relu", {"negative_slope": 0.2}),
        ("elu", {"alpha": 0.7}), ("celu", {"alpha": 1.3}), ("selu", {}),
        ("hardtanh", {"min": -0.5, "max": 2.0}), ("hardsigmoid", {}),
        ("hardswish", {}), ("hardshrink", {"threshold": 0.3}),
        ("softshrink", {"threshold": 0.4}), ("softplus", {"beta": 2.0,
                                                          "threshold": 3.0}),
        ("thresholded_relu", {"threshold": 0.5, "value": -1.0}),
        ("maxout", {"groups": 2, "axis": 1}), ("glu", {"axis": 1}),
        ("rrelu", {})]


@pytest.mark.parametrize("name,kw", ACTS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ACTS)])
def test_activation_matches_reference(name, kw):
    x = (_rng(1).standard_normal((3, 4, 5)) * 3).astype(np.float32)
    want = getattr(jF, name)(_j(x), **kw).numpy()
    got = getattr(tF, name)(torch.from_numpy(x), **kw).numpy()
    _close(got, want, 1e-6)


@pytest.mark.parametrize("cls,args", [("ReLU", ()), ("GELU", (True,)),
                                      ("Tanh", ()), ("LeakyReLU", (0.3,)),
                                      ("Softmax", (1,)), ("LogSoftmax", (0,))])
def test_activation_layers_match_reference(cls, args):
    x = _rng(2).standard_normal((4, 6)).astype(np.float32)
    want = getattr(jnn, cls)(*args)(_j(x)).numpy()
    got = getattr(tnn, cls)(*args)(torch.from_numpy(x)).numpy()
    _close(got, want, 1e-6)


def test_prelu_layer_matches_reference():
    x = _rng(3).standard_normal((2, 3, 4, 4)).astype(np.float32)
    for n in (1, 3):
        jl = jnn.PReLU(n, 0.1)
        tl = tnn.PReLU(n, 0.1, device="cpu")
        _close(tl(torch.from_numpy(x)).detach().numpy(), jl(_j(x)).numpy(),
               1e-7)


def test_gelu_modes_differ_and_name_erf_and_tanh():
    x = torch.linspace(-3, 3, 61)
    erf = 0.5 * x * (1 + torch.erf(x / 2 ** 0.5))
    tanh = 0.5 * x * (1 + torch.tanh((2 / torch.pi) ** 0.5
                                     * (x + 0.044715 * x ** 3)))
    assert torch.allclose(tF.gelu(x), erf, atol=1e-6)
    assert torch.allclose(tF.gelu(x, approximate=True), tanh, atol=1e-6)
    assert (tF.gelu(x) - tF.gelu(x, approximate=True)).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


def test_sequential_forms_and_names_match_reference():
    from collections import OrderedDict

    def build(mod, lin, **kw):
        return [mod.Sequential(lin(3, 4, **kw), mod.ReLU(), lin(4, 2, **kw)),
                mod.Sequential(OrderedDict([("a", lin(3, 4, **kw)),
                                            ("b", mod.ReLU())])),
                mod.Sequential(("fc", lin(3, 4, **kw)), ("act", mod.Tanh()))]

    jseqs = build(jnn, jnn.Linear)
    tseqs = build(tnn, tnn.Linear, device="cpu")
    x = _rng(4).standard_normal((5, 3)).astype(np.float32)
    for js, ts in zip(jseqs, tseqs):
        state = {k: np.asarray(v) for k, v in js.functional_state().items()}
        assert sorted(state) == sorted(ts.state_dict())
        convert.load_jax_state(ts, state)
        _close(ts(torch.from_numpy(x)).detach().numpy(), js(_j(x)).numpy(),
               1e-6)
    ts = tseqs[0]
    assert len(ts) == 3 and isinstance(ts[1], tnn.ReLU)
    assert isinstance(ts[0:2], tnn.Sequential) and len(ts[0:2]) == 2
    assert ts["2"] is ts[2] and tseqs[2]["act"] is tseqs[2][1]


def test_layer_list_names_and_list_surface():
    ll = tnn.LayerList([tnn.Linear(2, 2, device="cpu") for _ in range(2)])
    ll.append(tnn.ReLU())
    ll.insert(0, tnn.Tanh())
    ll.extend([tnn.Sigmoid()])
    assert [type(m).__name__ for m in ll] == ["Tanh", "Linear", "Linear",
                                              "Relu", "Sigmoid"]
    assert sorted(ll.state_dict()) == ["1.bias", "1.weight", "2.bias",
                                       "2.weight"]
    assert isinstance(ll[1:3], tnn.LayerList) and len(ll[1:3]) == 2
    jl = jnn.LayerList([jnn.Linear(2, 2) for _ in range(2)])
    assert sorted(jl.functional_state()) == sorted(
        tnn.LayerList([tnn.Linear(2, 2, device="cpu")
                       for _ in range(2)]).state_dict())


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_keep_rate_scaling_and_seed():
    x = torch.ones(200, 500)
    trandom.seed(11)
    a = tF.dropout(x, 0.3)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.7))
    trandom.seed(11)
    assert torch.equal(tF.dropout(x, 0.3), a)
    assert not torch.equal(tF.dropout(x, 0.3), a)      # the stream moved on
    g = torch.Generator().manual_seed(0)
    torch.rand(3, generator=g)                          # torch's global
    trandom.seed(11)                                    # stream is not read
    torch.manual_seed(123)
    assert torch.equal(tF.dropout(x, 0.3), a)


def test_dropout_modes_axis_and_eval_match_reference():
    x = _rng(5).standard_normal((4, 6, 3)).astype(np.float32)
    for kw in ({"training": False}, {"p": 0.0},
               {"training": False, "mode": "downscale_in_infer", "p": 0.25}):
        _close(tF.dropout(torch.from_numpy(x), **kw).numpy(),
               jF.dropout(_j(x), **kw).numpy(), 0)
    trandom.seed(3)
    d = tF.dropout(torch.ones(64, 8, 32), 0.5, axis=[0, 1])
    assert torch.all((d == d[:, :, :1]))                # one draw per (0, 1)
    assert set(torch.unique(d).tolist()) <= {0.0, 2.0}
    d = tF.dropout(torch.ones(1000), 0.4, mode="downscale_in_infer")
    assert set(torch.unique(d).tolist()) <= {0.0, 1.0}
    layer = tnn.Dropout(0.9)
    layer.eval()
    assert torch.equal(layer(torch.ones(5)), torch.ones(5))


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [[16], [5, 16]])
def test_layer_norm_f32_forward_and_grad(shape):
    rng = _rng(6)
    x = (rng.standard_normal([3] + shape) * 2 + 1).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jf(a, ww, bb):
        out = jF.layer_norm(paddle.Tensor(a), shape, paddle.Tensor(ww),
                            paddle.Tensor(bb), 1e-5)
        return jnp.sum(out._data * ct)

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(v).requires_grad_() for v in (x, w, b))
    out = tF.layer_norm(tx, shape, tw, tb, 1e-5)
    (out * torch.from_numpy(ct)).sum().backward()
    want = jF.layer_norm(_j(x), shape, _j(w), _j(b), 1e-5).numpy()
    _close(out.detach().numpy(), want, 1e-5)
    for g, t in zip(jg, (tx, tw, tb)):
        _close(t.grad.numpy(), np.asarray(g), 1e-5)


def test_layer_norm_bf16_rounds_before_the_affine():
    rng = _rng(7)
    x = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
    w = (rng.standard_normal(64) * 2).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jF.layer_norm(_j(jnp.asarray(x, jnp.bfloat16)), 64,
                         _j(jnp.asarray(w, jnp.bfloat16)),
                         _j(jnp.asarray(b, jnp.bfloat16))).numpy()
    got = tF.layer_norm(*(torch.from_numpy(v).bfloat16() for v in (x,)), 64,
                        torch.from_numpy(w).bfloat16(),
                        torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    off = got != want
    assert off.mean() < 0.02, off.mean()
    assert np.all(np.abs(got - want) <= 2 ** -7 * np.maximum(np.abs(want),
                                                             2 ** -7))


def test_layer_norm_layer_state_and_forward():
    jl = jnn.LayerNorm([4, 8], epsilon=1e-6)
    tl = tnn.LayerNorm([4, 8], epsilon=1e-6, device="cpu")
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    assert sorted(state) == sorted(tl.state_dict())
    state["weight"] = _rng(8).standard_normal((4, 8)).astype(np.float32)
    convert.load_jax_state(tl, state)
    jl.set_state_dict({k: _j(v) for k, v in state.items()})
    x = _rng(9).standard_normal((2, 4, 8)).astype(np.float32)
    _close(tl(torch.from_numpy(x)).detach().numpy(), jl(_j(x)).numpy(), 1e-5)
    assert tnn.LayerNorm(4, weight_attr=False, bias_attr=False,
                         device="cpu").weight is None


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------


def _bn_inputs(shape, seed=10):
    rng = _rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[1]
    w = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, ct


@pytest.mark.parametrize("shape", [(4, 8, 5, 5), (6, 3), (2, 5, 7)])
def test_bn_train_function_matches_custom_vjp(shape):
    """``_BatchNormTrain`` against ``_bn_train_core``'s forward (y, mean,
    var) and ``jax.grad`` through its custom vjp."""
    x, w, b, ct = _bn_inputs(shape)

    def jf(a, ww, bb):
        return jnp.sum(jF._bn_train_core(a, ww, bb, 1e-5, 1)[0] * ct)

    jy, jmean, jvar = jF._bn_train_core(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), 1e-5, 1)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(v).requires_grad_() for v in (x, w, b))
    y, mean, var = tF._BatchNormTrain.apply(tx, tw, tb, 1e-5, 1)
    assert not mean.requires_grad and not var.requires_grad
    (y * torch.from_numpy(ct)).sum().backward()
    for got, want in ((y, jy), (mean, jmean), (var, jvar)):
        _close(got.detach().numpy(), np.asarray(want), 1e-5)
    for t, g in zip((tx, tw, tb), jg):
        _close(t.grad.numpy(), np.asarray(g), 1e-5)


def test_bn_backward_is_the_fused_formula_not_autograd():
    """The backward runs the hand-written formula: its graph holds one
    ``_BatchNormTrainBackward`` node over the input, and its gradient equals
    autograd through the same one-pass forward (within f32 sums)."""
    x, w, b, ct = _bn_inputs((3, 4, 6, 6), seed=11)
    tx = torch.from_numpy(x).requires_grad_()
    y, _, _ = tF._BatchNormTrain.apply(tx, torch.from_numpy(w),
                                       torch.from_numpy(b), 1e-5, 1)
    assert "BatchNormTrain" in type(y.grad_fn).__name__
    (y * torch.from_numpy(ct)).sum().backward()
    ax = torch.from_numpy(x).requires_grad_()
    mean = ax.mean((0, 2, 3))
    var = torch.clamp((ax * ax).mean((0, 2, 3)) - mean * mean, min=0)
    scale = torch.rsqrt(var + 1e-5) * torch.from_numpy(w)
    ay = ax * scale[:, None, None] + (torch.from_numpy(b) - mean * scale)[
        :, None, None]
    (ay * torch.from_numpy(ct)).sum().backward()
    _close(tx.grad.numpy(), ax.grad.numpy(), 1e-5)


@pytest.mark.parametrize("fmt,shape", [("NCHW", (4, 6, 5, 5)),
                                       ("NHWC", (4, 5, 5, 6)),
                                       ("NCL", (4, 6, 9))])
def test_batch_norm_layer_train_eval_and_running_stats(fmt, shape):
    """One train-mode forward: outputs and the in-place running-statistics
    update equal the JAX eager layer's; then eval mode over the updated
    statistics; then ``use_global_stats`` in train mode."""
    c = shape[1] if fmt != "NHWC" else shape[-1]
    cls = "BatchNorm1D" if fmt == "NCL" else "BatchNorm2D"
    kw = {} if fmt == "NCL" else {"data_format": fmt}
    paddle.seed(1)
    jl = getattr(jnn, cls)(c, momentum=0.8, **kw)
    tl = getattr(tnn, cls)(c, momentum=0.8, device="cpu", **kw)
    rng = _rng(12)
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    assert sorted(state) == sorted(tl.state_dict()) == [
        "_mean", "_variance", "bias", "weight"]
    state["weight"] = rng.standard_normal(c).astype(np.float32)
    state["bias"] = rng.standard_normal(c).astype(np.float32)
    jl.set_state_dict({k: _j(v) for k, v in state.items()})
    convert.load_jax_state(tl, state)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    _close(tl(torch.from_numpy(x)).detach().numpy(), jl(_j(x)).numpy(), 1e-5)
    jstate = jl.functional_state()
    for k in ("_mean", "_variance"):
        _close(tl.state_dict()[k].numpy(), np.asarray(jstate[k]), 1e-6)
    assert tl._mean.abs().max() > 0
    jl.eval()
    tl.eval()
    x2 = rng.standard_normal(shape).astype(np.float32)
    _close(tl(torch.from_numpy(x2)).detach().numpy(), jl(_j(x2)).numpy(),
           1e-5)
    jg = getattr(jnn, cls)(c, use_global_stats=True, **kw)
    tg = getattr(tnn, cls)(c, use_global_stats=True, device="cpu", **kw)
    convert.load_jax_state(tg, state)
    jg.set_state_dict({k: _j(v) for k, v in state.items()})
    before = tg._mean.clone()
    _close(tg(torch.from_numpy(x)).detach().numpy(), jg(_j(x)).numpy(), 1e-5)
    assert torch.equal(tg._mean, before)


def test_batch_norm_bf16_buffers_after_cast():
    """``Module.to(bfloat16)`` casts the running statistics, as the
    reference's ``Layer.to(dtype=)`` does; the update then rounds into
    bf16 buffers, and eval folds them in f32."""
    jl = jnn.BatchNorm2D(4)
    jl.to(dtype="bfloat16")
    tl = tnn.BatchNorm2D(4, device="cpu").to(torch.bfloat16)
    assert tl._mean.dtype == torch.bfloat16
    assert tl._variance.dtype == torch.bfloat16
    assert str(jl.functional_state()["_mean"].dtype) == "bfloat16"
    x = _rng(13).standard_normal((2, 4, 3, 3)).astype(np.float32) + 2
    got = tl(torch.from_numpy(x).bfloat16())
    want = jl(_j(jnp.asarray(x, jnp.bfloat16)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.numpy(), np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_array_equal(
        tl._mean.float().numpy(),
        np.asarray(jl.functional_state()["_mean"], np.float32))


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

CONV2D = [
    dict(padding=0), dict(padding=1, stride=2), dict(padding=[1, 2]),
    dict(padding=[0, 1, 2, 0]), dict(padding="SAME"),
    dict(padding="SAME", stride=2), dict(padding="same", stride=3),
    dict(padding="VALID", stride=2), dict(padding=2, dilation=2),
    dict(padding=1, groups=2), dict(padding=1, data_format="NHWC"),
    dict(padding="SAME", stride=2, data_format="NHWC")]


@pytest.mark.parametrize("kw", CONV2D, ids=[str(i) for i in range(len(CONV2D))])
def test_conv2d_padding_forms_match_reference(kw):
    rng = _rng(14)
    groups = kw.get("groups", 1)
    x = rng.standard_normal((2, 4, 9, 10)).astype(np.float32)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ct = None

    def jf(a, ww, bb):
        out = jF.conv2d(paddle.Tensor(a), paddle.Tensor(ww),
                        paddle.Tensor(bb), **kw)._data
        return jnp.sum(out * ct), out

    want = jF.conv2d(_j(x), _j(w), _j(b), **kw).numpy()
    ct = rng.standard_normal(want.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jf(*a)[0], argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(v).requires_grad_() for v in (x, w, b))
    out = tF.conv2d(tx, tw, tb, **kw)
    _close(out.detach().numpy(), want, 1e-5)
    (out * torch.from_numpy(ct)).sum().backward()
    for t, g in zip((tx, tw, tb), jg):
        _close(t.grad.numpy(), np.asarray(g), 1e-5)


@pytest.mark.parametrize("kw", [dict(padding=1), dict(padding="SAME",
                                                      stride=2),
                                dict(padding=[2, 0]),
                                dict(padding=1, data_format="NLC")])
def test_conv1d_matches_reference(kw):
    rng = _rng(15)
    x = rng.standard_normal((2, 3, 11)).astype(np.float32)
    if kw.get("data_format") == "NLC":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    w = rng.standard_normal((5, 3, 3)).astype(np.float32)
    _close(tF.conv1d(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy(),
           jF.conv1d(_j(x), _j(w), **kw).numpy(), 1e-5)


@pytest.mark.parametrize("cls,kw", [
    ("Conv2D", dict(kernel_size=3, stride=2, padding=1)),
    ("Conv2D", dict(kernel_size=(1, 3), padding="SAME", bias_attr=False)),
    ("Conv2D", dict(kernel_size=3, padding=1, groups=2,
                    data_format="NHWC")),
    ("Conv1D", dict(kernel_size=3, padding=1))])
def test_conv_layers_state_init_and_forward(cls, kw):
    """State names and shapes equal the reference's (OI + kernel, whatever
    the data format); the weight is drawn Kaiming-uniform within
    ``sqrt(6 / fan_in)`` and the bias within ``1 / sqrt(fan_in)``; with the
    JAX layer's weights the forward matches."""
    jl = getattr(jnn, cls)(4, 6, **kw)
    tl = getattr(tnn, cls)(4, 6, device="cpu", **kw)
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    tsd = tl.state_dict()
    assert {k: v.shape for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in tsd.items()}
    fan_in = 4 * int(np.prod(tsd["weight"].shape[2:])) // kw.get("groups", 1)
    assert tsd["weight"].abs().max() <= (6 / fan_in) ** 0.5
    if "bias" in tsd:
        assert tsd["bias"].abs().max() <= fan_in ** -0.5
    convert.load_jax_state(tl, state)
    shape = (2, 4, 8, 8) if cls == "Conv2D" else (2, 4, 9)
    x = _rng(16).standard_normal(shape).astype(np.float32)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _close(tl(torch.from_numpy(x)).detach().numpy(), jl(_j(x)).numpy(), 1e-5)


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

POOLS = [
    ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", dict(kernel_size=2)),
    ("max_pool2d", dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("max_pool2d", dict(kernel_size=(2, 3), stride=(1, 2), padding=(1, 0),
                        data_format="NHWC")),
    ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
    ("avg_pool2d", dict(kernel_size=2, stride=2, ceil_mode=True)),
    ("avg_pool2d", dict(kernel_size=3, padding=1, divisor_override=4)),
    ("avg_pool2d", dict(kernel_size=2, padding=1, data_format="NHWC")),
    ("adaptive_avg_pool2d", dict(output_size=(1, 1))),
    ("adaptive_avg_pool2d", dict(output_size=3)),
    ("adaptive_avg_pool2d", dict(output_size=(4, 2))),
    ("adaptive_avg_pool2d", dict(output_size=(1, 1), data_format="NHWC")),
    ("adaptive_avg_pool2d", dict(output_size=(4, 3), data_format="NHWC")),
]


@pytest.mark.parametrize("name,kw", POOLS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(POOLS)])
def test_pools_match_reference(name, kw):
    """Forward and input gradient on a 7 x 9 grid. ``ceil_mode=True`` is a
    reference quirk, mirrored: the JAX pools never read it and floor the
    output size (7 -> 3 rows at kernel 3, stride 2, where ceil would give
    4)."""
    rng = _rng(17)
    x = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = getattr(jF, name)(_j(x), **kw).numpy()
    ct = rng.standard_normal(want.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(getattr(jF, name)(
        paddle.Tensor(a), **kw)._data * ct))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = getattr(tF, name)(tx, **kw)
    _close(out.detach().numpy(), want, 1e-6)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(tx.grad.numpy(), np.asarray(jg), 1e-6)
    if kw.get("ceil_mode"):
        assert want.shape[2] == (7 - kw["kernel_size"]) // kw.get(
            "stride", kw["kernel_size"]) + 1


def test_pool_layers_and_return_mask_waits():
    x = _rng(18).standard_normal((2, 3, 8, 8)).astype(np.float32)
    for cls, args in (("MaxPool2D", (3, 2, 1)), ("AvgPool2D", (2,)),
                      ("AdaptiveAvgPool2D", ((1, 1),))):
        _close(getattr(tnn, cls)(*args)(torch.from_numpy(x)).numpy(),
               getattr(jnn, cls)(*args)(_j(x)).numpy(), 1e-6)
    with pytest.raises(NotImplementedError, match="A12"):
        tF.max_pool2d(torch.from_numpy(x), 2, return_mask=True)


# ---------------------------------------------------------------------------
# multi-head attention and the encoder
# ---------------------------------------------------------------------------


def _encoder_pair(normalize_before, seed=19, **kw):
    paddle.seed(seed)
    jl = jnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=normalize_before, **kw)
    je = jnn.TransformerEncoder(jl, 2, jnn.LayerNorm(16)
                                if normalize_before else None)
    tl = tnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=normalize_before,
                                     device="cpu", **kw)
    te = tnn.TransformerEncoder(tl, 2, tnn.LayerNorm(16, device="cpu")
                                if normalize_before else None)
    state = {k: np.asarray(v) for k, v in je.functional_state().items()}
    rng = _rng(seed)
    state = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in state.items()}
    je.set_state_dict({k: _j(v) for k, v in state.items()})
    convert.load_jax_state(te, state)
    return je, te


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_transformer_encoder_matches_reference(normalize_before, masked):
    je, te = _encoder_pair(normalize_before)
    rng = _rng(20)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    mask = None
    if masked:
        keep = np.ones((2, 7), np.float32)
        keep[1, 5:] = 0
        mask = ((1.0 - keep[:, None, None, :]) * -1e9).astype(np.float32)
    want = je(_j(x), None if mask is None else _j(mask)).numpy()
    tx = torch.from_numpy(x).requires_grad_()
    out = te(tx, None if mask is None else torch.from_numpy(mask))
    _close(out.detach().numpy(), want, 1e-5)
    ct = rng.standard_normal(want.shape).astype(np.float32)
    params = {k: jnp.asarray(v) for k, v in
              je.functional_state(trainable_only=True).items()}
    from paddlepaddle_tpu.core import autograd as jag

    def jloss(p, a):
        with jag.no_grad(), je.bind_state(p):
            o = je(paddle.Tensor(a), None if mask is None else _j(mask))
        return jnp.sum(o._data * ct)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    (out * torch.from_numpy(ct)).sum().backward()
    _close(tx.grad.numpy(), np.asarray(jgx), 1e-5)
    # the key projection's bias shifts every logit of a row alike, so its
    # gradient is zero up to rounding: it is held against 1% of the
    # largest parameter gradient instead of its own largest value
    top = max(float(np.abs(np.asarray(g)).max()) for g in jgp.values())
    for n, p in te.named_parameters():
        _close(p.grad.numpy(), np.asarray(jgp[n]), 1e-4, floor=1e-2 * top)


def test_encoder_layers_are_deep_copies():
    te = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        8, 2, 16, device="cpu"), 3)
    sd = te.state_dict()
    for k in [k for k in sd if k.startswith("layers.0.")]:
        for i in (1, 2):
            other = k.replace("layers.0.", f"layers.{i}.")
            assert torch.equal(sd[k], sd[other])
            assert sd[k].data_ptr() != sd[other].data_ptr()
    je = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(8, 2, 16), 3)
    assert sorted(je.functional_state()) == sorted(sd)


def test_multi_head_attention_cache_and_cross_attention():
    paddle.seed(21)
    jm = jnn.MultiHeadAttention(16, 4, kdim=12, vdim=10)
    tm = tnn.MultiHeadAttention(16, 4, kdim=12, vdim=10, device="cpu")
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    convert.load_jax_state(tm, state)
    rng = _rng(22)
    q = rng.standard_normal((2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 12)).astype(np.float32)
    v = rng.standard_normal((2, 5, 10)).astype(np.float32)
    _close(tm(*(torch.from_numpy(a) for a in (q, k, v))).detach().numpy(),
           jm(_j(q), _j(k), _j(v)).numpy(), 1e-5)
    sm = tnn.MultiHeadAttention(16, 4, device="cpu")
    jsm = jnn.MultiHeadAttention(16, 4)
    convert.load_jax_state(sm, {kk: np.asarray(vv) for kk, vv in
                                jsm.functional_state().items()})
    past = rng.standard_normal((2, 4, 16)).astype(np.float32)
    jc = jsm.gen_cache(_j(past))
    tc = sm.gen_cache(torch.from_numpy(past))
    jo, (jk, jv) = jsm(_j(q), cache=jc)
    to, (tk, tv) = sm(torch.from_numpy(q), cache=tc)
    _close(to.detach().numpy(), jo.numpy(), 1e-5)
    assert tuple(tk.shape) == tuple(jk.shape) == (2, 7, 4, 4)
    _close(tv.detach().numpy(), jv.numpy(), 1e-5)
