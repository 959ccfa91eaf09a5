"""Functional subset the Llama, MoE, ResNet, BERT and GPT paths need
(counterpart of ``paddlepaddle_tpu/nn/functional.py``: the activations
:23-135, ``swiglu`` :137, ``softmax`` / ``log_softmax`` :144-159, ``linear``
:183, ``embedding`` :202, ``dropout`` :233, ``layer_norm`` :316,
``rms_norm`` :336, ``batch_norm`` :411 with its hand-written backward
``_bn_train_core`` :351-408, ``conv1d`` / ``conv2d`` :599-632,
``max_pool2d`` :689, ``avg_pool2d`` :711, ``adaptive_avg_pool2d`` :803, the
losses :920-1083 (``cross_entropy``, ``softmax_with_cross_entropy``,
``mse_loss``, ``l1_loss``, ``smooth_l1_loss``, ``nll_loss``,
``binary_cross_entropy``, ``binary_cross_entropy_with_logits``,
``kl_div``, ``cosine_similarity``, ``cosine_embedding_loss``,
``margin_ranking_loss``, ``hinge_embedding_loss``,
``triplet_margin_loss``), ``scaled_dot_product_attention`` :1193,
``flash_attention`` :1206, ``flash_attn_unpadded`` :1215). Plain tensor
functions; weights keep the paddle layout ``W: [in, out]`` and the
convolutions' OIHW; attention keeps the ``[b, s, h, d]`` layout, varlen
attention the packed ``[t, h, d]``.

Each function whose reference op carries a name passes its tensor inputs
through :func:`..amp.amp_cast` under that name (``linear``, ``embedding``,
``rms_norm``, ``layer_norm``, ``batch_norm``, ``conv2d``, the named
activations, ``softmax``, ``log_softmax``, ``cross_entropy`` ...); the losses
the reference computes in an unnamed op pass ``None``, as the reference's
hook sees them (so its black-list entries ``mse_loss``, ``nll_loss`` & co.
never match there, nor here).

Random draws (``dropout``, ``rrelu`` in training) come from the port's
seeded streams (:mod:`..core.random`), never torch's global generator;
they cannot equal the JAX package's PRNG draws, only be reproducible from
one seed."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as _tF

from ..amp import amp_cast
from ..core import random as _random
from ..core.dtype import to_torch_dtype
from ..core.errors import not_ported


# ---------------------------------------------------------------------------
# activations (reference :23-135)
# ---------------------------------------------------------------------------


def _act(fn, op_name: str):
    """An activation that passes the AMP hook as the reference's named op
    ``op_name`` (:26-30)."""
    def op(x, name=None):
        (x,) = amp_cast(op_name, x)
        return fn(x)

    op.__name__ = op_name
    return op


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


relu = _act(torch.relu, "relu")
relu6 = _act(lambda a: torch.clamp(a, 0.0, 6.0), "relu6")
sigmoid = _act(torch.sigmoid, "sigmoid")
tanh = _act(torch.tanh, "tanh")
silu = _act(_tF.silu, "silu")
swish = silu
mish = _act(lambda a: a * torch.tanh(_softplus(a)), "mish")
softsign = _act(lambda a: a / (1 + torch.abs(a)), "softsign")
tanhshrink = _act(lambda a: a - torch.tanh(a), "tanhshrink")
log_sigmoid = _act(lambda a: -_softplus(-a), "log_sigmoid")


def gelu(x, approximate: bool = False, name=None):
    """``x Phi(x)``: exact (erf) by default, the tanh approximation with
    ``approximate=True`` (reference :46, ``jax.nn.gelu``)."""
    (x,) = amp_cast("gelu", x)
    return _tF.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = amp_cast(None, x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    (x,) = amp_cast(None, x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = amp_cast(None, x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = amp_cast(None, x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = amp_cast(None, x)
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    (x,) = amp_cast(None, x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    (x,) = amp_cast(None, x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardshrink(x, threshold=0.5, name=None):
    (x,) = amp_cast(None, x)
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    (x,) = amp_cast(None, x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta x > threshold``, else ``softplus(beta x) / beta``
    (reference :86)."""
    (x,) = amp_cast(None, x)
    return torch.where(beta * x > threshold, x, _softplus(beta * x) / beta)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    (x,) = amp_cast(None, x)
    return torch.where(x > threshold, x, torch.full_like(x, value))


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x > 0, x, w x)``: one weight for every channel, or one a
    channel on axis 1 (``NC...``) or the last axis."""
    x, weight = amp_cast(None, x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        sh = [1] * x.dim()
        sh[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        w = weight.reshape(sh)
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Leaky ReLU whose slope is drawn uniform in ``[lower, upper)`` per
    element in training (from the port's stream for ``x``'s device), the
    midpoint otherwise."""
    if training:
        slope = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        slope.uniform_(lower, upper,
                       generator=_random.torch_generator(x.device))
        (x,) = amp_cast(None, x)
        return torch.where(x >= 0, x, slope.to(x.dtype) * x)
    return leaky_relu(x, (lower + upper) / 2.0)


def maxout(x, groups, axis=1, name=None):
    (x,) = amp_cast(None, x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (groups, c // groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax)


def glu(x, axis=-1, name=None):
    (x,) = amp_cast(None, x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def linear(x: torch.Tensor, weight, bias: Optional[torch.Tensor] = None,
           name=None) -> torch.Tensor:
    """``y = x @ W (+ b)`` with ``W: [in, out]`` (reference :183). A weight
    that carries ``wo_matmul`` (an ``nn.quant.QuantizedWeight``) lowers
    through it, int8 codes with the scale applied after the product, and
    the result is cast back to ``x.dtype``. ``name`` is accepted for API
    parity."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    wo = getattr(weight, "wo_matmul", None)
    out = torch.matmul(x, weight) if wo is None else wo(x).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None,
              sparse: bool = False, name=None) -> torch.Tensor:
    """Row gather ``weight[x]`` (reference :202). Positions whose id is
    ``padding_idx`` (negative counts from the end) read zeros, so that row
    gets no gradient from them. ``sparse`` and ``name`` are accepted, and,
    as in the reference, not read."""
    (weight,) = amp_cast("embedding", weight)
    out = weight[x]
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
        out = out.masked_fill((x == pad)[..., None], 0.0)
    return out


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None,
           name=None) -> torch.Tensor:
    """``silu(x) * y``; with ``y`` None, ``x``'s last axis is split in two
    halves, ``silu(first) * second`` (reference :137-141)."""
    if y is None:
        (x,) = amp_cast(None, x)
        half = x.shape[-1] // 2
        return _tF.silu(x[..., :half]) * x[..., half:]
    x, y = amp_cast(None, x, y)
    return _tF.silu(x) * y


def softmax(x: torch.Tensor, axis: int = -1, dtype=None,
            name=None) -> torch.Tensor:
    """Softmax over ``axis``, in ``dtype`` when given (reference :144)."""
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1, dtype=None,
                name=None) -> torch.Tensor:
    """Log-softmax over ``axis``, in ``dtype`` when given (reference
    :153)."""
    (x,) = amp_cast("log_softmax", x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1, name=None) -> torch.Tensor:
    """RMS norm over the last axis in the reference's exact order (:336): f32
    mean of squares -> rsqrt -> cast back to the input dtype -> multiply by
    the weight -> add the bias. ``begin_norm_axis`` must name the last axis
    (-1 or ``x.dim() - 1``); another axis raises ``NotImplementedError``.
    ``name`` is accepted for API parity."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"rms_norm: begin_norm_axis={begin_norm_axis} (only the last "
            f"axis, -1 or {x.dim() - 1}, is normalised)")
    x, weight, bias = amp_cast("rms_norm", x, weight, bias)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# dropout (reference :233)
# ---------------------------------------------------------------------------


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None) -> torch.Tensor:
    """Zero each element with probability ``p`` (one draw per position of
    the axes in ``axis``, broadcast over the others). ``"upscale_in_train"``
    divides the kept values by ``1 - p`` in training and is the identity
    in eval; ``"downscale_in_infer"`` keeps them as they are in training
    and multiplies by ``1 - p`` in eval. The mask draws from the port's
    stream for ``x``'s device (:func:`..core.random.torch_generator`)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = amp_cast(None, x)
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    (x,) = amp_cast("dropout", x)
    keep = torch.rand(shape, device=x.device,
                      generator=_random.torch_generator(x.device)) < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
    return torch.where(keep, x, zero)


# ---------------------------------------------------------------------------
# normalization (reference :316-507)
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None) -> torch.Tensor:
    """Normalise over the trailing ``normalized_shape`` axes in the
    reference's order (:316): f32 mean and (biased) variance, the
    normalised value cast to the input dtype, then the weight and the bias
    in that dtype. (``torch.nn.functional.layer_norm`` applies the affine in
    f32 and rounds once, which differs in bf16.)"""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _channel_view(x: torch.Tensor, ch_axis: int):
    """The reduction axes (all but ``ch_axis``) and the shape a
    per-channel vector broadcasts with."""
    axes = [i for i in range(x.dim()) if i != ch_axis]
    sh = [1] * x.dim()
    sh[ch_axis] = x.shape[ch_axis]
    return axes, sh


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm with the reference's hand-written forward
    and backward (``_bn_train_core``, :351-408).

    Forward, in f32: ``mean = E[x]`` and ``var = max(E[x^2] - mean^2, 0)``
    in one data pass, then one multiply-add, ``y = x scale + shift`` with
    ``scale = w rsqrt(var + eps)`` and ``shift = b - mean scale``, cast to
    ``x``'s dtype. Returns ``(y, mean, var)``; the stats feed only the
    running-average update, so they are marked non-differentiable.

    Backward: the fused formula (:390-406), not autograd of the forward:
    ``dw = sum(dy xhat)``, ``db = sum(dy)``, ``dx = w rsqrt(var + eps)
    (dy - mean(dy) - xhat mean(dy xhat))`` with ``xhat`` rebuilt from the
    saved input and stats. ``weight`` and ``bias`` arrive in f32 and their
    gradients leave in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon: float, ch_axis: int):
        axes, sh = _channel_view(x, ch_axis)
        xf = x.float()
        mean = xf.mean(dim=axes)
        sq = (xf * xf).mean(dim=axes)
        var = torch.clamp(sq - mean * mean, min=0.0)
        scale = torch.rsqrt(var + epsilon) * weight
        shift = bias - mean * scale
        y = torch.addcmul(shift.reshape(sh), xf, scale.reshape(sh))
        ctx.save_for_backward(x, weight, mean, var)
        ctx.epsilon, ctx.ch_axis = epsilon, ch_axis
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, var = ctx.saved_tensors
        axes, sh = _channel_view(x, ctx.ch_axis)
        n = float(x.numel() // x.shape[ctx.ch_axis])
        ct = dy.float()
        r = torch.rsqrt(var + ctx.epsilon)
        xhat = (x.float() - mean.reshape(sh)) * r.reshape(sh)
        ct_sum = ct.sum(dim=axes)
        ctxhat_sum = (ct * xhat).sum(dim=axes)
        dx = (weight * r).reshape(sh) * (ct - (ct_sum / n).reshape(sh)
                                          - xhat * (ctxhat_sum / n).reshape(sh))
        return dx.to(x.dtype), ctxhat_sum, ct_sum, None, None


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None, name=None) -> torch.Tensor:
    """Batch norm over every axis but the channel's (axis 1 for ``"NC..."``
    formats, the last otherwise), reference :411-507.

    With batch statistics (``training`` and not ``use_global_stats``):
    :class:`_BatchNormTrain`, then the running statistics are updated IN
    PLACE with Paddle's convention, ``r = momentum r + (1 - momentum)
    stat``, the variance unbiased by ``n / (n - 1)``, each cast to its
    buffer's dtype (the reference's eager semantics; note that its jitted
    ``TrainStep`` binds the buffers as constants and never updates them).
    Otherwise the running statistics fold into one f32 scale and shift."""
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    xc, w, b, rm, rv = amp_cast("batch_norm", x, weight, bias, running_mean,
                                running_var)
    axes, sh = _channel_view(xc, ch_axis)
    if training and not use_global_stats:
        c = xc.shape[ch_axis]
        wf = (torch.ones(c, dtype=torch.float32, device=xc.device)
              if w is None else w.float())
        bf = (torch.zeros(c, dtype=torch.float32, device=xc.device)
              if b is None else b.float())
        y, mean, var = _BatchNormTrain.apply(xc, wf, bf, epsilon, ch_axis)
        n = xc.numel() // c
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * (var * (n / max(n - 1, 1))))
        return y
    scale = torch.rsqrt(rv.float() + epsilon)
    if w is not None:
        scale = scale * w.float()
    shift = -rm.float() * scale
    if b is not None:
        shift = shift + b.float()
    return (xc.float() * scale.reshape(sh) + shift.reshape(sh)).to(xc.dtype)


# ---------------------------------------------------------------------------
# convolution and pooling (reference :592-832)
# ---------------------------------------------------------------------------


def _tup(v, n: int) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _pad_pairs(padding, nd: int, spatial, kernel, stride, dilation):
    """The reference's padding forms (:599-611) as ``(before, after)`` per
    spatial dimension: an int, one int a dimension, ``2 nd`` ints
    ``(before, after)`` in dimension order, ``"VALID"``, or ``"SAME"`` with
    XLA's split (the larger half after), which for a stride > 1 can be
    asymmetric."""
    if isinstance(padding, str):
        pad = padding.upper()
        if pad == "VALID":
            return [(0, 0)] * nd
        if pad != "SAME":
            raise ValueError(f"padding {padding!r}: SAME, VALID, an int or "
                             "a list of ints")
        pairs = []
        for size, k, s, d in zip(spatial, kernel, stride, dilation):
            out = -(-size // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    p = _tup(padding, nd)
    if len(p) == nd:
        return [(pi, pi) for pi in p]
    return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             data_format, op_name):
    """``lax.conv_general_dilated`` as the reference calls it (:599-632):
    weights ``[out, in / groups, *kernel]`` (OI + spatial, whatever the
    data format), a channels-last input moved to channels-first and back,
    an asymmetric padding applied explicitly, the bias added after the
    product in the output's dtype."""
    x, weight, bias = amp_cast(op_name, x, weight, bias)
    chan_last = not data_format.startswith("NC")
    if chan_last:
        x = x.movedim(-1, 1)
    stride, dilation = _tup(stride, nd), _tup(dilation, nd)
    pairs = _pad_pairs(padding, nd, x.shape[2:], weight.shape[2:], stride,
                       dilation)
    if all(a == b for a, b in pairs):
        pad = [a for a, _ in pairs]
    else:
        x = _tF.pad(x, [v for pr in reversed(pairs) for v in pr])
        pad = [0] * nd
    conv = _tF.conv1d if nd == 1 else _tF.conv2d
    out = conv(x, weight, None, stride, pad, dilation, groups)
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return out.movedim(1, -1) if chan_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format, "conv2d")


def _pool_args(kernel_size, stride, padding):
    ks = _tup(kernel_size, 2)
    return ks, _tup(stride if stride is not None else kernel_size, 2), \
        _tup(padding, 2)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Window maxima over a ``-inf`` (integers: the type's least value)
    padding of ``padding`` a side (reference :689). As in the reference,
    the output size always floors: ``ceil_mode`` is not read (the JAX
    package reads it only to refuse it with ``return_mask``).
    ``return_mask`` is not ported yet."""
    if return_mask:
        raise not_ported("max_pool2d(return_mask=True)", "A12, queue A item 5")
    ks, st, p = _pool_args(kernel_size, stride, padding)
    (x,) = amp_cast("max_pool2d", x)
    if data_format != "NCHW":
        x = x.movedim(-1, 1)
    if p[0] or p[1]:
        fill = (float("-inf") if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        x = _tF.pad(x, [p[1], p[1], p[0], p[0]], value=fill)
    out = _tF.max_pool2d(x, ks, st)
    return out if data_format == "NCHW" else out.movedim(1, -1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Window sums in f32 over a zero padding, divided by
    ``divisor_override`` when it is set, else by the in-bounds cells of
    each window when ``exclusive`` and there is padding, else by the window
    size; cast back to the input dtype (reference :711). ``ceil_mode`` is
    not read: the output size floors, as in the reference."""
    ks, st, p = _pool_args(kernel_size, stride, padding)
    (x,) = amp_cast("avg_pool2d", x)
    a = x if data_format == "NCHW" else x.movedim(-1, 1)
    pad = [p[1], p[1], p[0], p[0]]

    def window_sums(t):
        return _tF.avg_pool2d(_tF.pad(t, pad), ks, st, divisor_override=1)

    summed = window_sums(a.float())
    if divisor_override:
        out = summed / divisor_override
    elif exclusive and (p[0] or p[1]):
        out = summed / window_sums(torch.ones_like(a, dtype=torch.float32))
    else:
        out = summed / (ks[0] * ks[1])
    out = out.to(x.dtype)
    return out if data_format == "NCHW" else out.movedim(1, -1)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Means over an ``output_size`` grid of windows (reference :803): a
    reshape when the size divides the input, else windows from
    ``floor(i h / oh)`` to ``ceil((i + 1) h / oh)``. Mirrored as the
    reference has it: that second branch stacks its means channels-first
    whatever ``data_format`` says."""
    os_ = _tup(output_size, 2)
    (x,) = amp_cast(None, x)
    nchw = data_format == "NCHW"
    h, w = (x.shape[2], x.shape[3]) if nchw else (x.shape[1], x.shape[2])
    if h % os_[0] == 0 and w % os_[1] == 0:
        kh, kw = h // os_[0], w // os_[1]
        if nchw:
            return x.reshape(x.shape[0], x.shape[1], os_[0], kh, os_[1],
                             kw).mean(dim=(3, 5))
        return x.reshape(x.shape[0], os_[0], kh, os_[1], kw,
                         x.shape[-1]).mean(dim=(2, 4))
    rows = []
    for i in range(os_[0]):
        hs, he = (i * h) // os_[0], -(-((i + 1) * h) // os_[0])
        cols = []
        for j in range(os_[1]):
            ws, we = (j * w) // os_[1], -(-((j + 1) * w) // os_[1])
            if nchw:
                cols.append(x[:, :, hs:he, ws:we].mean(dim=(2, 3)))
            else:
                cols.append(x[:, hs:he, ws:we, :].mean(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 name=None) -> torch.Tensor:
    """Attention over ``[b, s, h, d]``: the flash kernels on the card, the
    plain version on the CPU (see ``ops/kernels/flash_attention.py``).
    ``name`` is accepted for API parity."""
    from ..ops.kernels.flash_attention import flash_attention_bshd

    return flash_attention_bshd(query, key, value, causal=is_causal,
                                mask=attn_mask,
                                dropout=dropout_p if training else 0.0)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None):
    """``(out, None)``: the softmax is never returned, as in the reference
    (:1206, same argument order). A dropout draws from a generator seeded
    with ``fixed_seed_offset`` when given, else from the named generator
    ``rng_name`` of ``core.random`` (the default one for ``""``)."""
    from ..core import random
    from ..ops.kernels.flash_attention import flash_attention_bshd

    drop = float(dropout) if training else 0.0
    gen = (random.dropout_generator(query.device, fixed_seed_offset,
                                    rng_name) if drop > 0.0 else None)
    out = flash_attention_bshd(query, key, value, causal=causal,
                               dropout=drop, generator=gen)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, fixed_seed_offset=None,
                        rng_name: str = "", training: bool = True,
                        name=None):
    """Packed varlen attention (reference flash_attention.py:762): the
    varlen kernels on the card, the plain version on the CPU (see
    ``ops/kernels/flash_varlen.py``). Returns ``(out, None)``.
    ``fixed_seed_offset`` reaches the dropout, where the JAX package's
    functional wrapper (:1215) drops it."""
    from ..ops.kernels.flash_varlen import flash_attn_unpadded as _impl

    return _impl(query, key, value, cu_seqlens_q, cu_seqlens_k,
                 max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k,
                 scale=scale, dropout=dropout, causal=causal,
                 return_softmax=return_softmax,
                 fixed_seed_offset=fixed_seed_offset, rng_name=rng_name,
                 training=training)


# ---------------------------------------------------------------------------
# losses (reference nn/functional.py :909-1083)
# ---------------------------------------------------------------------------


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _pick(logp: torch.Tensor, index: torch.Tensor, axis: int) -> torch.Tensor:
    """``logp``'s entry at ``index`` along ``axis`` (``index`` has ``logp``'s
    shape without that axis)."""
    axis = axis % logp.dim()
    return logp.gather(axis, index.unsqueeze(axis)).squeeze(axis)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy in f32 (reference :920-957, the same branches).

    * ``use_softmax`` takes ``input`` as logits (log-softmax over ``axis``),
      otherwise as probabilities (their log, floored at 1e-30).
    * Soft labels (``soft_label``, or a label of ``input``'s shape):
      ``-sum(target * logp)``, the target smoothed to ``target (1 - ls) +
      ls / classes`` by ``label_smoothing``; every row counts.
    * Hard labels: ``-logp[label]`` (a label with a trailing axis of 1 is
      squeezed), mixed by ``label_smoothing`` with the mean ``logp`` of the
      row; rows whose label is ``ignore_index`` count 0. With ``weight``,
      each row is scaled by ``weight[label]`` and ``"mean"`` divides by
      ``sum(weight[label] * valid)``; without, by the number of valid rows.
    * ``reduction``: "mean", "sum" or "none"."""
    input, label, weight = amp_cast("cross_entropy", input, label, weight)
    lf = input.float()
    if use_softmax:
        logp = torch.log_softmax(lf, dim=axis)
    else:
        logp = torch.log(torch.clamp(lf, min=1e-30))
    n_classes = input.shape[axis]
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape):
        tgt = label.float()
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(tgt * logp).sum(dim=axis)
        valid = torch.ones_like(loss)
    else:
        lab = label.long()
        if lab.dim() == input.dim():
            lab = lab.squeeze(axis)
        valid = (lab != ignore_index).float()
        safe = torch.where(lab == ignore_index, torch.zeros_like(lab), lab)
        picked = _pick(logp, safe, axis)
        if label_smoothing > 0:
            smooth = logp.mean(dim=axis)
            picked = (1 - label_smoothing) * picked + label_smoothing * smooth
        loss = -picked * valid
        if weight is not None:
            w_row = weight[safe]
            loss = loss * w_row
            if reduction == "mean":
                return loss.sum() / torch.clamp((w_row * valid).sum(),
                                                min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum(), min=1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row cross entropy with ``axis`` kept as 1 (reference :960), and
    the softmax with it when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast(None, input, label)
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast(None, input, label)
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = amp_cast(None, input, label)
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[label]`` over log-probabilities ``input [..., C]``, rows of
    ``ignore_index`` counted 0, weighted by ``weight[label]``; "mean"
    divides by the summed row weights (reference :992)."""
    input, label, weight = amp_cast(None, input, label, weight)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = -_pick(input, safe, -1)
    wv = valid.to(picked.dtype)
    if weight is not None:
        wv = wv * weight[safe]
    picked = picked * wv
    if reduction == "mean":
        return picked.sum() / torch.clamp(wv.sum(), min=1e-12)
    return _reduce(picked, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = amp_cast(None, input, label, weight)
    p = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z y + log1p(exp(-|z|))``; with ``pos_weight`` the
    log term is scaled by ``1 + (pos_weight - 1) y``, as in the reference
    (:1010)."""
    logit, label, weight, pos_weight = amp_cast(None, logit, label, weight,
                                                pos_weight)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        soft = (1 + (pos_weight - 1) * label) * soft
    base = torch.clamp(logit, min=0) - logit * label + soft
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    input, label = amp_cast(None, input, label)
    target = torch.exp(label) if log_target else label
    log_t = label if log_target else torch.log(torch.clamp(label, min=1e-12))
    pointwise = target * (log_t - input)
    if reduction == "batchmean":
        return pointwise.sum() / input.shape[0]
    return _reduce(pointwise, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = amp_cast(None, x1, x2)
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    sim = cosine_similarity(input1, input2, axis=-1)
    sim, label = amp_cast(None, sim, label)
    loss = torch.where(label == 1, 1 - sim, torch.clamp(sim - margin, min=0.0))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = amp_cast(None, input, other, label)
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = amp_cast(None, input, label)
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(d(a, pos) - d(a, neg) + margin, 0)`` with p-norm distances
    over the last axis (``swap``: the smaller of d(a, neg) and d(pos,
    neg)). ``epsilon`` is accepted and, as in the reference, not read."""
    input, positive, negative = amp_cast(None, input, positive, negative)

    def dist(a, b):
        return (torch.abs(a - b) ** p).sum(dim=-1) ** (1 / p)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


# the packed-QKV entries live in nn/long_tail.py, which imports this module;
# the reference exposes them here (reference :1626)
from .long_tail import (flash_attn_qkvpacked,  # noqa: E402,F401
                        flash_attn_varlen_qkvpacked)
