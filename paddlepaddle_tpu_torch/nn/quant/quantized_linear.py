"""Weight-only int8 linear algebra for serving (counterpart of
``paddlepaddle_tpu/nn/quant/quantized_linear.py`` :32-338).

``weight_quantize`` / ``weight_dequantize`` / ``weight_only_linear`` /
``WeightOnlyLinear`` and the serving integration ``quantize_param_tree``
keep the reference's signatures, checks, errors and rounding: symmetric
absmax / 127 in f32, scales floored at 1e-10, round half to even, codes
clipped to +-127 (``torch.round`` and ``jnp.round`` agree, so the codes and
scales are bit-equal to the reference's). ``llm_int8_linear`` is not ported
(ROADMAP A11).

Layouts are the paddle ones, as ``nn.Linear``'s: weight ``[in, out]``,
scales ``[out]`` per channel (``group_size == -1``) or ``[in // group_size,
out]`` group-wise.

:func:`quantized_view` is the port's form of the reference engine binding a
quantized parameter tree: a module view of a model in which every selected
projection is a :class:`WeightOnlyLinear`, while everything else (the
embedding, the norms, the rope tables) is shared with the model, which is
left unchanged.
"""

from __future__ import annotations

import copy
import re
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ...core.dtype import to_torch_dtype
from ..common import Linear
from .qweight import QuantizedWeight

_ALGOS = ("weight_only_int8", "llm.int8")


def _check_algo(algo: str) -> None:
    if algo not in _ALGOS:
        raise NotImplementedError(
            f"weight quantize algo {algo!r}: int8 weight-only schemes "
            f"{_ALGOS} are supported (weight_only_int4 / PTQ calibration "
            "are honestly absent — PARITY.md)")


def _check_group(k: int, group_size: int) -> None:
    if group_size == -1:
        return
    if group_size <= 0 or k % group_size != 0:
        raise ValueError(
            f"group_size {group_size} must be -1 (per-channel) or a "
            f"positive divisor of in_features {k} (reference uses 64/128)")


def _q127(t: torch.Tensor) -> torch.Tensor:
    """127 as a 0-d tensor on ``t``'s device. PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently
    from the division the reference (and the CPU) computes; dividing by a
    device tensor divides."""
    return torch.full((), 127.0, dtype=t.dtype, device=t.device)


def _quantize_array(w: torch.Tensor, group_size: int = -1):
    """Symmetric int8 quantization of ``w [in, out]``: ``(q int8, scale
    f32)`` with scale ``[out]`` or ``[in // g, out]``."""
    wf = w.detach().float()
    k, n = wf.shape
    if group_size == -1:
        absmax = wf.abs().amax(dim=0)                        # [out]
    else:
        absmax = wf.reshape(k // group_size, group_size, n).abs().amax(
            dim=1)                                           # [G, out]
    scale = absmax / _q127(absmax)
    safe = scale.clamp_min(1e-10)     # an all-zero channel quantizes to 0
    if group_size == -1:
        q = torch.round(wf / safe).clamp_(-127, 127)
    else:
        wg = wf.reshape(k // group_size, group_size, n)
        q = torch.round(wg / safe[:, None, :]).clamp_(-127, 127).reshape(k, n)
    return q.to(torch.int8), scale


def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8",
                    arch=None, group_size: int = -1):
    """Symmetric int8 quantization of a matmul weight ``[in, out]``:
    returns ``(quantized int8, scales f32)``, scales ``[out]`` per channel
    or ``[in // group_size, out]`` group-wise. ``arch`` is accepted for
    API parity."""
    _check_algo(algo)
    if x.dim() != 2:
        raise ValueError(
            f"weight_quantize expects a 2-D matmul weight [in, out], got "
            f"shape {tuple(x.shape)}")
    _check_group(x.shape[0], group_size)
    return _quantize_array(x, group_size)


def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8", out_dtype="float32",
                      group_size: int = -1) -> torch.Tensor:
    """Inverse of :func:`weight_quantize` (debug and export)."""
    _check_algo(algo)
    return QuantizedWeight(x, scale, group_size=group_size,
                           out_dtype=to_torch_dtype(out_dtype)).dequantize()


def weight_only_linear(x: torch.Tensor, weight, bias=None, weight_scale=None,
                       weight_dtype: str = "int8", arch=None,
                       group_size: int = -1) -> torch.Tensor:
    """``y = x @ dequant(W) (+ b)`` with the scale applied after the product,
    cast to ``x.dtype``. ``weight`` is a :class:`QuantizedWeight` (scales
    inside) or the raw int8 tensor of :func:`weight_quantize` with
    ``weight_scale`` beside it."""
    if weight_dtype != "int8":
        raise NotImplementedError(
            f"weight_dtype {weight_dtype!r}: int8 is the supported scheme "
            "(int4 honestly absent — PARITY.md)")
    if isinstance(weight, QuantizedWeight):
        if weight_scale is not None:
            raise ValueError("weight is already a QuantizedWeight carrying "
                             "its scales; don't pass weight_scale too")
        qw = weight
    else:
        if weight_scale is None:
            raise ValueError(
                "weight_only_linear needs weight_scale when weight is a raw "
                "int8 tensor (use weight_quantize to produce both)")
        k = weight.shape[0]
        _check_group(k, group_size)
        # the scale's SHAPE must agree with the scheme: a [G, out] scale
        # under group_size=-1 would broadcast against the output silently
        want = 1 if group_size == -1 else 2
        if weight_scale.dim() != want:
            scheme = ("per-channel [out]" if want == 1
                      else "group-wise [in//group_size, out]")
            raise ValueError(
                f"weight_scale is {weight_scale.dim()}-D but group_size="
                f"{group_size} implies {scheme} scales — pass the group_size "
                "the weight was quantized with")
        if group_size != -1 and weight_scale.shape[0] != k // group_size:
            raise ValueError(
                f"group-wise weight_scale has {weight_scale.shape[0]} groups "
                f"but in_features {k} / group_size {group_size} = "
                f"{k // group_size}")
        qw = QuantizedWeight(weight, weight_scale, group_size=group_size)
    out = qw.wo_matmul(x)
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


# -- serving integration: quantize a parameter tree once ----------------------

# matmul weights worth quantizing: 2-D floating ".weight" params that are
# NOT token embeddings (a gather, not a matmul) or rope tables
_DEFAULT_SKIP = re.compile(r"embed_tokens|rope_|position_embedding")


def quantize_param_tree(params: Dict[str, torch.Tensor],
                        algo: str = "weight_only_int8", group_size: int = -1,
                        include: Optional[Callable] = None):
    """Quantize every eligible matmul weight of a ``{name: tensor}`` state
    (the port's ``named_parameters()`` + ``named_buffers()``, whose names
    are the reference's ``functional_state()`` names) into a
    :class:`QuantizedWeight`. ``include(name, tensor) -> bool`` overrides
    the default selection. Returns ``(new_params, meta)``; ``meta`` records
    what was quantized, what ``group_size`` left at full precision, and
    the weight bytes before and after."""
    _check_algo(algo)
    out: Dict[str, object] = {}
    names, skipped = [], []
    bytes_fp = bytes_q = 0
    for name, arr in params.items():
        floating = isinstance(arr, torch.Tensor) and arr.is_floating_point()
        ndim = arr.dim() if isinstance(arr, torch.Tensor) else 0
        if include is not None:
            # an explicit predicate picks the names, but a selected weight
            # must still BE quantizable
            eligible = bool(include(name, arr))
            if eligible:
                if ndim != 2 or not floating:
                    raise ValueError(
                        f"include selected {name!r} (shape "
                        f"{tuple(getattr(arr, 'shape', ()))}, dtype "
                        f"{getattr(arr, 'dtype', '?')}): only 2-D floating "
                        "matmul weights are quantizable")
                _check_group(arr.shape[0], group_size)
        else:
            eligible = (ndim == 2 and floating and name.endswith(".weight")
                        and not _DEFAULT_SKIP.search(name))
            if eligible and group_size != -1 \
                    and arr.shape[0] % group_size != 0:
                # a weight left at full precision while quant reports armed
                # misattributes an A/B: record it and warn
                eligible = False
                skipped.append(name)
        if not eligible:
            out[name] = arr
            continue
        q, s = _quantize_array(arr, group_size)
        out[name] = QuantizedWeight(q, s, group_size=group_size,
                                    out_dtype=arr.dtype)
        names.append(name)
        bytes_fp += arr.numel() * arr.element_size()
        bytes_q += q.numel() + s.numel() * s.element_size()
    if not names:
        raise ValueError(
            f"quantize_param_tree selected NO weights (group_size="
            f"{group_size}, {len(params)} params): every 2-D matmul weight "
            "failed eligibility — is group_size a divisor of the model's "
            "in_features?")
    if skipped:
        warnings.warn(
            f"quantize_param_tree: {len(skipped)} matmul weight(s) stay "
            f"FULL PRECISION — in_features not divisible by group_size "
            f"{group_size}: {skipped[:4]}{'…' if len(skipped) > 4 else ''} "
            "(per-channel group_size=-1 quantizes everything)",
            stacklevel=2)
    meta = {
        "algo": algo,
        "group_size": group_size,
        "quantized": names,
        "skipped_indivisible": skipped,
        "bytes_fp": int(bytes_fp),
        "bytes_q": int(bytes_q),
        "bytes_saved": int(bytes_fp - bytes_q),
    }
    return out, meta


class WeightOnlyLinear(nn.Module):
    """Inference-only Linear over a pre-quantized int8 weight (the layer
    form of :func:`weight_only_linear`; reference :300-338). The int8
    weight, its scales and the optional bias are buffers. Build one from a
    float ``Linear`` with :meth:`from_linear`."""

    def __init__(self, weight: torch.Tensor, weight_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, group_size: int = -1,
                 out_dtype="float32"):
        super().__init__()
        _check_group(weight.shape[0], group_size)
        self.group_size = int(group_size)
        self.out_dtype = out_dtype
        self.register_buffer("quant_weight", weight)
        self.register_buffer("weight_scale", weight_scale)
        self.register_buffer("bias", None if bias is None else bias.detach())
        self.in_features = int(weight.shape[0])
        self.out_features = int(weight.shape[1])

    @classmethod
    def from_linear(cls, linear: nn.Module, algo: str = "weight_only_int8",
                    group_size: int = -1) -> "WeightOnlyLinear":
        q, s = weight_quantize(linear.weight, algo=algo,
                               group_size=group_size)
        return cls(q, s, bias=getattr(linear, "bias", None),
                   group_size=group_size,
                   out_dtype=str(linear.weight.dtype).replace("torch.", ""))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return weight_only_linear(x, self.quant_weight, bias=self.bias,
                                  weight_scale=self.weight_scale,
                                  group_size=self.group_size)

    def extra_repr(self) -> str:
        g = self.group_size
        return (f"in={self.in_features}, out={self.out_features}, int8 "
                + ("per-channel" if g == -1 else f"group_size={g}"))


def _view(module: nn.Module, prefix: str,
          replace: Dict[str, nn.Module]) -> nn.Module:
    """A shallow copy of ``module`` whose children are views too, with the
    modules named in ``replace`` swapped in; parameters and buffers are
    shared, never copied."""
    if prefix in replace:
        return replace[prefix]
    if not any(k.startswith(prefix) for k in replace):
        return module                    # nothing below is replaced
    new = copy.copy(module)
    new.__dict__["_modules"] = {
        name: None if child is None
        else _view(child, f"{prefix}{name}.", replace)
        for name, child in module._modules.items()}
    return new


def quantized_view(model: nn.Module, algo: str = "weight_only_int8",
                   group_size: int = -1) -> Tuple[nn.Module, dict]:
    """``(view, meta)``: :func:`quantize_param_tree` over the model's
    parameters and buffers (the reference's ``functional_state()``), and a
    view of ``model`` in which the ``Linear`` owning each quantized weight
    is a :class:`WeightOnlyLinear` over its int8 buffers. The embedding,
    the norms and the rope tables are the model's own tensors; ``model``
    itself is not changed, so it keeps computing in full precision."""
    state = dict(model.named_parameters())
    state.update(dict(model.named_buffers()))
    qstate, meta = quantize_param_tree(state, algo=algo,
                                       group_size=group_size)
    modules = dict(model.named_modules())
    replace = {}
    for name in meta["quantized"]:
        owner_name = name[: -len(".weight")]
        owner = modules.get(owner_name)
        if not isinstance(owner, Linear):
            raise ValueError(
                f"quantized weight {name!r} does not belong to a Linear; "
                "the view can only swap Linear projections")
        qw = qstate[name]
        replace[owner_name + "."] = WeightOnlyLinear(
            qw.q, qw.scale, group_size=qw.group_size,
            out_dtype=str(qw.out_dtype).replace("torch.", ""))
    return _view(model, "", replace), meta
