"""``LayerNorm``, ``RMSNorm`` and the batch norms (counterparts of
``paddlepaddle_tpu/nn/norm.py`` :11, :35, :55-103).

Each keeps the reference's positional parameters; ``device`` and ``dtype``
are keyword-only, as for ``Linear``. Weights start at ones and biases at
zeros. A batch norm's running statistics are the f32 buffers ``_mean``
(zeros) and ``_variance`` (ones), the reference's state names, so
``convert.load_jax_state`` carries them; ``Module.to(dtype)`` casts them
with the parameters, as the reference's ``Layer.to(dtype=)`` does."""

from __future__ import annotations

import torch
from torch import nn

from ..core.dtype import to_torch_dtype
from ..device import resolve_device
from . import functional as F
from .common import check_attr


def _affine(owner: str, shape, weight_attr, bias_attr, dev, dt):
    """(weight of ones, bias of zeros), each None when its attr is False."""
    check_attr(owner, "weight_attr", weight_attr, allow_false=True)
    check_attr(owner, "bias_attr", bias_attr, allow_false=True)
    weight = (nn.Parameter(torch.ones(shape, device=dev, dtype=dt))
              if weight_attr is not False else None)
    bias = (nn.Parameter(torch.zeros(shape, device=dev, dtype=dt))
            if bias_attr is not False else None)
    return weight, bias


class LayerNorm(nn.Module):
    """:func:`..functional.layer_norm` over the trailing
    ``normalized_shape`` axes."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight, self.bias = _affine(
            "LayerNorm", self.normalized_shape, weight_attr, bias_attr,
            resolve_device(device), to_torch_dtype(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self.normalized_shape}, "
                f"epsilon={self.epsilon}")


class RMSNorm(nn.Module):
    """RMS norm over the last axis with a weight of ``normalized_shape``
    (ones), and a zero bias when ``bias_attr`` is True (the reference's
    default ``bias_attr=False`` builds none)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-6,
                 weight_attr=None, bias_attr=False, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        check_attr("RMSNorm", "weight_attr", weight_attr, allow_false=False)
        check_attr("RMSNorm", "bias_attr", bias_attr, allow_false=True)
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=dev, dtype=dt))
        self.bias = (nn.Parameter(torch.zeros(self.normalized_shape,
                                              device=dev, dtype=dt))
                     if bias_attr not in (False, None) else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.bias, self.epsilon)


class _BatchNormBase(nn.Module):
    """:func:`..functional.batch_norm` over ``num_features`` channels:
    batch statistics and an in-place running-average update in training
    mode (unless ``use_global_stats``), the running statistics in eval."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _affine(
            type(self).__name__, [num_features], weight_attr, bias_attr, dev,
            to_torch_dtype(dtype))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    """Over ``[n, c]`` or ``[n, c, l]`` (``"NCL"``, the default) or
    channels-last ``"NLC"``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCL", use_global_stats=None, name=None,
                 *, device=None, dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format == "NCL" else data_format,
                         use_global_stats, device=device, dtype=dtype)


class BatchNorm2D(_BatchNormBase):
    pass
