"""QuantizedWeight: the int8 weight payload of weight-only serving
(counterpart of ``paddlepaddle_tpu/nn/quant/qweight.py``).

It holds the int8 tensor ``q [in, out]`` and its scales, per output channel
(``scale [out]``, ``group_size == -1``) or per group of ``group_size`` input
rows (``scale [in // group_size, out]``). ``F.linear`` detects it, duck-typed
on ``wo_matmul``, and multiplies with the scale AFTER the product, in the
reference's rounding order:

    per channel:  y = (x @ q.to(cd)) * scale.to(cd)
    group-wise:   y = sum_g (x_g @ q_g.to(cd)) * scale_g.to(cd)

where ``cd`` is the input's floating dtype. XLA fuses the int8 -> bf16
convert into the dot, so the TPU reads only the int8 bytes; PyTorch does
not fuse it, and ``q.to(cd)`` writes a full-precision copy that the matmul
then reads (PERF.md, "wo-matmul"). A kernel that reads only the int8 weight
is a ROADMAP perf item.

This module imports nothing of the rest of the package (only torch).
"""

from __future__ import annotations

import torch


class QuantizedWeight:
    """Weight-only-quantized matmul weight: int8 ``q`` in the logical layout
    ``[in, out]`` with per-channel (``scale [out]``) or group-wise
    (``scale [in // group_size, out]``) scales. ``group_size == -1`` means
    per output channel."""

    __slots__ = ("q", "scale", "group_size", "out_dtype")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 group_size: int = -1,
                 out_dtype: torch.dtype = torch.float32):
        self.q = q
        self.scale = scale
        self.group_size = int(group_size)
        self.out_dtype = out_dtype

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self) -> torch.dtype:
        """The storage dtype, int8."""
        return self.q.dtype

    def __repr__(self) -> str:
        return (f"QuantizedWeight(shape={self.shape}, "
                f"group_size={self.group_size}, "
                f"scale={tuple(self.scale.shape)}, "
                f"out_dtype={str(self.out_dtype).replace('torch.', '')})")

    def dequantize(self) -> torch.Tensor:
        """The full-precision weight ``[in, out]`` in ``out_dtype`` (debug
        and export; the serving path never calls this)."""
        od = self.out_dtype
        if self.group_size == -1:
            return self.q.to(od) * self.scale.to(od)[None, :]
        k, n = self.q.shape
        g = self.group_size
        qg = self.q.reshape(k // g, g, n).to(od)
        return (qg * self.scale.to(od)[:, None, :]).reshape(k, n)

    def wo_matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W`` with the scale applied to the product (per channel) or
        to the per-group partials ``[..., G, out]`` before the sum over the
        groups (group-wise). ``x``: ``[..., in]``."""
        cd = x.dtype if x.is_floating_point() else self.out_dtype
        if self.group_size == -1:
            return torch.matmul(x, self.q.to(cd)) * self.scale.to(cd)
        k, n = self.q.shape
        g = self.group_size
        xg = x.reshape(x.shape[:-1] + (k // g, g))
        qg = self.q.reshape(k // g, g, n).to(cd)
        part = torch.einsum("...gk,gkn->...gn", xg, qg)
        return torch.sum(part * self.scale.to(cd), dim=-2)
