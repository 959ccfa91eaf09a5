"""Dtype names -> torch dtypes (counterpart of ``paddlepaddle_tpu/core/dtype.py``
for the two dtypes the serving slice uses)."""

from __future__ import annotations

from typing import Union

import torch

_BY_NAME = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def to_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (the names ``LlamaConfig.dtype`` uses)
    or a torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _BY_NAME.values():
            raise ValueError(f"unsupported dtype {dtype} (float32, bfloat16)")
        return dtype
    try:
        return _BY_NAME[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r} (float32, bfloat16)") from None
