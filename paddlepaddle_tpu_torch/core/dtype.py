"""Dtype names -> torch dtypes (counterpart of ``paddlepaddle_tpu/core/dtype.py``
for the floating dtypes the port's models and AMP use)."""

from __future__ import annotations

from typing import Union

import torch

_BY_NAME = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def to_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / ``"float16"`` (the names
    ``LlamaConfig.dtype`` and AMP use) or a torch dtype -> the torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _BY_NAME.values():
            raise ValueError(f"unsupported dtype {dtype} (float32, bfloat16, float16)")
        return dtype
    try:
        return _BY_NAME[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r} (float32, bfloat16, "
            "float16)") from None
