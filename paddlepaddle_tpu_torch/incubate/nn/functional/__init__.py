"""incubate.nn.functional subset of the port: ``swiglu`` (already fused,
as in the reference) and the padded-batch varlen
attention entry (counterpart of the JAX package's
``incubate/nn/functional/__init__.py`` :266)."""

from __future__ import annotations

import numpy as np
import torch

from ....nn import functional as F
from ....nn.functional import swiglu  # noqa: F401


def _lengths(lens, b: int, name: str) -> np.ndarray:
    arr = np.asarray(lens.detach().cpu().numpy()
                     if isinstance(lens, torch.Tensor) else lens)
    arr = arr.reshape(-1).astype(np.int64)
    if arr.shape[0] != b:
        raise ValueError(f"{name} has {arr.shape[0]} entries for batch {b}")
    return arr


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0, name=None):
    """Attention over a padded batch ``[b, h, s, d]`` whose sequence i holds
    ``seq_lens[i]`` queries and ``kv_seq_lens[i]`` keys: the valid rows are
    packed, go through :func:`...nn.functional.flash_attn_unpadded` and come
    back as ``[b, h, s_q, d]`` with zeros past each length.

    Deviation from the JAX package, whose function never reads ``mask`` or
    ``pre_cache_length`` (:266-297): a ``mask`` or a nonzero
    ``pre_cache_length`` raises ``NotImplementedError``, because an answer
    that ignored them would be wrong without a sign of it.
    """
    if mask is not None:
        raise NotImplementedError(
            "variable_length_memory_efficient_attention: mask= is not "
            "supported (the varlen kernels take segment and causal masks "
            "only)")
    if pre_cache_length:
        raise NotImplementedError(
            "variable_length_memory_efficient_attention: pre_cache_length "
            "is not supported")
    b, h, sq, d = query.shape
    lens_q = _lengths(seq_lens, b, "seq_lens")
    lens_k = _lengths(kv_seq_lens, b, "kv_seq_lens")
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)

    def pack(t, lens):
        return torch.cat([t[i, :, :lens[i]].transpose(0, 1)
                          for i in range(b)], dim=0)        # [total, h, d]

    out, _ = F.flash_attn_unpadded(pack(query, lens_q), pack(key, lens_k),
                                   pack(value, lens_k), cu_q, cu_k,
                                   scale=scale, causal=causal)
    rows = []
    for i in range(b):
        seg = out[cu_q[i]:cu_q[i + 1]].transpose(0, 1)      # [h, len, d]
        rows.append(torch.nn.functional.pad(seg, (0, 0, 0, sq - lens_q[i])))
    return torch.stack(rows, dim=0)
