"""Packed varlen flash attention: the Hopper kernels' wrappers, their plain
PyTorch versions, the autograd Function and the public entry
``flash_attn_unpadded``.

Counterpart of ``paddlepaddle_tpu/ops/kernels/flash_varlen.py``. Each
wrapper picks its kernel by dtype (``_ENTRIES``; design, bound and limits
in the sources' headers):

* :func:`varlen_fwd` replaces ``_vfwd_kernel`` (:123, launched at :233):
  bf16 runs ``varlen_fwd_sm90_kernel`` (``csrc/flash_varlen_sm90.cu``, TMA
  + ``wgmma``, warp-specialised), f32 ``varlen_fwd_kernel``
  (``csrc/flash_varlen.cu``, full-f32 FMA: ``wgmma`` would round f32 to
  TF32);
* :func:`varlen_bwd_dq` replaces ``_vdq_kernel`` (:156, launched at :273):
  bf16 runs ``varlen_bwd_dq_sm90_kernel`` (``csrc/flash_varlen_sm90.cu``),
  f32 ``varlen_bwd_dq_kernel`` (``csrc/flash_varlen.cu``);
* :func:`varlen_bwd_dkv` replaces ``_vdkv_kernel`` (:184, launched at
  :284): bf16 runs ``varlen_bwd_dkv_sm90_kernel``
  (``csrc/flash_varlen_sm90.cu``), f32 ``varlen_bwd_dkv_kernel``
  (``csrc/flash_varlen.cu``).

q, k and v are packed ``[t, h, d]``; ``cu_q`` / ``cu_k`` are int32 prefix
sums ``[B + 1]`` delimiting the B sequences. Query row i of segment s sees
key j when j lies in segment s of k and, causal, ``j - cu_k[s] <= i -
cu_q[s] + len_k[s] - len_q[s]`` (bottom-right per segment). Rows at or past
``cu_q[-1]`` and rows that see no key give an output of exactly 0, an
``lse`` of -1e30 and gradients of exactly 0. ``lse`` and ``delta`` are f32
``[h, t_q]``.

Each wrapper runs its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises, and counts the launch in
``<wrapper>.launches`` (never a plain-version call). :class:`_VarlenCore`
takes the place of the ``jax.custom_vjp`` ``_varlen_core`` (:305-324).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from ...core import random
from ...observability.perf import costs as _costs
from .flash_attention import (HEAD_DIMS, NEG_INF,
                              _require_cuda, reference_kernel_head_dim)

# the varlen kernels take f32 and bf16 (fp16: ROADMAP queue B, rows 5-7)
_VARLEN_DTYPES = (torch.float32, torch.bfloat16)

MAX_HEADS = 65535            # flash_varlen.cu's grids put heads on y
# the plain versions evaluate at most this many f32 logits at once: heads
# are independent, so they go in chunks (a full-width [h, t, t] would not
# fit: 8.7 GB at t 8256, h 32)
PLAIN_CHUNK_ELEMS = 1 << 28


def varlen_supported(head_dim: int, dtype: torch.dtype) -> Tuple[bool, str]:
    """(ok, reason): whether the Hopper kernels take this configuration:
    bf16 (the TMA/``wgmma`` kernels) or f32 (the FMA kernels), d 64 or
    128. Any ``t_q``, ``t_k`` >= 1 and any segment layout is taken,
    including causal rows that see no key (the TPU kernels needed multiples
    of 8, ``_blocks``); d 256, which the TPU gate admits, is not built
    yet."""
    if dtype not in _VARLEN_DTYPES:
        return False, f"dtype {dtype} (kernels take float32, bfloat16)"
    if head_dim not in HEAD_DIMS:
        return False, f"head_dim {head_dim} not in {HEAD_DIMS}"
    return True, "ok"


# ---------------------------------------------------------------------------
# segment bookkeeping and the plain versions
# ---------------------------------------------------------------------------


def _seg_info(cu: torch.Tensor, total: int):
    """Per-token (segment id, local position, validity) from prefix sums
    (``_seg_info`` :49). Tokens at or past ``cu[-1]`` get segment -1."""
    idx = torch.arange(total, dtype=torch.int64, device=cu.device)
    cu = cu.to(torch.int64)
    seg = torch.searchsorted(cu[1:], idx, right=True)
    valid = idx < cu[-1]
    seg = torch.where(valid, seg, torch.full_like(seg, -1))
    pos = idx - cu[seg.clamp(0, max(cu.shape[0] - 2, 0))]
    return seg, pos, valid


def varlen_mask(cu_q: torch.Tensor, cu_k: torch.Tensor, tq: int, tk: int,
                causal: bool) -> torch.Tensor:
    """The visible (query, key) pairs, bool ``[t_q, t_k]``: same segment,
    both valid, and (causal) ``pos_q + len_k - len_q >= pos_k`` of the
    row's segment."""
    seg_q, pos_q, valid_q = _seg_info(cu_q, tq)
    seg_k, pos_k, valid_k = _seg_info(cu_k, tk)
    mask = ((seg_q[:, None] == seg_k[None, :]) & valid_q[:, None]
            & valid_k[None, :])
    if causal and cu_q.shape[0] > 1:
        lens = torch.diff(cu_k.to(torch.int64)) - torch.diff(
            cu_q.to(torch.int64))
        off = lens[seg_q.clamp(0, lens.shape[0] - 1)]
        mask &= (pos_q + off)[:, None] >= pos_k[None, :]
    return mask


def _head_chunks(h: int, tq: int, tk: int):
    step = max(1, PLAIN_CHUNK_ELEMS // max(tq * tk, 1))
    return [(a, min(a + step, h)) for a in range(0, h, step)]


def varlen_attention_plain(q, k, v, cu_q, cu_k, causal: bool, scale: float,
                           dropout: float = 0.0,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The semantics of ``_varlen_xla`` (:62), the plain version of the
    forward kernel: f32 logits scaled after the product, -1e30 where the
    mask is false, one f32 softmax, rows without a visible key set to 0,
    then (``dropout > 0``) inverted dropout of the probabilities drawn from
    ``generator``, and the probabilities cast to v's dtype before P.V.
    Returns ``(out [t_q, h, d] in v's dtype, lse [h, t_q] f32)``, lse -1e30
    on rows without a key. Heads go in chunks of at most
    ``PLAIN_CHUNK_ELEMS`` logits; autograd differentiates it."""
    tq, h, _ = q.shape
    tk = k.shape[0]
    mask = varlen_mask(cu_q, cu_k, tq, tk, causal)
    row_ok = mask.any(-1)
    outs, lses = [], []
    for a, b in _head_chunks(h, tq, tk):
        qt = q[:, a:b].transpose(0, 1).float()                 # [hc, tq, d]
        kt = k[:, a:b].transpose(0, 1).float()
        vt = v[:, a:b].transpose(0, 1)
        logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
        logits = logits.masked_fill(~mask, NEG_INF)
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        zero = torch.zeros((), device=probs.device)
        probs = torch.where(row_ok[:, None], probs, zero)
        lses.append(torch.where(row_ok, lse, torch.full_like(lse, NEG_INF)))
        if dropout > 0.0:
            keep = torch.rand(probs.shape, generator=generator,
                              device=probs.device) >= dropout
            probs = torch.where(keep, probs / (1.0 - dropout), zero)
        outs.append(torch.matmul(probs.to(vt.dtype), vt))
    return torch.cat(outs, 0).transpose(0, 1), torch.cat(lses, 0)


def varlen_bwd_plain(q, k, v, dout, lse, delta, cu_q, cu_k, causal: bool,
                     scale: float):
    """The plain version of the two backward kernels: the same recompute
    arithmetic in f32 over the visible pairs (``p = exp(s - lse) * mask``,
    ``ds = p (dp - delta) scale``), heads in chunks. Returns ``(dq, dk,
    dv)`` in the inputs' dtypes."""
    tq, h, _ = q.shape
    tk = k.shape[0]
    mask = varlen_mask(cu_q, cu_k, tq, tk, causal)
    dqs, dks, dvs = [], [], []
    for a, b in _head_chunks(h, tq, tk):
        qt, kt, vt, dot = (x[:, a:b].transpose(0, 1).float()
                           for x in (q, k, v, dout))
        s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - lse[a:b, :, None]) * mask
        dp = torch.matmul(dot, vt.transpose(-1, -2))
        ds = p * (dp - delta[a:b, :, None]) * scale
        dqs.append(torch.matmul(ds, kt))
        dks.append(torch.matmul(ds.transpose(-1, -2), qt))
        dvs.append(torch.matmul(p.transpose(-1, -2), dot))
    return (torch.cat(dqs, 0).transpose(0, 1).to(q.dtype),
            torch.cat(dks, 0).transpose(0, 1).to(k.dtype),
            torch.cat(dvs, 0).transpose(0, 1).to(v.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(q, k, v, cu_q, cu_k, *rest) -> None:
    """Raise on what the kernels do not take. ``rest`` holds further
    ``[t_q, h, d]`` tensors of q's dtype (dO)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be packed [t, h, d]")
    tq, h, d = q.shape
    tk = k.shape[0]
    if tuple(k.shape) != (tk, h, d) or tuple(v.shape) != (tk, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)} (equal heads and head_dim)")
    if tq < 1 or tk < 1:
        raise ValueError(f"empty buffer (t_q {tq}, t_k {tk})")
    for name, t in (("k", k), ("v", v)) + tuple(
            (f"arg{i}", t) for i, t in enumerate(rest)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for i, t in enumerate(rest):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"arg{i} {tuple(t.shape)} must match q "
                             f"{tuple(q.shape)}")
    for t in (q, k, v) + rest:
        if not t.is_contiguous():
            raise ValueError("varlen kernels take contiguous [t, h, d] "
                             "tensors")
        if t.data_ptr() % 16:
            raise ValueError("varlen tensors must be 16-byte aligned")
    for name, cu in (("cu_seqlens_q", cu_q), ("cu_seqlens_k", cu_k)):
        if (cu.dtype != torch.int32 or cu.dim() != 1 or cu.shape[0] < 1
                or cu.device != q.device or not cu.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {q.device}")
    if cu_q.shape[0] != cu_k.shape[0]:
        raise ValueError(f"len(cu_seqlens_q) {cu_q.shape[0]} != "
                         f"len(cu_seqlens_k) {cu_k.shape[0]}")
    if h > MAX_HEADS:
        raise ValueError(f"heads {h} > {MAX_HEADS}")
    ok, reason = varlen_supported(d, q.dtype)
    if not ok:
        raise ValueError(f"varlen kernels do not take this configuration: "
                         f"{reason}")


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    tq, h, _ = q.shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (h, tq)
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 [h, t_q] = "
                         f"[{h}, {tq}] on {q.device}")


# the C entry of each kernel, by dtype: (library, entry, pointer count).
# bf16 runs the TMA/wgmma kernels of flash_varlen_sm90.cu; f32 runs the FMA
# kernels of flash_varlen.cu, whose entries take one more int (is_bf16)
_ENTRIES = {
    ("fwd", torch.bfloat16): ("flash_varlen_sm90", "varlen_fwd_sm90_launch",
                              5),
    ("dkv", torch.bfloat16): ("flash_varlen_sm90",
                              "varlen_bwd_dkv_sm90_launch", 8),
    ("dq", torch.bfloat16): ("flash_varlen_sm90",
                             "varlen_bwd_dq_sm90_launch", 7),
    ("fwd", torch.float32): ("flash_varlen", "varlen_fwd_launch", 5),
    ("dq", torch.float32): ("flash_varlen", "varlen_bwd_dq_launch", 7),
    ("dkv", torch.float32): ("flash_varlen", "varlen_bwd_dkv_launch", 8),
}
_ERROR_STRING = {"flash_varlen_sm90": "varlen_sm90_error_string",
                 "flash_varlen": "varlen_error_string"}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        # pointers and the stream as c_void_p: a bare int would be cut to 32
        # bits by ctypes
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # (cu_q, cu_k, nseg, h, t_q, t_k, d, scale, causal[, is_bf16], stream)
        shape = ([vp, vp] + [ci] * 5 + [cf, ci]
                 + [ci] * (name == "flash_varlen") + [vp])
        for lib_name, entry, n_ptrs in _ENTRIES.values():
            if lib_name == name:
                getattr(lib, entry).argtypes = [vp] * n_ptrs + shape
                getattr(lib, entry).restype = ci
        err = getattr(lib, _ERROR_STRING[name])
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launch(kind: str, ptrs, q: torch.Tensor, tk: int, cu_q, cu_k,
            causal: bool, scale: float) -> None:
    """Launch the ``kind`` kernel ("fwd", "dq", "dkv") for q's dtype on the
    current stream; raise on a refused launch."""
    name, entry, _ = _ENTRIES[(kind, q.dtype)]
    tq, h, d = q.shape
    lib = _library(name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flags = (int(bool(causal)),) + (
        (int(q.dtype == torch.bfloat16),) if name == "flash_varlen" else ())
    err = getattr(lib, entry)(*ptrs, cu_q.data_ptr(), cu_k.data_ptr(),
                              cu_q.shape[0] - 1, h, tq, tk, d, float(scale),
                              *flags, stream)
    if err:
        msg = getattr(lib, _ERROR_STRING[name])(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def varlen_pairs(cu_q, cu_k, causal: bool) -> int:
    """Visible (query, key) pairs of one head: per segment, every pair, or
    under causal masking min(len_k, i + len_k - len_q + 1) keys for row i.
    ``cu_q`` / ``cu_k`` are arrays or tensors (read on the host)."""
    cu_q = np.asarray(cu_q.cpu() if isinstance(cu_q, torch.Tensor) else cu_q)
    cu_k = np.asarray(cu_k.cpu() if isinstance(cu_k, torch.Tensor) else cu_k)
    total = 0
    for lq, lk in zip(np.diff(cu_q).tolist(), np.diff(cu_k).tolist()):
        if causal:
            i = np.arange(lq)
            total += int(np.clip(i + lk - lq + 1, 0, lk).sum())
        else:
            total += lq * lk
    return total


def varlen_work(q, k, cu_q, cu_k, causal: bool) -> dict:
    """``{kernel: (bytes, flops)}`` of the three varlen kernels for this
    packing, as ``flash_work`` counts the dense ones: every input read
    once, every output written once; U = 2 h d times the visible pairs, and
    the forward does 2U, dQ 3U, dK/dV 4U."""
    t_q_rows, h, d = q.shape
    item = q.element_size()
    t_q, t_k = q.numel() * item, k.numel() * item
    rows = 4 * h * t_q_rows
    U = 2 * h * d * varlen_pairs(cu_q, cu_k, causal)
    return {"varlen_fwd": (t_q + 2 * t_k + t_q + rows, 2 * U),
            "varlen_bwd_dq": (2 * t_q + 2 * t_k + 2 * rows + t_q, 3 * U),
            "varlen_bwd_dkv": (2 * t_q + 2 * t_k + 2 * rows + 2 * t_k,
                               4 * U)}


def _report(name: str, q, k, cu_q, cu_k, causal: bool) -> None:
    """This launch's work to an open perf-plane counting window."""
    if _costs.counting_open():
        _costs.kernel_work(name, *varlen_work(q, k, cu_q, cu_k, causal)[name])


def varlen_fwd(q, k, v, cu_q, cu_k, causal: bool,
               scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(out [t_q, h, d], lse [h, t_q] f32)``. CPU tensors take
    :func:`varlen_attention_plain`; CUDA tensors launch a kernel on the
    current stream (no sync) or raise: bf16 runs ``varlen_fwd_sm90_kernel``
    (``csrc/flash_varlen_sm90.cu``), f32 ``varlen_fwd_kernel``
    (``csrc/flash_varlen.cu``). Either launch counts once."""
    if q.device.type == "cpu":
        return varlen_attention_plain(q, k, v, cu_q, cu_k, causal, scale)
    _require_cuda(q, "varlen_fwd")
    _check_cuda_args(q, k, v, cu_q, cu_k)
    tq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(h, tq, dtype=torch.float32, device=q.device)
    _launch("fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr()),
            q, k.shape[0], cu_q, cu_k, causal, scale)
    varlen_fwd.launches += 1
    _report("varlen_fwd", q, k, cu_q, cu_k, causal)
    return out, lse


def varlen_bwd_dq(q, k, v, dout, lse, delta, cu_q, cu_k, causal: bool,
                  scale: float) -> torch.Tensor:
    """dQ ``[t_q, h, d]`` by recompute. CPU tensors take
    :func:`varlen_bwd_plain`; CUDA tensors launch a kernel or raise: bf16
    runs ``varlen_bwd_dq_sm90_kernel`` (``csrc/flash_varlen_sm90.cu``), f32
    ``varlen_bwd_dq_kernel`` (``csrc/flash_varlen.cu``)."""
    if q.device.type == "cpu":
        return varlen_bwd_plain(q, k, v, dout, lse, delta, cu_q, cu_k,
                                causal, scale)[0]
    _require_cuda(q, "varlen_bwd_dq")
    _check_cuda_args(q, k, v, cu_q, cu_k, dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    dq = torch.empty_like(q)
    _launch("dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k.shape[0], cu_q, cu_k, causal, scale)
    varlen_bwd_dq.launches += 1
    _report("varlen_bwd_dq", q, k, cu_q, cu_k, causal)
    return dq


def varlen_bwd_dkv(q, k, v, dout, lse, delta, cu_q, cu_k, causal: bool,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` ``[t_k, h, d]`` by recompute. CPU tensors take
    :func:`varlen_bwd_plain`; CUDA tensors launch a kernel or raise: bf16
    runs ``varlen_bwd_dkv_sm90_kernel`` (``csrc/flash_varlen_sm90.cu``),
    f32 ``varlen_bwd_dkv_kernel`` (``csrc/flash_varlen.cu``)."""
    if q.device.type == "cpu":
        return varlen_bwd_plain(q, k, v, dout, lse, delta, cu_q, cu_k,
                                causal, scale)[1:]
    _require_cuda(q, "varlen_bwd_dkv")
    _check_cuda_args(q, k, v, cu_q, cu_k, dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k.shape[0], cu_q, cu_k, causal, scale)
    varlen_bwd_dkv.launches += 1
    _report("varlen_bwd_dkv", q, k, cu_q, cu_k, causal)
    return dk, dv


varlen_fwd.launches = 0
varlen_bwd_dq.launches = 0
varlen_bwd_dkv.launches = 0


def varlen_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, as ``[h, t_q]``."""
    return torch.einsum("thd,thd->ht", dout.float(), out.float()).contiguous()


class _VarlenCore(torch.autograd.Function):
    """Varlen attention whose forward and backward are the wrappers above:
    the forward saves ``(q, k, v, cu_q, cu_k, out, lse)``, the backward
    forms ``delta`` (the JAX package does so outside Pallas, :261) and runs
    the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = varlen_fwd(q, k, v, cu_q, cu_k, causal, scale)
        ctx.save_for_backward(q, k, v, cu_q, cu_k, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, cu_q, cu_k, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = varlen_delta(out, dout)
        dq = varlen_bwd_dq(q, k, v, dout, lse, delta, cu_q, cu_k, ctx.causal,
                           ctx.scale)
        dk, dv = varlen_bwd_dkv(q, k, v, dout, lse, delta, cu_q, cu_k,
                                ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def _prefix_sums(cu, total: int, name: str,
                 device: torch.device) -> torch.Tensor:
    """``cu_seqlens`` (int32 / int64 tensor, numpy array or list) as a
    contiguous int32 tensor on ``device``. Host-side values are validated:
    1-D, starting at 0, non-decreasing, last entry <= ``total``. A tensor
    already on the card is taken as it is (reading it back would sync); the
    kernels clamp every range to the buffers."""
    if isinstance(cu, torch.Tensor) and cu.device.type != "cpu":
        if cu.dtype not in (torch.int32, torch.int64) or cu.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32/int64 tensor")
        return cu.to(device=device, dtype=torch.int32).contiguous()
    arr = np.asarray(cu.numpy() if isinstance(cu, torch.Tensor) else cu)
    if arr.ndim != 1 or arr.shape[0] < 1 or not np.issubdtype(
            arr.dtype, np.integer):
        raise ValueError(f"{name} must be a 1-D integer sequence, got "
                         f"{arr.dtype} {arr.shape}")
    if arr[0] != 0 or np.any(np.diff(arr) < 0) or arr[-1] > total:
        raise ValueError(f"{name} must start at 0, not decrease and end at "
                         f"most at {total}: {arr.tolist()}")
    return torch.as_tensor(arr.astype(np.int32), device=device)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Packed varlen attention (reference flash_attention.py:762; JAX
    package :327).

    Args:
        query/key/value: ``[total_tokens, num_heads, head_dim]`` packed
            sequences (equal heads).
        cu_seqlens_q/k: ``[batch + 1]`` prefix sums delimiting the
            sequences (int32 or int64 tensor, numpy array or list), moved to
            q's device as int32.
        max_seqlen_q/k: accepted for API parity, unused.
        scale: softmax scale; default ``1/sqrt(head_dim)``.
        causal: per-segment bottom-right-aligned causal masking.
        dropout: attention-probability dropout (inverted scaling) when
            ``training``; a nonzero rate computes the plain version on
            either device, as the JAX package routes it outside Pallas. The
            mask draws from a generator seeded with ``fixed_seed_offset``
            when given, else from the named generator ``rng_name`` of the
            port's seeded streams (``core.random``; the default one for
            ``""``).
    Returns:
        ``(out, None)``: the softmax is never materialised
        (``return_softmax=True`` raises).

    CPU tensors take the plain version, which autograd differentiates; CUDA
    tensors run the three kernels through :class:`_VarlenCore`, except a
    head dim the JAX package's kernel gate refuses (not 64, 128, 256 or a
    multiple of 128), which takes the plain version there as well.
    """
    if return_softmax:
        raise ValueError(
            "return_softmax=True requires materializing the [tq, tk] matrix; "
            "the flash path does not support it")
    drop = float(dropout) if training else 0.0
    cu_q = _prefix_sums(cu_seqlens_q, query.shape[0], "cu_seqlens_q",
                        query.device)
    cu_k = _prefix_sums(cu_seqlens_k, key.shape[0], "cu_seqlens_k",
                        query.device)
    if cu_q.shape[0] != cu_k.shape[0]:
        raise ValueError(f"len(cu_seqlens_q) {cu_q.shape[0]} != "
                         f"len(cu_seqlens_k) {cu_k.shape[0]}")
    s = float(scale) if scale is not None else 1.0 / math.sqrt(
        query.shape[-1])
    if drop > 0.0:
        gen = random.dropout_generator(query.device, fixed_seed_offset,
                                       rng_name)
        return varlen_attention_plain(query, key, value, cu_q, cu_k, causal,
                                      s, dropout=drop, generator=gen)[0], None
    # the JAX package sends a head dim its kernel gate refuses (`_use_pallas`
    # at :368) to `_varlen_xla`: no TPU kernel runs it, so neither does the
    # port, on either device
    if query.device.type == "cpu" or not reference_kernel_head_dim(
            query.shape[-1]):
        return varlen_attention_plain(query, key, value, cu_q, cu_k, causal,
                                      s)[0], None
    return _VarlenCore.apply(query, key, value, cu_q, cu_k, causal, s), None
