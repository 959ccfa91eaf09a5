"""Flash attention: the Hopper kernels' wrappers, their plain PyTorch
versions, the autograd Function and the public ``[b, s, h, d]`` entry.

Counterpart of ``paddlepaddle_tpu/ops/kernels/flash_attention.py``. The
kernels are ``csrc/flash_attention.cu`` (design, bound and known limits in
its header):

* :func:`flash_fwd`     replaces ``_fwd_kernel`` (:97, launched at :229);
* :func:`flash_bwd_dq`  replaces ``_dq_kernel``  (:139, launched at :268);
* :func:`flash_bwd_dkv` replaces ``_dkv_kernel`` (:172, launched at :277).

Each wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and counts the launch in ``<wrapper>.launches``
(never a plain-version call). The kernels take the ``[b, s, h, d]`` tensors
in place through their strides; the ``[b*h, s, d]`` view of the TPU
kernels' contract is never materialised. ``lse`` and ``delta`` are f32
``[b*h, s_q]``.

:class:`_FlashCore` takes the place of the ``jax.custom_vjp`` ``_flash_core``
(:306-352): its forward saves the compact residual ``(q, k, v, out, lse)``
and its backward forms ``delta = rowsum(dO * O)`` in f32 with one torch op
(the JAX package does the same outside Pallas, :257), then launches the dQ
and dK/dV kernels. :func:`flash_attention_bshd` (:355) routes: CPU tensors
take the plain version, whose backward is autograd's; CUDA tensors take
:class:`_FlashCore`; ``mask=`` and ``dropout > 0`` compute in plain PyTorch,
as the JAX package computes them outside Pallas (:362-368).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)        # the kernels are templated on d = 64 and 128
MAX_BH = 65535               # b*h rides the grid's y dimension
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_supported(head_dim: int, dtype: torch.dtype,
                              causal: bool, s_q: int,
                              s_k: int) -> Tuple[bool, str]:
    """(ok, reason): whether the Hopper kernels take this configuration.
    Re-derived for the card from the JAX gate (``_use_pallas`` :48 and
    ``_blocks`` :57): any length is taken (the ragged last tile is masked
    in the kernel, where the TPU needed multiples of 8); d 256, which the
    TPU gate admits, is not built yet; a causal ``s_q > s_k`` leaves rows
    with no visible key and is declined, as the TPU kernel declines it
    (:214)."""
    if dtype not in _KERNEL_DTYPES:
        return False, f"dtype {dtype} (kernels take float32, bfloat16)"
    if head_dim not in HEAD_DIMS:
        return False, f"head_dim {head_dim} not in {HEAD_DIMS}"
    if s_q < 1 or s_k < 1:
        return False, f"empty sequence (s_q {s_q}, s_k {s_k})"
    if causal and s_q > s_k:
        return False, (f"causal with s_q {s_q} > s_k {s_k}: rows with no "
                       "visible key")
    return True, "ok"


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the card compares the kernels with)
# ---------------------------------------------------------------------------


def _attention_plain(q, k, v, causal: bool, mask, scale: float):
    """The semantics of ``_xla_attention`` (:72) on ``[b, s, h, d]``: f32
    logits scaled after the product, the bottom-right causal mask
    ``j <= i + (s_k - s_q)`` and a boolean ``mask`` filled with -1e30 (a
    float mask is added), one f32 softmax, probabilities cast to v's dtype
    before P.V. Returns ``(out [b, s_q, h, d], lse [b*h, s_q])``."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    qt = q.transpose(1, 2).float()
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.float()
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(vt.dtype), vt)
    return out.transpose(1, 2), lse.reshape(b * h, sq)


def flash_attention_plain(q, k, v, causal: bool,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel: ``(out, lse)``."""
    return _attention_plain(q, k, v, causal, None, scale)


def flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The plain version of the two backward kernels: the same recompute
    arithmetic over the whole ``[s_q, s_k]`` matrix in f32 (``p = exp(s -
    lse)``, ``ds = p (dp - delta) scale``). Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qt, kt, vt, dot = (x.transpose(1, 2).float() for x in (q, k, v, dout))
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.matmul(dot, vt.transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    dq = torch.matmul(ds, kt).transpose(1, 2).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qt).transpose(1, 2).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), dot).transpose(1, 2).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(causal: bool, q, k, v, *rest) -> None:
    """Raise on what the kernels do not take. ``rest`` holds further
    ``[b, s_q, h, d]`` tensors of q's dtype (dO)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [b, s, h, d]")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, h, d) or tuple(v.shape) != (b, sk, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
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
            raise ValueError("flash attention kernels take contiguous "
                             "[b, s, h, d] tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash attention tensors must be 16-byte "
                             "aligned")
    if b * h > MAX_BH:
        raise ValueError(f"b*h = {b * h} > {MAX_BH}")
    ok, reason = flash_attention_supported(d, q.dtype, causal, sq, sk)
    if not ok:
        raise ValueError(f"flash attention kernels do not take this "
                         f"configuration: {reason}")


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, sq, h, _ = q.shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (b * h, sq)
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 [b*h, s_q] = "
                         f"[{b * h}, {sq}] on {q.device}")


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        # pointers and the stream as c_void_p: a bare int would be cut to 32
        # bits by ctypes
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [ci, ci, ci, ci, ci, cf, ci, ci, vp]
        lib.flash_fwd_launch.argtypes = [vp] * 5 + shape
        lib.flash_bwd_dq_launch.argtypes = [vp] * 7 + shape
        lib.flash_bwd_dkv_launch.argtypes = [vp] * 8 + shape
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch,
                   lib.flash_bwd_dkv_launch):
            fn.restype = ci
        lib.flash_error_string.argtypes = [ci]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launch(fn_name: str, ptrs, q: torch.Tensor, sk: int, causal: bool,
            scale: float) -> None:
    b, sq, h, d = q.shape
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, fn_name)(*ptrs, b, h, sq, sk, d, float(scale),
                                int(bool(causal)), _KERNEL_DTYPES[q.dtype],
                                stream)
    if err:
        msg = lib.flash_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({msg})")


def _require_cuda(q: torch.Tensor, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def flash_fwd(q, k, v, causal: bool,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(out [b, s_q, h, d], lse [b*h, s_q] f32)``. CPU tensors
    take :func:`flash_attention_plain`; CUDA tensors launch the kernel on
    the current stream (no sync) or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    _require_cuda(q, "flash_fwd")
    _check_cuda_args(causal, q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), lse.data_ptr()),
            q, k.shape[1], causal, scale)
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool,
                 scale: float) -> torch.Tensor:
    """dQ ``[b, s_q, h, d]`` by recompute. CPU tensors take
    :func:`flash_bwd_plain`; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)[0]
    _require_cuda(q, "flash_bwd_dq")
    _check_cuda_args(causal, q, k, v, dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq_launch",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k.shape[1], causal, scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` ``[b, s_k, h, d]`` by recompute. CPU tensors take
    :func:`flash_bwd_plain`; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)[1:]
    _require_cuda(q, "flash_bwd_dkv")
    _check_cuda_args(causal, q, k, v, dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv_launch",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k.shape[1], causal, scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, as ``[b*h, s_q]``."""
    b, sq, h, _ = out.shape
    delta = (dout.float() * out.float()).sum(-1)               # [b, s_q, h]
    return delta.transpose(1, 2).reshape(b * h, sq).contiguous()


class _FlashCore(torch.autograd.Function):
    """Attention whose forward and backward are the wrappers above."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bshd(query, key, value, causal: bool = False,
                         mask: Optional[torch.Tensor] = None,
                         dropout: float = 0.0) -> torch.Tensor:
    """Attention over ``[b, s, h, d]`` with scale ``1/sqrt(d)``. CPU
    tensors take the plain version (autograd differentiates it); CUDA
    tensors run the three kernels through :class:`_FlashCore`. A ``mask``
    or ``dropout > 0`` computes in plain PyTorch on either device."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    if mask is None and dropout == 0.0:
        if query.device.type == "cpu":
            return flash_attention_plain(query, key, value, causal, scale)[0]
        return _FlashCore.apply(query, key, value, causal, scale)
    out = _attention_plain(query, key, value, causal, mask, scale)[0]
    if dropout > 0.0:
        keep = torch.rand(out.shape, device=out.device) >= dropout
        out = torch.where(keep, out / (1.0 - dropout),
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device)).to(out.dtype)
    return out
