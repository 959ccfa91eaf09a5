"""Flash attention: the Hopper kernels' wrappers, their plain PyTorch
versions, the autograd Function and the public ``[b, s, h, d]`` entry.

Counterpart of ``paddlepaddle_tpu/ops/kernels/flash_attention.py``. The
kernels are ``csrc/flash_fwd_sm90.cu`` (the bf16 forward),
``csrc/flash_bwd_sm90.cu`` (the bf16 dQ and dK/dV kernels) and
``csrc/flash_attention.cu`` (the f32 forward, dQ and dK/dV kernels); design,
bound and known limits in their headers. Each wrapper picks its kernel by
dtype: bf16 and fp16 run a warp-specialised TMA/``wgmma`` kernel (one
template, two instantiations; fp16 is what AMP sends, since the TPU kernel's
gate tests only the head dim), f32 a full-f32 FMA kernel (``wgmma`` would
round f32 operands to TF32).

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
from ...amp import amp_cast
from ...observability.perf import costs as _costs
from ...core import random

NEG_INF = -1e30
HEAD_DIMS = (64, 128)        # the kernels are templated on d = 64 and 128
MAX_BH = 65535               # b*h rides the grid's y dimension
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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
        return False, (f"dtype {dtype} (kernels take float32, bfloat16, "
                       "float16)")
    if head_dim not in HEAD_DIMS:
        return False, f"head_dim {head_dim} not in {HEAD_DIMS}"
    if s_q < 1 or s_k < 1:
        return False, f"empty sequence (s_q {s_q}, s_k {s_k})"
    if causal and s_q > s_k:
        return False, (f"causal with s_q {s_q} > s_k {s_k}: rows with no "
                       "visible key")
    return True, "ok"


def reference_kernel_head_dim(head_dim: int) -> bool:
    """The head-dim test of the JAX package's ``_use_pallas`` (:40-46): its
    TPU kernel takes d 64, 128, 256 and any multiple of 128; every other d
    is computed by ``_xla_attention``."""
    return head_dim % 128 == 0 or head_dim in (64, 128, 256)


def routes_to_plain(head_dim: int, causal: bool, s_q: int, s_k: int) -> bool:
    """Whether the JAX package computes this configuration without a TPU
    kernel: a head dim its gate refuses, or causal ``s_q > s_k``, for which
    ``_pallas_forward`` returns None (:214-215) and ``_flash_fwd_impl``
    (:312-324) takes ``_xla_attention``. No TPU kernel ever runs these, so
    the port computes them in the plain version on either device. Decided
    from the shapes before any launch. d 256 and the other multiples of 128
    above 128 are not routed here: a TPU kernel takes them, so on the card
    they reach :func:`flash_attention_supported` and raise."""
    return not reference_kernel_head_dim(head_dim) or (causal and s_q > s_k)


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


# the C entry of each kernel, by dtype: (library, entry, pointer count). bf16
# and fp16 run the TMA/wgmma kernels (one instantiation each), f32 the
# full-f32 FMA kernels of flash_attention.cu, whose entries take one more int
# (is_bf16, always 0)
_ENTRIES = {
    ("fwd", torch.bfloat16): ("flash_fwd_sm90", "flash_fwd_sm90_launch", 5),
    ("dq", torch.bfloat16): ("flash_bwd_sm90", "flash_bwd_dq_sm90_launch", 7),
    ("dkv", torch.bfloat16): ("flash_bwd_sm90", "flash_bwd_dkv_sm90_launch",
                              8),
    ("fwd", torch.float16): ("flash_fwd_sm90", "flash_fwd_sm90_fp16_launch",
                             5),
    ("dq", torch.float16): ("flash_bwd_sm90", "flash_bwd_dq_sm90_fp16_launch",
                            7),
    ("dkv", torch.float16): ("flash_bwd_sm90",
                             "flash_bwd_dkv_sm90_fp16_launch", 8),
    ("fwd", torch.float32): ("flash_attention", "flash_fwd_launch", 5),
    ("dq", torch.float32): ("flash_attention", "flash_bwd_dq_launch", 7),
    ("dkv", torch.float32): ("flash_attention", "flash_bwd_dkv_launch", 8),
}
_ERROR_STRING = {"flash_fwd_sm90": "flash_fwd_sm90_error_string",
                 "flash_bwd_sm90": "flash_bwd_sm90_error_string",
                 "flash_attention": "flash_error_string"}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        # pointers and the stream as c_void_p: a bare int would be cut to 32
        # bits by ctypes
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # (b, h, s_q, s_k, d, scale, causal[, is_bf16], stream)
        shape = [ci] * 5 + [cf, ci] + [ci] * (name == "flash_attention") + [vp]
        for lib_name, entry, n_ptrs in _ENTRIES.values():
            if lib_name == name:
                getattr(lib, entry).argtypes = [vp] * n_ptrs + shape
                getattr(lib, entry).restype = ci
        err = getattr(lib, _ERROR_STRING[name])
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launch(kind: str, ptrs, q: torch.Tensor, sk: int, causal: bool,
            scale: float) -> None:
    """Launch the ``kind`` kernel ("fwd", "dq", "dkv") for q's dtype on the
    current stream; raise on a refused launch."""
    name, entry, _ = _ENTRIES[(kind, q.dtype)]
    b, sq, h, d = q.shape
    lib = _library(name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flags = (int(bool(causal)),) + (0,) * (name == "flash_attention")
    err = getattr(lib, entry)(*ptrs, b, h, sq, sk, d, float(scale), *flags,
                              stream)
    if err:
        msg = getattr(lib, _ERROR_STRING[name])(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def flash_work(q, k, causal: bool) -> dict:
    """``{kernel: (bytes, flops)}`` each kernel must move and do at these
    shapes: every input read once, every output written once; U = 2 b h d
    times the visible (query, key) pairs, and the forward does 2U, dQ 3U,
    dK/dV 4U (bottom-right causal)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    off = sk - sq
    pairs = (sum(max(0, min(i + off + 1, sk)) for i in range(sq))
             if causal else sq * sk)
    U = 2 * b * h * d * pairs
    item = q.element_size()
    t_q, t_k = q.numel() * item, k.numel() * item
    rows = 4 * b * h * sq                         # one f32 lse / delta row set
    return {"flash_fwd": (t_q + 2 * t_k + t_q + rows, 2 * U),
            "flash_bwd_dq": (2 * t_q + 2 * t_k + 2 * rows + t_q, 3 * U),
            "flash_bwd_dkv": (2 * t_q + 2 * t_k + 2 * rows + 2 * t_k, 4 * U)}


def _report(name: str, q, k, causal: bool) -> None:
    """This launch's work to an open perf-plane counting window."""
    if _costs.counting_open():
        _costs.kernel_work(name, *flash_work(q, k, causal)[name])


def _require_cuda(q: torch.Tensor, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def flash_fwd(q, k, v, causal: bool,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(out [b, s_q, h, d], lse [b*h, s_q] f32)``. CPU tensors
    take :func:`flash_attention_plain`; CUDA tensors launch a kernel on the
    current stream (no sync) or raise. The kernel is fixed by the dtype:
    bf16 and fp16 run ``flash_fwd_sm90_kernel`` (TMA loads, ``wgmma`` products,
    ``csrc/flash_fwd_sm90.cu``), f32 runs ``flash_fwd_kernel`` (full-f32
    FMA, ``csrc/flash_attention.cu``). Either launch counts once."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    _require_cuda(q, "flash_fwd")
    _check_cuda_args(causal, q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    _launch("fwd", ptrs, q, k.shape[1], causal, scale)
    flash_fwd.launches += 1
    _report("flash_fwd", q, k, causal)
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool,
                 scale: float) -> torch.Tensor:
    """dQ ``[b, s_q, h, d]`` by recompute. CPU tensors take
    :func:`flash_bwd_plain`; CUDA tensors launch a kernel or raise: bf16
    and fp16 run ``flash_bwd_dq_sm90_kernel`` (``csrc/flash_bwd_sm90.cu``), f32
    ``flash_bwd_dq_kernel`` (``csrc/flash_attention.cu``)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)[0]
    _require_cuda(q, "flash_bwd_dq")
    _check_cuda_args(causal, q, k, v, dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    dq = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    _launch("dq", ptrs, q, k.shape[1], causal, scale)
    flash_bwd_dq.launches += 1
    _report("flash_bwd_dq", q, k, causal)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` ``[b, s_k, h, d]`` by recompute. CPU tensors take
    :func:`flash_bwd_plain`; CUDA tensors launch a kernel or raise: bf16
    and fp16 run ``flash_bwd_dkv_sm90_kernel`` (``csrc/flash_bwd_sm90.cu``), f32
    ``flash_bwd_dkv_kernel`` (``csrc/flash_attention.cu``)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale)[1:]
    _require_cuda(q, "flash_bwd_dkv")
    _check_cuda_args(causal, q, k, v, dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    _launch("dkv", ptrs, q, k.shape[1], causal, scale)
    flash_bwd_dkv.launches += 1
    _report("flash_bwd_dkv", q, k, causal)
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
                         dropout: float = 0.0,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Attention over ``[b, s, h, d]`` with scale ``1/sqrt(d)``. CPU
    tensors take the plain version (autograd differentiates it); CUDA
    tensors run the three kernels through :class:`_FlashCore`, except the
    configurations :func:`routes_to_plain` names, which the JAX package also
    computes without its kernel and which take the plain version on the
    card. A ``mask`` or ``dropout > 0`` computes in plain PyTorch on either
    device; the dropout mask draws from ``generator``, by default the
    port's seeded stream for the device (``core.random.torch_generator``).
    Under AMP the inputs pass the cast hook as the reference's
    ``flash_attention`` op (white list: q, k, v and a float mask to the low
    dtype, so an fp16 AMP step sends fp16 to the kernels)."""
    query, key, value, mask = amp_cast("flash_attention", query, key, value,
                                       mask)
    scale = 1.0 / math.sqrt(query.shape[-1])
    if mask is None and dropout == 0.0:
        if query.device.type == "cpu" or routes_to_plain(
                query.shape[-1], causal, query.shape[1], key.shape[1]):
            return flash_attention_plain(query, key, value, causal, scale)[0]
        return _FlashCore.apply(query, key, value, causal, scale)
    out = _attention_plain(query, key, value, causal, mask, scale)[0]
    if dropout > 0.0:
        gen = generator if generator is not None else random.torch_generator(
            out.device)
        keep = torch.rand(out.shape, device=out.device, generator=gen) >= dropout
        out = torch.where(keep, out / (1.0 - dropout),
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device)).to(out.dtype)
    return out
