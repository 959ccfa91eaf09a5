"""Gather-GEMM expert FFN: the Hopper kernel's wrapper, its plain PyTorch
version and the support check.

Counterpart of ``paddlepaddle_tpu/ops/kernels/gather_gemm.py``. The kernel is
``csrc/gather_gemm.cu`` (design, bound and the bf16 rounding of the hidden
activation in its header); :func:`gather_gemm_ffn` replaces
``_gather_ffn_kernel`` (:80, launched at :147).

The wrapper runs :func:`gather_gemm_ffn_plain` for CPU tensors only; for CUDA
tensors it launches the kernel or raises, and counts the launch in
``gather_gemm_ffn.launches`` (never a plain-version call). Unlike the JAX
function it takes the gate and up banks as two tensors: the JAX caller
concatenates them on every call (``parallel/moe.py:397``), which on the card
would copy the whole ``[E, d, 2h]`` bank per layer per forward.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as _tF

from . import _build

TILE = 128                  # d and h are walked in 128-column tiles
MAX_SMEM = 232448           # dynamic shared memory a block may use on sm_90
MAX_EXPERTS = 65535         # the expert rides the grid's y dimension
# per dtype: (rows a CTA owns, depth of a streamed tile, elements per 16 B)
_PLAN = {torch.bfloat16: (32, 64, 8), torch.float32: (16, 32, 4)}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(d_hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA (``Plan<T>::smem`` in the source):
    two stage buffers, the on-chip ``[BM, h]`` activation and BM indices."""
    bm, bk, vec = _PLAN[dtype]
    item = torch.tensor([], dtype=dtype).element_size()
    stage1 = (bm * (bk + vec) + 2 * bk * (TILE + vec)) * item
    stage2 = bk * (TILE + vec) * item
    return 2 * max(stage1, stage2) + bm * (d_hidden + vec) * item + bm * 4


def gather_gemm_supported(d_model: int, d_hidden: int,
                          dtype: torch.dtype) -> Tuple[bool, str]:
    """(ok, reason): whether the Hopper kernel takes this configuration.
    Re-derived for the card from the JAX gate (:55), which asks for
    128-lane-aligned widths: here d and h are walked in 128-column tiles,
    and the ``[BM, h]`` activation stays in shared memory beside the stage
    buffers, which bounds h (2304 in bf16, 2432 in f32). Reads no flag."""
    if dtype not in _PLAN:
        return False, f"dtype {dtype} (the kernel takes float32, bfloat16)"
    if d_model < TILE or d_hidden < TILE or d_model % TILE or d_hidden % TILE:
        return False, (f"d_model {d_model} / d_hidden {d_hidden} not "
                       f"multiples of {TILE}")
    need = smem_bytes(d_hidden, dtype)
    if need > MAX_SMEM:
        return False, (f"d_hidden {d_hidden}: {need} bytes of shared memory "
                       f"> {MAX_SMEM}")
    return True, "ok"


def gather_gemm_ffn_plain(x: torch.Tensor, slot_entry: torch.Tensor,
                          wg: torch.Tensor, wu: torch.Tensor,
                          wd: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """The plain version of the kernel: gather the token rows, zero the
    sentinel rows, f32 ``bmm``, ``silu * mul``, f32 ``bmm``, cast to x's
    dtype. Returns ``[E * capacity, d]``."""
    T, d = x.shape
    E = wg.shape[0]
    slot = slot_entry.reshape(-1).long()
    valid = (slot >= 0) & (slot < T)
    xg = x[torch.where(valid, slot, 0)].float() * valid[:, None]
    xg = xg.reshape(E, int(capacity), d)
    hmid = _tF.silu(torch.bmm(xg, wg.float())) * torch.bmm(xg, wu.float())
    return torch.bmm(hmid, wd.float()).reshape(-1, d).to(x.dtype)


def bf16_error_bound(x, slot_entry, wg, wu, wd, *, capacity: int,
                     plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bound of |kernel - plain| in bf16, ``plain`` being
    :func:`gather_gemm_ffn_plain`'s output on the same inputs. The kernel
    rounds the hidden activation to bf16 before the second product
    (relative 2^-9 per element: ``2^-9 (|hmid| @ |wd|)``), both round the
    output to bf16 (one step, 2^-7 relative), and 1e-5 covers the f32
    summation order."""
    T, d = x.shape
    slot = slot_entry.reshape(-1).long()
    valid = (slot >= 0) & (slot < T)
    xg = (x[torch.where(valid, slot, 0)].float() * valid[:, None]).reshape(
        wg.shape[0], int(capacity), d)
    hmid = _tF.silu(torch.bmm(xg, wg.float())) * torch.bmm(xg, wu.float())
    spread = torch.bmm(hmid.abs(), wd.float().abs()).reshape(plain.shape)
    return 2.0 ** -9 * spread + 2.0 ** -7 * plain.float().abs() + 1e-5


def _library() -> ctypes.CDLL:
    lib = _build.load("gather_gemm")
    if not getattr(lib, "_argtypes_set", False):
        # pointers and the stream as c_void_p: a bare int would be cut to 32
        # bits by ctypes
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gather_gemm_launch.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.gather_gemm_launch.restype = ci
        lib.gather_gemm_smem_bytes.argtypes = [ci, ci]
        lib.gather_gemm_smem_bytes.restype = ctypes.c_long
        lib.gather_gemm_error_string.argtypes = [ci]
        lib.gather_gemm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_cuda_args(x, slot, wg, wu, wd, C: int) -> None:
    if x.dim() != 2 or wg.dim() != 3:
        raise ValueError("x must be [T, d] and wg [E, d, h]")
    T, d = x.shape
    E, _, h = wg.shape
    if tuple(wg.shape) != (E, d, h) or tuple(wu.shape) != (E, d, h) \
            or tuple(wd.shape) != (E, h, d):
        raise ValueError(f"banks wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, "
                         f"wd {tuple(wd.shape)} do not fit x {tuple(x.shape)}")
    if slot.dtype != torch.int32 or slot.numel() != E * C:
        raise ValueError(f"slot_entry must be int32 with E*C = {E * C} "
                         f"entries, got {slot.dtype} {slot.numel()}")
    if T < 1 or C < 1 or E > MAX_EXPERTS:
        raise ValueError(f"T {T}, C {C}, E {E} out of range")
    for name, t in (("slot_entry", slot), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    for name, t in (("wg", wg), ("wu", wu), ("wd", wd)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for t in (x, slot, wg, wu, wd):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gather-GEMM tensors must be contiguous and "
                             "16-byte aligned")
    ok, why = gather_gemm_supported(d, h, x.dtype)
    if not ok:
        raise ValueError(f"the gather-GEMM kernel does not take this "
                         f"configuration: {why}")


def gather_gemm_ffn(x: torch.Tensor, slot_entry: torch.Tensor,
                    wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
                    capacity: int) -> torch.Tensor:
    """Fused dispatch + expert FFN, the JAX semantics of :111-153:
    ``out[e*C + c] = FFN_e(x[slot_entry[e*C + c]])``, a zero row where the
    slot holds the sentinel (>= T), f32 arithmetic, the result in x's
    dtype, ``[E * capacity, d]``.

    ``slot_entry`` keeps the JAX name, but what the caller passes is the
    TOKEN ROW each slot reads (``parallel/moe.py:448``), not an entry
    index. ``wg``/``wu`` are the ``[E, d, h]`` gate and up banks, ``wd`` the
    ``[E, h, d]`` down bank. CPU tensors take :func:`gather_gemm_ffn_plain`;
    CUDA tensors launch the kernel on the current stream (no sync) or
    raise."""
    C = int(capacity)
    if x.device.type == "cpu":
        return gather_gemm_ffn_plain(x, slot_entry, wg, wu, wd, capacity=C)
    if x.device.type != "cuda":
        raise ValueError(f"gather_gemm_ffn: unsupported device {x.device}")
    _check_cuda_args(x, slot_entry, wg, wu, wd, C)
    T, d = x.shape
    E, _, h = wg.shape
    out = torch.empty(E * C, d, dtype=x.dtype, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gather_gemm_launch(
        x.data_ptr(), slot_entry.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), out.data_ptr(), T, E, C, d, h,
        _KERNEL_DTYPES[x.dtype], stream)
    if err:
        msg = lib.gather_gemm_error_string(err).decode()
        raise RuntimeError(f"gather_gemm_launch failed: CUDA error {err} "
                           f"({msg})")
    gather_gemm_ffn.launches += 1
    return out


gather_gemm_ffn.launches = 0
