"""Gather-GEMM expert FFN: the Hopper kernels' wrappers, their plain
PyTorch versions and the support check.

Counterpart of ``paddlepaddle_tpu/ops/kernels/gather_gemm.py``.
:func:`gather_gemm_ffn` replaces ``_gather_ffn_kernel`` (:80, launched at
:147) with two launches a call: :func:`gather_gateup` (the gathered gate/up
product and the SwiGLU, into ``hmid [E, C, h]``) and :func:`expert_down`
(the grouped down product). bf16 runs on ``csrc/gather_gemm_sm90.cu``
(TMA + ``wgmma``; design, bound and the bf16 rounding of ``hmid`` in its
header), f32 on ``csrc/gather_gemm.cu`` (FMA tiles).

Each wrapper runs its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises, and counts the launch in its
``launches`` (never a plain-version call): ``gather_gemm_ffn.launches``
counts calls, each of which adds one to ``gather_gateup.launches`` and
one to ``expert_down.launches``. Unlike the JAX function it takes the gate
and up banks as two tensors: the JAX caller concatenates them on every call
(``parallel/moe.py:397``), which on the card would copy the whole
``[E, d, 2h]`` bank per layer per forward.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as _tF

from ...observability.perf import costs as _costs
from . import _build

TILE = 128                  # d and h are walked in 128-column tiles
MAX_SMEM = 232448           # dynamic shared memory a block may use on sm_90
MAX_EXPERTS = 65535         # the f32 kernels put the expert on grid z
PHASES = ("gateup", "down")
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "sm90"}
# shared-memory plans, mirrored from the sources (chip_smoke.py checks that
# the two sides agree): bf16, a 192 KB stage ring in either phase, the
# gathered row indices of the first, room for 8 stages of mbarriers and the
# slack that aligns the ring to 1024 bytes; f32, two stages of a [32][36] A
# tile and two [32][132] weight tiles, and 32 row indices
_SM90_SMEM = {"gateup": 192 * 1024 + 128 * 4 + 8 * 2 * 8 + 1024,
              "down": 192 * 1024 + 8 * 2 * 8 + 1024}
_F32_STAGE = (32 * 36 + 2 * 32 * 132) * 4


def smem_bytes(phase: str, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA of ``phase`` ("gateup" or "down"):
    the same at every d and h."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r}, not one of {PHASES}")
    if dtype == torch.bfloat16:
        return _SM90_SMEM[phase]
    if dtype == torch.float32:
        return 2 * _F32_STAGE + 32 * 4
    raise ValueError(f"no gather-GEMM kernel for {dtype}")


def gather_gemm_supported(d_model: int, d_hidden: int,
                          dtype: torch.dtype) -> Tuple[bool, str]:
    """(ok, reason): whether the Hopper kernels take this configuration.
    The JAX gate's rule (:55-68, 128-lane-aligned widths): d and h
    multiples of 128, in f32 or bf16. Neither kernel's shared memory
    depends on d or h. Reads no flag."""
    if dtype not in _KERNEL_DTYPES:
        return False, f"dtype {dtype} (the kernel takes float32, bfloat16)"
    if d_model < TILE or d_hidden < TILE or d_model % TILE or d_hidden % TILE:
        return False, (f"d_model {d_model} / d_hidden {d_hidden} not "
                       f"multiples of {TILE}")
    return True, "ok"


def _valid_rows(slot_entry: torch.Tensor, n_tokens: int) -> torch.Tensor:
    slot = slot_entry.reshape(-1).long()
    return slot, (slot >= 0) & (slot < n_tokens)


def _gateup_f32(x, slot_entry, wg, wu, capacity: int) -> torch.Tensor:
    """f32 ``silu(xr @ wg) * (xr @ wu)``, ``[E, C, h]``, zero rows for the
    sentinel slots."""
    T, d = x.shape
    slot, valid = _valid_rows(slot_entry, T)
    xg = x[torch.where(valid, slot, 0)].float() * valid[:, None]
    xg = xg.reshape(wg.shape[0], int(capacity), d)
    return _tF.silu(torch.bmm(xg, wg.float())) * torch.bmm(xg, wu.float())


def gather_gateup_plain(x: torch.Tensor, slot_entry: torch.Tensor,
                        wg: torch.Tensor, wu: torch.Tensor, *,
                        capacity: int) -> torch.Tensor:
    """The plain version of :func:`gather_gateup`: gather the token rows,
    zero the sentinel rows, f32 ``bmm``, ``silu * mul``, the result
    ``hmid [E, capacity, h]`` in x's dtype."""
    return _gateup_f32(x, slot_entry, wg, wu, capacity).to(x.dtype)


def expert_down_plain(hmid: torch.Tensor, slot_entry: torch.Tensor,
                      wd: torch.Tensor, *, n_tokens: int) -> torch.Tensor:
    """The plain version of :func:`expert_down`: ``hmid [E, C, h] @ wd
    [E, h, d]`` in f32 with the rows of sentinel slots (token row outside
    ``[0, n_tokens)``) zero, ``[E * C, d]`` in hmid's dtype."""
    E, C, _ = hmid.shape
    _, valid = _valid_rows(slot_entry, n_tokens)
    hm = hmid.float() * valid.reshape(E, C, 1)
    return torch.bmm(hm, wd.float()).reshape(E * C, -1).to(hmid.dtype)


def gather_gemm_ffn_plain(x: torch.Tensor, slot_entry: torch.Tensor,
                          wg: torch.Tensor, wu: torch.Tensor,
                          wd: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """The plain version of the call: :func:`gather_gateup_plain` then
    :func:`expert_down_plain` with ``hmid`` kept in f32, cast to x's dtype.
    Returns ``[E * capacity, d]``. In f32 it is the composition of the two
    halves, bit for bit."""
    hmid = _gateup_f32(x, slot_entry, wg, wu, capacity)
    return expert_down_plain(hmid, slot_entry, wd,
                             n_tokens=x.shape[0]).to(x.dtype)


def bf16_error_bound(x, slot_entry, wg, wu, wd, *, capacity: int,
                     plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bound of |kernel - plain| in bf16, ``plain`` being
    :func:`gather_gemm_ffn_plain`'s output on the same inputs. The kernel
    rounds the hidden activation to bf16 before the second product
    (relative 2^-9 per element: ``2^-9 (|hmid| @ |wd|)``), both round the
    output to bf16 (one step, 2^-7 relative), and 1e-5 covers the f32
    summation order."""
    hmid = _gateup_f32(x, slot_entry, wg, wu, capacity)
    spread = torch.bmm(hmid.abs(), wd.float().abs()).reshape(plain.shape)
    return 2.0 ** -9 * spread + 2.0 ** -7 * plain.float().abs() + 1e-5


def _order_slack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(K) 2^-24 (|a| @ |b|): what two f32 summation orders of a
    K-term product (the tensor cores' accumulation among them) may differ
    by, for terms of both signs, elementwise over ``a @ b``."""
    return a.shape[-1] ** 0.5 * 2.0 ** -24 * torch.bmm(a.abs(), b.abs())


def gather_gateup_bf16_bound(x, slot_entry, wg, wu, *, capacity: int,
                             plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bound of |kernel - plain| for :func:`gather_gateup` in
    bf16, ``plain`` being :func:`gather_gateup_plain` on the same inputs:
    both round one f32 value to bf16 (one step, 2^-7 relative), and the f32
    gate and up products g, u of the two may differ by their summation
    order's slack, which reaches silu(g) u as ``1.1 |u| dg + |silu(g)|
    du`` (silu' <= 1.1)."""
    T, d = x.shape
    slot, valid = _valid_rows(slot_entry, T)
    xg = (x[torch.where(valid, slot, 0)].float() * valid[:, None]).reshape(
        wg.shape[0], int(capacity), d)
    g = torch.bmm(xg, wg.float())
    u = torch.bmm(xg, wu.float())
    drift = 1.1 * u.abs() * _order_slack(xg, wg.float()) \
        + _tF.silu(g).abs() * _order_slack(xg, wu.float())
    return 2.0 ** -7 * plain.float().abs() + drift + 1e-6


def expert_down_bf16_bound(hmid, wd, *, plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bound of |kernel - plain| for :func:`expert_down` in
    bf16, ``plain`` being :func:`expert_down_plain` on the same ``hmid``:
    one bf16 step (2^-7 relative) and the down product's summation-order
    slack."""
    slack = _order_slack(hmid.float(), wd.float()).reshape(plain.shape)
    return 2.0 ** -7 * plain.float().abs() + slack + 1e-6


def _library(dtype: torch.dtype) -> Tuple[ctypes.CDLL, str]:
    """The loaded library for x's dtype and the prefix of its C entries."""
    kind = _KERNEL_DTYPES[dtype]
    lib = _build.load("gather_gemm_sm90" if kind == "sm90" else "gather_gemm")
    if not getattr(lib, "_argtypes_set", False):
        # pointers and the stream as c_void_p: a bare int would be cut to 32
        # bits by ctypes
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # (x, slot, wg, wu, hmid) and (hmid, slot, wd, out), then T, E, C,
        # d, h and the stream
        for name, n_ptr in ((f"gather_gateup_{kind}_launch", 5),
                            (f"expert_down_{kind}_launch", 4)):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * n_ptr + [ci] * 5 + [vp]
            fn.restype = ci
        # getattr, not indexing: lib[name] makes a new function object
        # each time, without these argtypes
        getattr(lib, f"gather_gemm_{kind}_smem_bytes").argtypes = [ci]
        getattr(lib, f"gather_gemm_{kind}_smem_bytes").restype = ctypes.c_long
        getattr(lib, f"gather_gemm_{kind}_error_string").argtypes = [ci]
        getattr(lib, f"gather_gemm_{kind}_error_string").restype = \
            ctypes.c_char_p
        lib._argtypes_set = True
    return lib, kind


def kernel_smem_bytes(phase: str, dtype: torch.dtype) -> int:
    """What the built kernel says its CTA of ``phase`` takes (the card's
    side of :func:`smem_bytes`)."""
    lib, kind = _library(dtype)
    fn = getattr(lib, f"gather_gemm_{kind}_smem_bytes")
    return int(fn(PHASES.index(phase)))


def _check_slots(slot, E: int, C: int, T: int, device) -> None:
    if slot.dtype != torch.int32 or slot.numel() != E * C:
        raise ValueError(f"slot_entry must be int32 with E*C = {E * C} "
                         f"entries, got {slot.dtype} {slot.numel()}")
    if T < 1 or C < 1 or E < 1 or E > MAX_EXPERTS:
        raise ValueError(f"T {T}, C {C}, E {E} out of range")
    if slot.device != device:
        raise ValueError(f"slot_entry on {slot.device}, data on {device}")


def _check_tensors(**tensors) -> None:
    ref = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, not {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, not {ref.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gather-GEMM tensors must be contiguous and "
                             "16-byte aligned")


def _check_widths(d: int, h: int, dtype) -> None:
    ok, why = gather_gemm_supported(d, h, dtype)
    if not ok:
        raise ValueError(f"the gather-GEMM kernel does not take this "
                         f"configuration: {why}")


def _launch(fn_name: str, dtype, *args) -> None:
    lib, kind = _library(dtype)
    err = getattr(lib, fn_name.format(kind))(*args)
    if err:
        msg = getattr(lib, f"gather_gemm_{kind}_error_string")(err).decode()
        raise RuntimeError(f"{fn_name.format(kind)} failed: CUDA error {err} "
                           f"({msg})")


def _cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on others."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def gather_gateup(x: torch.Tensor, slot_entry: torch.Tensor,
                  wg: torch.Tensor, wu: torch.Tensor, *,
                  capacity: int) -> torch.Tensor:
    """Phase one of the call: ``hmid[e, c] = silu(xr @ wg[e]) * (xr @
    wu[e])`` with ``xr = x[slot_entry[e*C + c]]``, a zero row for a
    sentinel slot, f32 accumulation, ``[E, capacity, h]`` in x's dtype
    (bf16 rounds once, from f32). CPU tensors take
    :func:`gather_gateup_plain`; CUDA tensors launch the kernel on the
    current stream (no sync) or raise."""
    C = int(capacity)
    if not _cuda(x, "gather_gateup"):
        return gather_gateup_plain(x, slot_entry, wg, wu, capacity=C)
    if x.dim() != 2 or wg.dim() != 3:
        raise ValueError("x must be [T, d] and wg [E, d, h]")
    T, d = x.shape
    E, _, h = wg.shape
    if tuple(wg.shape) != (E, d, h) or tuple(wu.shape) != (E, d, h):
        raise ValueError(f"banks wg {tuple(wg.shape)}, wu {tuple(wu.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    _check_slots(slot_entry, E, C, T, x.device)
    _check_tensors(x=x, wg=wg, wu=wu)
    _check_widths(d, h, x.dtype)
    hmid = torch.empty(E, C, h, dtype=x.dtype, device=x.device)
    _launch("gather_gateup_{}_launch", x.dtype, x.data_ptr(),
            slot_entry.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            hmid.data_ptr(), T, E, C, d, h,
            torch.cuda.current_stream(x.device).cuda_stream)
    gather_gateup.launches += 1
    _report("gather_gateup", slot_entry, T, E, C, d, h, x.element_size())
    return hmid


def expert_down(hmid: torch.Tensor, slot_entry: torch.Tensor,
                wd: torch.Tensor, *, n_tokens: int) -> torch.Tensor:
    """Phase two: ``out[e*C + c] = hmid[e, c] @ wd[e]``, a zero row where
    the slot holds a sentinel (a token row outside ``[0, n_tokens)``), f32
    accumulation, ``[E * C, d]`` in hmid's dtype. CPU tensors take
    :func:`expert_down_plain`; CUDA tensors launch the kernel on the current
    stream (no sync) or raise."""
    T = int(n_tokens)
    if not _cuda(hmid, "expert_down"):
        return expert_down_plain(hmid, slot_entry, wd, n_tokens=T)
    if hmid.dim() != 3 or wd.dim() != 3:
        raise ValueError("hmid must be [E, C, h] and wd [E, h, d]")
    E, C, h = hmid.shape
    d = wd.shape[2]
    if tuple(wd.shape) != (E, h, d):
        raise ValueError(f"wd {tuple(wd.shape)} does not fit hmid "
                         f"{tuple(hmid.shape)}")
    _check_slots(slot_entry, E, C, T, hmid.device)
    _check_tensors(hmid=hmid, wd=wd)
    _check_widths(d, h, hmid.dtype)
    out = torch.empty(E * C, d, dtype=hmid.dtype, device=hmid.device)
    _launch("expert_down_{}_launch", hmid.dtype, hmid.data_ptr(),
            slot_entry.data_ptr(), wd.data_ptr(), out.data_ptr(), T, E, C, d,
            h, torch.cuda.current_stream(hmid.device).cuda_stream)
    expert_down.launches += 1
    _report("expert_down", slot_entry, T, E, C, d, h, hmid.element_size())
    return out


def gather_gemm_work(slot_entry: torch.Tensor, n_tokens: int, E: int,
                     C: int, d: int, h: int, item: int) -> dict:
    """``{phase: (bytes, flops)}`` this call's data needs, for
    ``"gather_gateup"``, ``"expert_down"`` and the whole ``"call"``: every
    weight read once, each token row a filled slot reads read once, the slot
    indices read once, each output written once (``hmid`` written by the
    first phase and read by the second); the products of the filled slots
    only. Reads ``slot_entry`` on the host."""
    slot = slot_entry.reshape(-1)
    valid = slot < n_tokens
    n_valid = int(valid.sum())
    n_rows = int(torch.unique(slot[valid]).numel())
    w_bytes = E * d * h * item
    hmid_bytes = E * C * h * item
    return {
        "gather_gateup": (2 * w_bytes + n_rows * d * item + 4 * E * C
                          + hmid_bytes, 2 * n_valid * 2 * d * h),
        "expert_down": (w_bytes + hmid_bytes + 4 * E * C + E * C * d * item,
                        2 * n_valid * d * h),
        "call": (3 * w_bytes + n_rows * d * item + 4 * E * C
                 + E * C * d * item, 2 * n_valid * 3 * d * h)}


def _report(phase: str, slot_entry, n_tokens, E, C, d, h, item) -> None:
    """This launch's work to an open perf-plane counting window."""
    if _costs.counting_open():
        _costs.kernel_work(phase, *gather_gemm_work(
            slot_entry, n_tokens, E, C, d, h, item)[phase])


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
    CUDA tensors launch :func:`gather_gateup` then :func:`expert_down` on
    the current stream (no sync) or raise. In bf16 ``hmid`` is rounded to
    bf16 between the two (:func:`bf16_error_bound`)."""
    C = int(capacity)
    if not _cuda(x, "gather_gemm_ffn"):
        return gather_gemm_ffn_plain(x, slot_entry, wg, wu, wd, capacity=C)
    if wd.dim() != 3 or tuple(wd.shape) != (wg.shape[0], wg.shape[2],
                                              x.shape[-1]):
        raise ValueError(f"banks wg {tuple(wg.shape)}, wd {tuple(wd.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    _check_tensors(x=x, wd=wd)
    hmid = gather_gateup(x, slot_entry, wg, wu, capacity=C)
    out = expert_down(hmid, slot_entry, wd, n_tokens=x.shape[0])
    gather_gemm_ffn.launches += 1
    return out


gather_gemm_ffn.launches = 0
gather_gateup.launches = 0
expert_down.launches = 0
