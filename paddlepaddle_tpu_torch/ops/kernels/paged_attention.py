"""Paged-attention decode: the CUDA kernel's wrapper, its plain PyTorch
version, and the Hopper support check.

Replaces the TPU kernel ``paged_attention`` / ``_paged_attn_kernel``
(``paddlepaddle_tpu/ops/kernels/paged_attention.py:175`` / ``:104``); the
kernel itself is ``csrc/paged_attention.cu`` (design, bound and known
limits in its header). Shape contract, as on the TPU:

* ``q``           ``[S, W, h, hd]`` — W new positions per slot (W=1 is the
  decode step);
* ``k_pool/v_pool`` ``[pages, page_size, kvh, hd]`` (page 0 is the engine's
  null page);
* ``page_table``  ``[S, P]`` int32 physical page per logical page;
* ``lens``        ``[S]`` int32 slot length BEFORE this step's writes;
  query w attends keys ``k_pos <= lens + w``.

:func:`paged_attention` runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. ``paged_attention.launches``
counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)        # one warp spans a head row in 32-lane strides
MAX_W = 4                    # kernel is templated on W = 1..4
MAX_ROWS = 32                # rep * W query rows per CTA (register budget)
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(page_size: int, head_dim: int, rows: int,
               itemsize: int) -> int:
    """Dynamic shared memory of one CTA (mirrors ``smem_bytes`` in the
    CUDA source): two staged K pages (rows padded by 16 bytes) and two V
    pages, plus the f32 query rows, score rows and per-row max/sum/rescale."""
    return (2 * page_size * (head_dim + 16 // itemsize) * itemsize
            + 2 * page_size * head_dim * itemsize
            + rows * (head_dim + page_size + 3) * 4)


def paged_attention_supported(*, page_size: int, head_dim: int,
                              num_heads: int, num_kv_heads: int,
                              dtype: torch.dtype, w: int = 1) -> Tuple[bool, str]:
    """(ok, reason): whether the Hopper kernel takes this configuration.
    Re-derived for the card from ``paged_attention_supported``
    (``paddlepaddle_tpu/ops/kernels/paged_attention.py:70``): the TPU's
    8-row sublane and 128-lane rules become a warp-stride rule on
    ``head_dim``, a register bound on the query rows a CTA serves, and the
    227 KB shared-memory bound on the staged page."""
    if dtype not in _KERNEL_DTYPES:
        return False, f"dtype {dtype} (kernel takes float32, bfloat16)"
    if num_kv_heads < 1 or num_heads % num_kv_heads:
        return False, (f"num_heads {num_heads} not divisible by "
                       f"num_kv_heads {num_kv_heads}")
    if head_dim not in HEAD_DIMS:
        return False, f"head_dim {head_dim} not in {HEAD_DIMS}"
    if not 1 <= w <= MAX_W:
        return False, f"W {w} outside 1..{MAX_W}"
    rows = w * (num_heads // num_kv_heads)
    if rows > MAX_ROWS:
        return False, f"rep*W = {rows} query rows per KV head > {MAX_ROWS}"
    if page_size < 1:
        return False, f"page_size {page_size} < 1"
    smem = smem_bytes(page_size, head_dim, rows, dtype.itemsize)
    if smem > SMEM_LIMIT:
        return False, (f"page_size {page_size} needs {smem} B shared memory "
                       f"> {SMEM_LIMIT}")
    return True, "ok"


def paged_attention_plain(q, k_pool, v_pool, page_table, lens, *, rep: int,
                          scale: float) -> torch.Tensor:
    """The plain PyTorch version: gather each slot's logical view through
    the page table (pages wholly past the visible window redirected to the
    null page, as the TPU kernel's index map did), mask ``k_pos > lens + w``
    with -1e30, one f32 softmax — the semantics of ``_ref_gqa_attention``
    (``paddlepaddle_tpu/inference/decode_engine.py:713``)."""
    S, W, h, hd = q.shape
    ps, kvh = k_pool.shape[1], k_pool.shape[2]
    P = page_table.shape[1]
    dev = q.device
    lens = lens.long()
    visible = (torch.arange(P, device=dev)[None, :] * ps
               <= lens[:, None] + (W - 1))
    pt = torch.where(visible, page_table.long(), 0)
    kview = k_pool[pt].reshape(S, P * ps, kvh, hd).float()
    vview = v_pool[pt].reshape(S, P * ps, kvh, hd).float()
    qg = q.float().reshape(S, W, kvh, rep, hd) * scale
    att = torch.einsum("swgrd,stgd->swgrt", qg, kview)
    k_pos = torch.arange(P * ps, device=dev)
    q_pos = lens[:, None] + torch.arange(W, device=dev)[None, :]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]           # [S, W, T]
    att = att.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.softmax(att, dim=-1)
    out = torch.einsum("swgrt,stgd->swgrd", p, vview)
    return out.reshape(S, W, h, hd).to(q.dtype)


def _check_cuda_args(q, k_pool, v_pool, page_table, lens, rep: int) -> None:
    S, W, h, hd = q.shape
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools {k_pool.dtype}/{v_pool.dtype} must match "
                        f"q {q.dtype}")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("page_table and lens must be int32")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 \
            or k_pool.shape[3] != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    kvh = k_pool.shape[2]
    if h != rep * kvh:
        raise ValueError(f"q heads {h} != rep {rep} x kv heads {kvh}")
    if page_table.dim() != 2 or page_table.shape[0] != S \
            or tuple(lens.shape) != (S,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lens "
                         f"{tuple(lens.shape)} do not fit {S} slots")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    ok, reason = paged_attention_supported(
        page_size=k_pool.shape[1], head_dim=hd, num_heads=h,
        num_kv_heads=kvh, dtype=q.dtype, w=W)
    if not ok:
        raise ValueError(f"paged_attention kernel does not take this "
                         f"configuration: {reason}")


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_argtypes_set", False):
        # pointers and the stream as c_void_p: a bare int would be cut to 32
        # bits by ctypes
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.c_float, ci, vp]
        lib.paged_attention_launch.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def build() -> None:
    """Build (first use) and load the kernel library now, so that a build
    error surfaces at engine construction rather than mid-decode."""
    _library()


def paged_attention(q, k_pool, v_pool, page_table, lens, *, rep: int,
                    scale: float) -> torch.Tensor:
    """Attend ``q [S, W, h, hd]`` over each slot's paged KV. Returns
    ``out [S, W, h, hd]`` in q's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream (no sync) or
    raise."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, lens,
                                     rep=rep, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check_cuda_args(q, k_pool, v_pool, page_table, lens, rep)
    S, W, h, hd = q.shape
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        S, W, h, k_pool.shape[2], hd, k_pool.shape[1], page_table.shape[1],
        float(scale), _KERNEL_DTYPES[q.dtype], stream)
    if err:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
