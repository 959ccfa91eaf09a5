"""Paged-attention decode: the CUDA kernel's wrapper, its plain PyTorch
version, and the Hopper support check.

Replaces the TPU kernel ``paged_attention`` / ``_paged_attn_kernel``
(``paddlepaddle_tpu/ops/kernels/paged_attention.py:175`` / ``:104``) in both
of its variants: full-precision pools (kernel 1) and int8 pools with
per-page, per-head scales (kernel 1q, ``quantized=True`` :113-131). The
kernel itself is ``csrc/paged_attention.cu`` (design, bound and known
limits in its header). Shape contract, as on the TPU:

* ``q``           ``[S, W, h, hd]`` — W new positions per slot (W=1 is the
  decode step);
* ``k_pool/v_pool`` ``[pages, page_size, kvh, hd]`` (page 0 is the engine's
  null page);
* ``page_table``  ``[S, P]`` int32 physical page per logical page;
* ``lens``        ``[S]`` int32 slot length BEFORE this step's writes;
  query w attends keys ``k_pos <= lens + w``;
* ``k_scale/v_scale`` ``[pages, kvh]`` float32, both or neither: given, the
  pools hold int8 codes and element ``x`` of page ``p``, head ``g`` reads as
  ``float(x) * scale[p, g]`` (no rounding to q's type).

:func:`paged_attention` runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. ``paged_attention.launches``
counts full-precision kernel launches and ``paged_attention.int8_launches``
int8 ones (never plain-version calls). Engines in several threads share
the counters, so a launch counts under a lock; inside :func:`launch_tally`
the calling thread's launches go to its own tally instead (a graph
capture, whose launches count when the graph replays).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from . import _build
from ...observability.perf import costs as _costs

NEG_INF = -1e30
HEAD_DIMS = (64, 128)        # a lane owns hd/32 dims in the p.v phase
MAX_W = 4                    # W = 1..4, as the TPU kernel's callers use it
MAX_ROWS = 32                # rep * W query rows per CTA (register budget)
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
STAGES = 2                   # pages in a CTA's shared-memory ring
K_PAD = 16                   # K row padding in shared memory, elements
WARPS = 8                    # warps of one CTA
CTAS_PER_SM = 4              # the split planner's target
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_QUANTS = (None, "int8")


def row_bucket(rows: int) -> int:
    """The kernel's template bucket for ``rows = rep * W`` query rows."""
    return 4 if rows <= 4 else 8 if rows <= 8 else 16 if rows <= 16 else 32


def smem_bytes(page_size: int, head_dim: int, rows: int,
               itemsize: int) -> int:
    """Dynamic shared memory of one CTA for pool elements of ``itemsize``
    bytes (1 for int8 codes; mirrors ``smem_bytes`` in the CUDA source): a
    ring of ``STAGES`` staged pages (K rows padded by ``K_PAD`` elements, V
    rows unpadded), the f32 query rows of the row bucket (reused for the
    merged accumulator), per-warp row maxima plus the row sums, and each
    staged page's two int8 scales."""
    rb = row_bucket(rows)
    return (STAGES * page_size * (2 * head_dim + K_PAD) * itemsize
            + rb * head_dim * 4 + (WARPS + 1) * rb * 4 + STAGES * 2 * 4)


def split_plan(num_slots: int, num_kv_heads: int, pages_per_slot: int,
               sm_count: int) -> Tuple[int, int]:
    """``(n_split, pages_per_split)`` of the context split: a function of
    the grid's shape and the card alone, never of ``lens``, so the kernel's
    grid ``(kvh, S, n_split)`` is the same for every step of an engine.
    It aims at ``CTAS_PER_SM`` CTAs per SM (about half of them find pages
    under uniformly drawn lens), splits no finer than one page, and then
    drops splits the rounded-up page count leaves empty. Split ``i`` covers
    logical pages ``[i * pps, (i + 1) * pps)``; together the splits cover
    ``0 .. P - 1`` exactly once, in order."""
    if min(num_slots, num_kv_heads, pages_per_slot, sm_count) < 1:
        raise ValueError("split_plan: every argument must be >= 1")
    base = num_slots * num_kv_heads
    want = max(1, -(-CTAS_PER_SM * sm_count // base))
    n = min(pages_per_slot, want)
    pps = -(-pages_per_slot // n)
    return -(-pages_per_slot // pps), pps


_sm_counts = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def reference_kernel_head_dim(head_dim: int) -> bool:
    """The head-dim test of the JAX package's gate
    (``paddlepaddle_tpu/ops/kernels/paged_attention.py:99``): its TPU kernel
    takes a multiple of 128 or 8, 16, 32, 64; every other head dim is served
    by the reference's gather formulation and never reaches a TPU kernel.
    The serving engine decodes those through :func:`paged_attention_plain`
    on either device. Head dims the TPU kernel takes and this kernel does
    not (8, 16, 32, 256, ...) are not routed there: on the card they reach
    :func:`paged_attention_supported` and raise."""
    return head_dim % 128 == 0 or head_dim in (8, 16, 32, 64)


def paged_attention_supported(*, page_size: int, head_dim: int,
                              num_heads: int, num_kv_heads: int,
                              dtype: torch.dtype, w: int = 1,
                              kv_quant: Optional[str] = None
                              ) -> Tuple[bool, str]:
    """(ok, reason): whether the Hopper kernel takes this configuration,
    for full-precision pools of q's ``dtype`` or, ``kv_quant="int8"``, for
    int8 pools (kernel 1q). Re-derived for the card from
    ``paged_attention_supported``
    (``paddlepaddle_tpu/ops/kernels/paged_attention.py:70``): the TPU's
    8-row sublane and 128-lane rules become a lane rule on ``head_dim``, a
    register bound on the query rows a CTA serves, and the 227 KB
    shared-memory bound on the ring of staged pages."""
    if kv_quant not in KV_QUANTS:
        return False, f"kv_quant {kv_quant!r} (kernel takes None, 'int8')"
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
    itemsize = 1 if kv_quant == "int8" else dtype.itemsize
    smem = smem_bytes(page_size, head_dim, rows, itemsize)
    if smem > SMEM_LIMIT:
        return False, (f"page_size {page_size} needs {smem} B shared memory "
                       f"> {SMEM_LIMIT}")
    return True, "ok"


def _plain_logits(q, k_pool, v_pool, page_table, lens, rep, scale, k_scale,
                  v_scale):
    """Each slot's logical view gathered through the page table (pages
    wholly past the visible window redirected to the null page, as the TPU
    kernel's index map did; int8 pages dequantized in f32 as ``codes *
    scale``), and the f32 logits of the grouped queries against it with
    ``k_pos > lens + w`` filled with -1e30. Returns ``(att [S, W, kvh, rep,
    T], visible keys [S, W, 1, 1, T], vview [S, T, kvh, hd])``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    S, W, h, hd = q.shape
    ps, kvh = k_pool.shape[1], k_pool.shape[2]
    P = page_table.shape[1]
    dev = q.device
    lens = lens.long()
    visible = (torch.arange(P, device=dev)[None, :] * ps
               <= lens[:, None] + (W - 1))
    pt = torch.where(visible, page_table.long(), 0)
    kview, vview = k_pool[pt].float(), v_pool[pt].float()  # [S, P, ps, kvh, hd]
    if k_scale is not None:
        kview = kview * k_scale[pt][:, :, None, :, None]
        vview = vview * v_scale[pt][:, :, None, :, None]
    kview = kview.reshape(S, P * ps, kvh, hd)
    vview = vview.reshape(S, P * ps, kvh, hd)
    qg = q.float().reshape(S, W, kvh, rep, hd) * scale
    att = torch.einsum("swgrd,stgd->swgrt", qg, kview)
    k_pos = torch.arange(P * ps, device=dev)
    q_pos = lens[:, None] + torch.arange(W, device=dev)[None, :]
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, :, None, None, :]
    return att.masked_fill(~mask, NEG_INF), mask, vview


def paged_attention_plain(q, k_pool, v_pool, page_table, lens, *, rep: int,
                          scale: float, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """The plain PyTorch version: the logits of :func:`_plain_logits`, one
    f32 softmax, the product with the gathered values — the semantics of
    ``_ref_gqa_attention`` (``paddlepaddle_tpu/inference/decode_engine.py
    :713``). With scales, each gathered int8 page is dequantized in f32
    (the TPU kernel's :129-131), never rounded to q's dtype."""
    att, _, vview = _plain_logits(q, k_pool, v_pool, page_table, lens, rep,
                                  scale, k_scale, v_scale)
    p = torch.softmax(att, dim=-1)
    out = torch.einsum("swgrt,stgd->swgrd", p, vview)
    return out.reshape(q.shape).to(q.dtype)


def paged_attention_partials_plain(q, k_pool, v_pool, page_table, lens, *,
                                   rep: int, scale: float, n_split: int,
                                   pages_per_split: int, k_scale=None,
                                   v_scale=None):
    """The split kernel's arithmetic in plain PyTorch: for each split ``i``
    of :func:`split_plan`, over the visible keys of logical pages
    ``[i * pps, (i + 1) * pps)``, the unnormalised partial ``o_i = sum
    e^(s - m_i) v``, ``m_i = max s`` and ``l_i = sum e^(s - m_i)`` (natural
    units; the kernel runs in log2 units, which the merge does not see). A
    split without a visible key gives ``m = -1e30, l = 0, o = 0``. Returns
    f32 ``(o [n, S, W, h, hd], m [n, S, W, h], l [n, S, W, h])``."""
    S, W, h, hd = q.shape
    ps, P = k_pool.shape[1], page_table.shape[1]
    if n_split * pages_per_split < P:
        raise ValueError(f"{n_split} splits of {pages_per_split} pages do "
                         f"not cover {P}")
    att, mask, vview = _plain_logits(q, k_pool, v_pool, page_table, lens,
                                     rep, scale, k_scale, v_scale)
    os_, ms, ls = [], [], []
    for i in range(n_split):
        lo = i * pages_per_split * ps
        hi = min((i + 1) * pages_per_split, P) * ps
        a = att[..., lo:hi]
        m = (a.amax(-1) if hi > lo
             else torch.full(a.shape[:-1], NEG_INF, device=q.device))
        p = torch.where(mask[..., lo:hi], torch.exp(a - m[..., None]),
                        torch.zeros((), device=q.device))
        os_.append(torch.einsum("swgrt,stgd->swgrd", p,
                                vview[:, lo:hi]).reshape(S, W, h, hd))
        ms.append(m.reshape(S, W, h))
        ls.append(p.sum(-1).reshape(S, W, h))
    return torch.stack(os_), torch.stack(ms), torch.stack(ls)


def merge_partials_plain(o, m, l, dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel's arithmetic: ``m* = max_i m_i``, ``l = sum_i l_i
    e^(m_i - m*)``, ``out = sum_i o_i e^(m_i - m*) / max(l, 1e-30)`` in
    ``dtype``, over partials stacked on dim 0."""
    m_star = m.amax(0)
    w = torch.exp(m - m_star)
    den = (l * w).sum(0)
    num = (o * w[..., None]).sum(0)
    return (num / den.clamp_min(1e-30)[..., None]).to(dtype)


def _check_cuda_args(q, k_pool, v_pool, page_table, lens, rep: int,
                     k_scale=None, v_scale=None) -> None:
    S, W, h, hd = q.shape
    dev = q.device
    quant = k_scale is not None
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("page_table", page_table), ("lens", lens)]
    if quant:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    pool_dtype = torch.int8 if quant else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"pools {k_pool.dtype}/{v_pool.dtype} must be "
                        f"{pool_dtype}" + ("" if quant else " (q's dtype)"))
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
    if quant:
        want = (k_pool.shape[0], kvh)
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name} must be float32 {list(want)}, got "
                                 f"{t.dtype} {list(t.shape)}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    ok, reason = paged_attention_supported(
        page_size=k_pool.shape[1], head_dim=hd, num_heads=h,
        num_kv_heads=kvh, dtype=q.dtype, w=W,
        kv_quant="int8" if quant else None)
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
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
            ci, ci, ci, ci, ctypes.c_float, ci, vp]
        lib.paged_attention_launch.restype = ci
        lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def build() -> None:
    """Build (first use) and load the kernel library now, so that a build
    error surfaces at engine construction rather than mid-decode."""
    _library()


def paged_work(lens, W, h, kvh, hd, ps, P, q_item, kv_item, scales=False):
    """Bytes and operations the paged attention must move and do for these
    ``lens`` (a list of ints): each visible key's K and V row read once (as
    codes plus one f32 scale per visible page and KV head under int8), q
    read and out written once, the page-table entries and lens read once;
    ``flops``, the products of q.k and p.v over every visible key of every
    query row (tensor-core work), and ``deq_flops``, under int8 one
    dequantizing product per visible K/V element (f32 work outside the
    tensor cores). Returns ``(bytes, flops, deq_flops)``."""
    S = len(lens)
    keys = [n + W for n in lens]
    n_vis = [min(P, -(-k // ps)) for k in keys]
    bytes_ = (sum(keys) * kvh * hd * 2 * kv_item + 2 * S * W * h * hd * q_item
              + 4 * sum(n_vis) + 4 * S)
    rows_keys = sum(n + w + 1 for n in lens for w in range(W))
    flops = 2 * 2 * hd * h * rows_keys
    deq_flops = 0
    if scales:
        bytes_ += 2 * 4 * kvh * sum(n_vis)
        deq_flops = 2 * kvh * hd * sum(keys)
    return bytes_, flops, deq_flops


def paged_attention(q, k_pool, v_pool, page_table, lens, *, rep: int,
                    scale: float, k_scale=None, v_scale=None) -> torch.Tensor:
    """Attend ``q [S, W, h, hd]`` over each slot's paged KV. Returns
    ``out [S, W, h, hd]`` in q's dtype. ``k_scale``/``v_scale`` (both or
    neither) select the int8 variant. CPU tensors take the plain version;
    CUDA tensors launch the split kernel and its merge on the current
    stream (no sync; the split from :func:`split_plan`, the f32 partials in
    scratch from ``torch.empty``) or raise. One call counts one launch."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    kw = dict(rep=rep, scale=scale, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, lens, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check_cuda_args(q, k_pool, v_pool, page_table, lens, rep, k_scale,
                     v_scale)
    quant = k_scale is not None
    S, W, h, hd = q.shape
    kvh, ps, P = k_pool.shape[2], k_pool.shape[1], page_table.shape[1]
    n_split, pps = split_plan(S, kvh, P, _sm_count(q.device))
    out = torch.empty_like(q)
    o_part = torch.empty((n_split, S, W, h, hd), dtype=torch.float32,
                         device=q.device)
    ml_part = torch.empty((2, n_split, S, W, h), dtype=torch.float32,
                          device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        o_part.data_ptr(), ml_part[0].data_ptr(), ml_part[1].data_ptr(),
        S, W, h, kvh, hd, ps, P, n_split, pps, float(scale),
        _KERNEL_DTYPES[q.dtype], stream)
    if err:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    _count_launch("int8_launches" if quant else "launches")
    if _costs.counting_open():
        bytes_, flops, deq = paged_work(
            lens.tolist(), W, h, kvh, hd, ps, P, q.element_size(),
            k_pool.element_size(), scales=quant)
        _costs.kernel_work("paged_attention", flops + deq, bytes_)
    return out


paged_attention.launches = 0
paged_attention.int8_launches = 0

_count_lock = threading.Lock()
_tally = threading.local()


def _count_launch(name: str) -> None:
    sink = getattr(_tally, "sink", None)
    if sink is not None:
        sink[name] = sink.get(name, 0) + 1
        return
    with _count_lock:
        setattr(paged_attention, name, getattr(paged_attention, name) + 1)


@contextlib.contextmanager
def launch_tally() -> Iterator[Dict[str, int]]:
    """Count the calling thread's launches into the yielded dict, not into
    ``paged_attention.launches`` / ``int8_launches``; other threads keep
    counting as before."""
    prev = getattr(_tally, "sink", None)
    _tally.sink = sink = {}
    try:
        yield sink
    finally:
        _tally.sink = prev


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (counter name -> launches) to the counters: a graph
    replay's launches."""
    with _count_lock:
        for name, n in counts.items():
            setattr(paged_attention, name, getattr(paged_attention, name) + n)
