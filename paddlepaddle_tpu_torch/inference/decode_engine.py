"""Continuous-batching decode engine — paged KV pool, ragged lengths.

Port of ``paddlepaddle_tpu/inference/decode_engine.py``: ``BatchDecodeEngine``
with the paged layout (full-precision or int8 KV pages, shared-prefix hits,
the host-RAM prefix tier, speculative decoding) and the slot-contiguous
layout, over full-precision or weight-only int8 weights, with the
reference's compile plan, warmup and bundles and its observability seams;
no mesh.

* PAGED KV POOL (``kv_layout="paged"``, the default): one ``[num_pages,
  page_size, kvh, hd]`` K and V buffer per layer plus a device page table
  ``[slots, max_len/page_size]`` int32. Admission reserves pages for the
  request's full prompt + budget from the host free list (:mod:`.kv_pool`),
  prefills the prompt, and writes the K/V page by page; retirement returns
  the pages and zeroes the slot's table row so stray writes land in the
  null page 0.
* CONTIGUOUS KV (``kv_layout="contiguous"``, reference :1-45, :853): one
  ``[slots, max_len, kvh, hd]`` K and V buffer per layer, every slot
  holding ``max_len`` whatever its request needs. Admission prefills the
  prompt padded to a 128 bucket and writes the bucket's rows into the
  slot; decode runs the model's own cached attention (``_cached_attention``,
  plain PyTorch) at per-slot positions. There is no page table, so the
  paged kernel never runs here (the reference's fused gate refuses the
  layout the same way), and int8 KV and speculative decoding need paged.
* INT8 KV (``kv_quant="int8"``): each pool entry is ``(codes int8
  [pages, ps, kvh, hd], scale f32 [pages, kvh])``. Admission quantizes whole
  pages (:func:`_kv_quant_pages`); decode quantizes this step's rows into
  their pages with a running absmax scale (:func:`_kv_quant_scatter`), then
  attends through the int8 variant of the kernel, which dequantizes each
  element as ``codes * scale`` in f32. About 2x the pages of a bf16 pool at
  a fixed byte budget.
* WEIGHT-ONLY INT8 (``quant="weight_only_int8"``, ``quant_group_size``;
  reference :250-266): the weights are quantized once, at construction,
  into a module view of the model (:func:`~..nn.quant.quantized_view`)
  whose projections and LM head are ``WeightOnlyLinear`` over int8 codes;
  the embedding, the norms and the rope tables are shared. Prefill, decode
  and the captured chunk all run through the view (``self.net``); the
  caller's model is left as it was and keeps computing in full precision.
* SHARED PREFIXES (``prefix_cache=True``, requests with ``prefix_len``):
  page-aligned prompt prefixes are content-hashed. A miss prefills in full
  and pins the prefix pages read-only (ref-counted); a hit prefills ONLY the
  tail against the cached pages. Refcount-0 entries stay cached and are
  LRU-evicted when the free list runs dry; with ``kv_host_bytes`` they spill
  to a bounded host-RAM tier as ``KVS1`` slabs and are restored into fresh
  pages on the next hit (a slab that does not match is a logged miss).
* DECODE: each paged step scatters its new K/V into their physical pages
  first, then attends through
  :func:`~..ops.kernels.paged_attention.paged_attention`, which walks the
  page table itself (the CUDA kernel on the card, the plain version on the
  CPU); ``fused_kernels=False`` attends through ``paged_attention_plain``
  instead, on either device, as the reference's kernel-off engine attends
  through its gathered view. A chunk of ``chunk`` steps is one device-only
  program, :meth:`BatchDecodeEngine._decode_body`: it reads the static
  per-slot buffers and writes its results into them and into a static
  ``packed [slots, chunk+1]`` payload, and it never reads a value back.
* PROGRAMS (:meth:`BatchDecodeEngine._program`, the counterpart of the
  reference's registry :1066-1106): ``"decode"`` (paged) or
  ``"decode_contig"`` (contiguous) and, with speculative decoding,
  ``"draft_k<k>"`` and ``"verify_k<k>"``. On the CPU a program is its body,
  called directly. On CUDA its first call runs the body eagerly on a side
  stream and then captures it as a ``torch.cuda.CUDAGraph``
  (:class:`_CapturedProgram`); every later call replays the graph. The
  whole decode chunk is one graph, the reference's one program per chunk,
  followed by the chunk's ONE host readback. There is no switch and no
  return to the eager loop: a capture that fails raises.
* SPECULATIVE DECODING (``draft=``, ``spec_k=``, ``draft_quant=``;
  :mod:`.speculative`): a draft proposes ``k`` greedy tokens per slot and
  the engine's own paged forward verifies them at W = k+1 (the kernel with
  ``k+1`` query rows per slot); greedy requests only.
* COLD START (reference :1066-1350, :mod:`.compile_plan`):
  ``compile_plan`` enumerates the reference's program keys for this
  configuration; :meth:`BatchDecodeEngine.warmup` builds the kernel
  libraries the plan launches, captures every captured program (``decode``
  / ``decode_contig``, or ``draft_k<k>`` and ``verify_k<k>``) without
  serving a chunk, and runs one throwaway admission per prompt bucket into
  a free slot (its pages returned, its sampling draws undone), so cuBLAS
  and the caching allocator are warm. The serve window after it captures
  and builds nothing. ``bundle=`` loads a bundle written by
  :meth:`BatchDecodeEngine.save_serving_bundle` (the manifest and the
  kernel libraries), so a fresh host loads the libraries instead of
  building them; a stale or corrupt bundle is a logged fallback.
* OBSERVABILITY (:mod:`..observability`): the reference's ``paddle_*``
  KV, prefix, warmup and bundle metrics; request journeys (queue wait,
  admit, first token, each decode chunk, speculative rounds); the goodput
  ledger at retirement and release; the program costs of the decode chunk
  and the admissions (perf plane); flight-recorder events; the watchdog
  counts every capture; the memory ledger tracks the engine weakly.
* The pools, the page table and the slot state are updated IN PLACE
  (``index_put_`` / ``copy_``) where the reference donated its buffers to
  XLA; that is also what lets a captured graph replay over them.

One deliberate difference: under int8 every page of a new reservation
starts at scale 0 (the prompt's rows padded with zeros over all of the
slot's private pages). The reference zeroes the pages its prefill bucket
covers and leaves a stale scale on reserved pages past it, which only
coarsens their quantization; the two agree whenever the bucket covers the
reservation.

Head dims that the reference's kernel gate refuses (neither a multiple of
128 nor 8/16/32/64) never reach a TPU kernel there; here they decode through
the plain paged attention on either device (the kernel counters stay 0).

* TENSOR PARALLEL (``mesh=`` / ``plan=``, reference :266-291, :396-403,
  :470-491): SPMD, one engine per rank of a ``torch.distributed`` job
  (:mod:`..distributed.shard_plan`). Each rank's engine holds its weight
  shards (``plan.shard``: a column- / row-parallel view, the row-parallel
  outputs all-reduced over ``mp``, the vocab-sharded logits gathered
  before sampling) and a KV pool of ``[pages, ps, kvh/mp, hd]``; prefill
  and decode run on its local heads, decode through kernel 1. Rank 0 is
  the driver: it owns the queue and ``serve`` / ``submit`` / ``generate``,
  and every device-touching step (admission, decode chunk, release,
  reset, flush, warmup) is first broadcast to the followers on a CPU gloo
  control group, so every rank runs the same body in the same order; the
  host-side pool, prefix and slot decisions are deterministic, and the
  sampling generator is seeded alike, so the tokens agree everywhere.
  Ranks > 0 call :meth:`BatchDecodeEngine.follow` (a ``ServingEngine``
  does it on ``start()``) until rank 0's :meth:`BatchDecodeEngine.stop`.
  The decode chunk is captured when the plan's groups can be (NCCL, world
  size 1 included); under gloo it runs eagerly and ``capture_info()`` says
  so (a gloo collective cannot be captured). ``kv_quant="int8"`` with a
  plan raises (reference :319-324); speculative decoding with a plan, and
  a multi-rank plan in a process with no process group, raise naming
  A10's later slices.

No option is silently ignored.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import logging
import math
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.errors import not_ported
from ..core.flags import flag_value
from ..device import DeviceLike, resolve_device
from ..models.llama import rope_at, rotate
from ..nn.quant import quantized_view
from ..nn.quant.quantized_linear import _q127
from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import memledger as _memledger
from ..observability import perf as _perf
from ..observability import watchdog as _watchdog
from ..ops.kernels import _build
from ..ops.kernels import paged_attention as _pa
from . import compile_plan as _cp
from .kv_pool import (
    HostPrefixTier,
    HostSlab,
    PagePool,
    PrefixCache,
    deserialize_page_slab,
    pages_needed,
    prefix_hash,
    serialize_page_slab,
)
from .robustness import KVCapacityError, safe_inc, safe_set

_log = logging.getLogger(__name__)


def _bucket(n: int, q: int = 128) -> int:
    return -(-n // q) * q


# -- int8 KV pages (kv_quant="int8"), reference decode_engine.py:70-132 ------
# Symmetric absmax: each K/V page carries one f32 scale per KV head
# ([num_pages, kvh] beside the pool), codes are int8 in [-127, 127], and a
# value reads back as ``codes * scale`` in f32. torch.round and jnp.round
# both round half to even, so codes and scales are bit-equal to the
# reference's. The divisions by 127 divide by a device tensor: PyTorch's
# CUDA division by a Python scalar multiplies by its reciprocal, which
# rounds differently.

def _kv_quant_pages(x: torch.Tensor):
    """Quantize whole pages ``x [npg, ps, kvh, hd]`` (f32): per-(page, head)
    absmax scale. Rows past the prompt must already be zero so that padding
    never inflates a scale. Returns ``(codes int8, scale f32 [npg, kvh])``."""
    amax = x.abs().amax(dim=(1, 3))
    scale = amax / _q127(amax)
    codes = torch.round(x / scale.clamp_min(1e-20)[:, None, :, None])
    return codes.clamp_(-127, 127).to(torch.int8), scale


def _kv_dequant_gather(codes: torch.Tensor, scale: torch.Tensor,
                       idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pages ``idx`` of an int8 pool read back: ``codes[idx] * scale[idx]``
    in f32, cast to ``dtype`` (the engine's KV dtype)."""
    g = codes[idx].float()
    return (g * scale[idx][..., None, :, None]).to(dtype)


def _kv_quant_scatter(codes: torch.Tensor, scales: torch.Tensor,
                      new_rows: torch.Tensor, phys: torch.Tensor,
                      off: torch.Tensor):
    """Write ``new_rows [S, W, kvh, hd]`` (this step's K or V, already in
    the engine's KV dtype) into the int8 pool at physical page ``phys`` and
    in-page offset ``off`` (``[S, W]`` each), quantizing as they are
    written, IN PLACE; returns ``(codes, scales)``.

    The page scale is a running absmax: when a new row fits the existing
    scale the rescale factor is exactly 1.0 and the page's codes are kept
    bit for bit; only a growing absmax requantizes the page. Duplicate
    targets across slots occur only on the null page 0, whose content is
    never read unmasked (``index_put_`` picks one writer there)."""
    S, W = phys.shape
    sl = torch.arange(S, device=codes.device)
    new_rows = new_rows.float()
    for w in range(W):
        pw, ow = phys[:, w], off[:, w]
        new = new_rows[:, w]                                 # [S, kvh, hd]
        old_scale = scales[pw]                               # [S, kvh]
        amax = new.abs().amax(dim=-1)
        new_scale = torch.maximum(old_scale, amax / _q127(amax))
        safe = new_scale.clamp_min(1e-20)
        q_new = torch.round(new / safe[..., None]).clamp_(-127, 127)
        page = codes[pw].float()                             # [S, ps, kvh, hd]
        factor = old_scale / safe                            # == 1.0 no-grow
        page = torch.round(page * factor[:, None, :, None]).clamp_(-127, 127)
        page = page.to(torch.int8)
        page[sl, ow] = q_new.to(torch.int8)
        codes[pw] = page
        scales[pw] = new_scale
    return codes, scales


def _resolve_kv_quant(kv_quant: Optional[str]) -> Optional[str]:
    """Argument wins over ``FLAGS_serving_kv_quant``; ``""``/``"off"`` mean
    off. Only ``"int8"`` is served (reference :296-313)."""
    if kv_quant is None:
        kv_quant = flag_value("serving_kv_quant")
    if kv_quant in (None, "", "off"):
        return None
    if kv_quant == "int4":
        raise ValueError(
            "kv_quant='int4': the int8 page format (codes + per-page-per-"
            "head scales) is the shipped scheme; int4 packing is the named "
            "follow-up seam on the same scale buffers, not served as int8")
    if kv_quant != "int8":
        raise ValueError(f"kv_quant={kv_quant!r}: 'int8' is the supported "
                         "KV-cache scheme ('int4' is the named seam)")
    return kv_quant


def _stamp(req, attr: str, value=None) -> None:
    """SLO timestamp on the request's result future, when it has one."""
    res = getattr(req, "result", None)
    if res is not None:
        setattr(res, attr, time.perf_counter() if value is None else value)


def _trace_of(req):
    """The request's journey (observability.reqtrace), or None."""
    return getattr(getattr(req, "result", None), "_trace", None)


class _Slot:
    __slots__ = ("req", "emitted", "budget", "spec_steps", "spec_accepted")

    def __init__(self, req=None, budget=0):
        self.req = req
        self.emitted: List[int] = []
        self.budget = budget
        self.spec_steps = 0       # speculative verify steps this request saw
        self.spec_accepted = 0    # draft tokens the verifier accepted for it


class _CapturedProgram:
    """A device-only program body run as a CUDA graph, on PyTorch's capture
    recipe. The first call runs the body eagerly on a side stream (the
    warm-up: cuBLAS handles, allocator; its result is this call's result)
    and then captures the body into a ``torch.cuda.CUDAGraph``; every later
    call is one ``replay()`` on the current stream. Whatever the body reads
    or writes lives in buffers the engine updates in place between calls.
    The body's temporaries come from ``pool``, a private memory pool the
    engine's graphs share (they replay one after another on one stream).

    ``generators`` are registered with the graph, so each replay draws new
    numbers from them (the engine's sampling generator). The kernels'
    launches are counted where the graph runs, not where it is captured:
    the capture counts them into its own thread's tally
    (``paged_attention.launch_tally``), kept as the graph's launches and
    added to the counters on every replay. A capture that fails raises;
    there is no return to the eager body.

    Other engines in the process may decode while this one captures (a
    fleet's in-process replicas, a rolling restart's warmup): the capture
    runs in CUDA's thread-local mode, so only this thread is held to the
    capture's rules, and the tallies are this thread's, so another
    engine's launches never enter this graph's count.

    :meth:`capture` is warmup's form: the eager run is thrown away (the
    generators' states are restored after it and its launches go to a
    discarded tally, so a warmed engine samples and counts as a cold one
    would) and nothing is replayed. Every capture is reported to the
    capture/build watchdog.
    ``count_ctx``, when set before the first call, is a context factory the
    eager run executes inside (the perf plane's cost count)."""

    def __init__(self, key: str, body, device: torch.device, pool,
                 generators=()):
        self.key = key
        self.body = body
        self.device = device
        self.pool = pool
        self.generators = tuple(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.per_replay: Dict[str, int] = {}
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.count_ctx = None

    def __call__(self) -> None:
        if self.graph is None:
            self._warm_up_and_capture()
            return
        self.graph.replay()
        _pa.add_launches(self.per_replay)
        self.replays += 1

    def capture(self) -> None:
        """Capture now, without serving a chunk (warmup)."""
        if self.graph is None:
            self._warm_up_and_capture(throwaway=True)

    def _warm_up_and_capture(self, throwaway: bool = False) -> None:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(cur)
        if throwaway:
            states = [g.get_state() for g in self.generators]
        with torch.cuda.stream(side):
            with (self.count_ctx() if self.count_ctx is not None
                  else contextlib.nullcontext()), \
                    (_pa.launch_tally() if throwaway
                     else contextlib.nullcontext()):
                self.body()
        cur.wait_stream(side)
        if throwaway:
            for g, st in zip(self.generators, states):
                g.set_state(st)
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        side.wait_stream(cur)
        # A graph destroyed while this one captures (a dead engine's,
        # freed by Python's cyclic GC on any thread) invalidates the
        # capture: collect the garbage now, as torch.cuda.graph does, and
        # keep the automatic collector off until the capture ends
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side), _pa.launch_tally() as moved:
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self.body()
                finally:
                    graph.capture_end()
        except BaseException as e:
            raise RuntimeError(f"CUDA graph capture of the {self.key!r} "
                               f"program failed: {type(e).__name__}: "
                               f"{e}") from e
        finally:
            if gc_was_on:
                gc.enable()
        cur.wait_stream(side)
        self.per_replay = {n: m for n, m in moved.items() if m}
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        _watchdog.record_compile("capture", self.key, self.capture_s)

    def info(self) -> Dict[str, object]:
        return {"captured": self.graph is not None,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "replays": self.replays,
                "launches_per_replay": dict(self.per_replay)}


_STOP = "__stop__"
# steps that touch no collective, so rank 0 may still run them alone after
# the followers were released (a drain's reset, then stop()'s)
_LOCAL_AFTER_STOP = ("reset_slots", "release_slot", "flush")


class _WireRequest:
    """What a follower needs of a request: its decode parameters, and a
    result future that receives nothing (rank 0 delivers)."""

    class _NullResult:
        _trace = None
        _event = None
        _t_first = 0.0

        def _set(self, output=None, error=None) -> None:
            pass

    def __init__(self, req):
        self.prompt_ids = np.asarray(req.prompt_ids, np.int32)
        self.max_new_tokens = int(req.max_new_tokens)
        self.temperature = float(getattr(req, "temperature", 0.0) or 0.0)
        self.top_k = int(getattr(req, "top_k", 0) or 0)
        self.eos_token_id = getattr(req, "eos_token_id", None)
        self.prefix_len = getattr(req, "prefix_len", None)
        self.id = getattr(req, "id", None)

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.result = _WireRequest._NullResult()


class _Control:
    """Rank 0's step broadcasts to the followers over the plan's CPU gloo
    control group (``broadcast_object_list``)."""

    def __init__(self, plan):
        import torch.distributed as dist

        self.pg = plan.control_group()
        self.driver = dist.get_rank() == 0
        self.stopped = False
        # rank 0 broadcasts and runs each step under one lock, so steps
        # from two threads reach the followers in the order they run; the
        # nesting depth is the calling thread's own
        self.lock = threading.RLock()
        self._local = threading.local()

    @property
    def depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @depth.setter
    def depth(self, value: int) -> None:
        self._local.depth = value

    def send(self, name: str, args, kwargs) -> None:
        import torch.distributed as dist

        args = tuple(_WireRequest(a) if hasattr(a, "prompt_ids")
                     and hasattr(a, "max_new_tokens") else a for a in args)
        dist.broadcast_object_list([(name, args, dict(kwargs))], src=0,
                                   group=self.pg)

    def receive(self):
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.pg)
        return box[0]


def _led(fn):
    """A device-touching engine step: on rank 0 of a plan it is broadcast
    to the followers before it runs (not when one led step calls another);
    on a follower it runs only from :meth:`BatchDecodeEngine.follow`."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        ctl = self._ctl
        if ctl is None or ctl.depth:
            return fn(self, *args, **kwargs)
        if not ctl.driver:
            raise RuntimeError(
                f"{name}: this rank follows rank 0 under the plan; call "
                "follow() (rank 0 owns serve / submit / generate)")
        if ctl.stopped:
            if name in _LOCAL_AFTER_STOP:
                # host and slot bookkeeping only: no collective to pair
                return fn(self, *args, **kwargs)
            raise RuntimeError(f"{name}: the followers were released "
                               "(stop()); build a new engine")
        with ctl.lock:
            ctl.send(name, args, kwargs)
            ctl.depth += 1
            try:
                return fn(self, *args, **kwargs)
            finally:
                ctl.depth -= 1

    return wrapper


class BatchDecodeEngine:
    """Slot-based continuous-batching decoder for a port
    ``LlamaForCausalLM``, in the reference's parameter order (:226-235);
    ``device`` and ``seed`` are keyword-only. ``device=None`` means the
    card (raises without CUDA); the model must already live on that
    device. ``draft=`` (a port ``LlamaForCausalLM``, the target itself
    included, or a ``LlamaConfig`` built on the engine's device from
    ``seed``) with ``spec_k=`` arms speculative decoding.
    ``fused_kernels``: ``None`` or ``True`` attend through the paged kernel
    (on the card), ``False`` through its plain version. ``bundle=`` names a
    bundle directory (:meth:`save_serving_bundle`); one that does not match
    this engine is reported in ``compile_info()["bundle"]`` and the engine
    builds as usual."""

    TOP_K_CAP = 128  # bound for the per-slot top-k filter

    def __init__(self, model, max_slots: int = 16, max_len: Optional[int] = None,
                 chunk: int = 16, quant: Optional[str] = None,
                 quant_group_size: int = -1, kv_layout: str = "paged",
                 page_size: int = 64, num_pages: Optional[int] = None,
                 prefix_cache: bool = True, mesh=None, plan=None,
                 bundle: Optional[str] = None, draft=None, spec_k: int = 0,
                 draft_quant: Optional[str] = None,
                 fused_kernels: Optional[bool] = None,
                 kv_quant: Optional[str] = None,
                 kv_host_bytes: Optional[int] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'contiguous', got {kv_layout!r}")
        paged = kv_layout == "paged"
        self.kv_layout = kv_layout
        spec = draft is not None or bool(spec_k)
        if spec:
            if draft is None or not spec_k:
                raise ValueError(
                    "speculative decoding needs BOTH draft= (a small model "
                    "or its config) and spec_k= (proposals per target step)")
            if not paged:
                raise ValueError(
                    "speculative decoding requires kv_layout='paged' — the "
                    "page-table indirection IS the KV rollback mechanism")
        if quant is not None and quant != "weight_only_int8":
            raise ValueError(
                f"quant={quant!r}: 'weight_only_int8' is the supported "
                "decode-engine scheme (int4/PTQ honestly absent — "
                "PARITY.md)")
        self.kv_quant = _resolve_kv_quant(kv_quant)
        if self.kv_quant is not None and not paged:
            raise ValueError(
                "kv_quant='int8' needs kv_layout='paged' — scales ride the "
                "page pool; the contiguous layout is the full-precision "
                "parity baseline")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {self.device}")
        cfg = model.config
        self.model = model
        self.cfg = cfg
        # weight-only int8: quantized ONCE here, into a view of the model
        # that every program below runs; the model itself is not changed
        self.quant = quant
        self.quant_meta: Dict[str, object] = {}
        self.net = model
        if quant is not None:
            self.net, self.quant_meta = quantized_view(
                model, algo=quant, group_size=quant_group_size)
        # tensor parallel: quantize first (whole tensors), shard second
        self.plan = None
        self._ctl = None
        if mesh is not None or plan is not None:
            self._init_plan(mesh, plan, spec)
        tp = self.plan.tp_degree if self.plan is not None else 1
        self._nh = cfg.num_attention_heads // tp     # this rank's heads
        self._kvh = cfg.num_key_value_heads // tp
        self.S = int(max_slots)
        self.L = int(max_len or cfg.max_position_embeddings)
        if self.L > cfg.max_position_embeddings:
            raise ValueError(f"max_len {self.L} exceeds the model's "
                             f"max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        self.chunk = int(chunk)
        kvh, hd = self._kvh, cfg.head_dim
        dtype = model.dtype
        self._kv_dtype = dtype     # scratch / dequant dtype, also under int8
        dev = self.device
        self.kv_host = None
        self._slot_pages: List[List[int]] = [[] for _ in range(self.S)]
        self._slot_prefix: List[Optional[str]] = [None] * self.S
        if paged:
            self.page_size = int(page_size)
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            self.P = pages_needed(self.L, self.page_size)    # pages per slot
            n_pages = (self.S * self.P + 1 if num_pages is None
                       else int(num_pages))
            self.pool = PagePool(n_pages, self.page_size)
            self.prefix = PrefixCache()
            self.prefix_enabled = bool(prefix_cache)
            shape = (n_pages, self.page_size, kvh, hd)

            def pool():
                if self.kv_quant == "int8":
                    return (torch.zeros(shape, dtype=torch.int8, device=dev),
                            torch.zeros((n_pages, kvh), dtype=torch.float32,
                                        device=dev))
                return torch.zeros(shape, dtype=dtype, device=dev)

            # per layer (K, V); under int8 each is (codes, scale)
            self.caches = [(pool(), pool())
                           for _ in range(cfg.num_hidden_layers)]
            self.page_table = torch.zeros((self.S, self.P),
                                          dtype=torch.int32, device=dev)
            # host-RAM prefix spill tier: only where there are prefixes
            if kv_host_bytes is None:
                kv_host_bytes = int(flag_value("serving_kv_host_bytes") or 0)
            if kv_host_bytes and prefix_cache:
                self.kv_host = HostPrefixTier(int(kv_host_bytes))
            self._kv_gauges(total=True)
            if self.kv_quant is not None:
                safe_set("paddle_serving_kv_quant_enabled",
                         "KV-cache quantization live on this engine "
                         "(1 = yes)", 1, mode=self.kv_quant)
        else:
            self.page_size = 0
            self.P = 0
            self.pool = None
            self.prefix = None
            self.prefix_enabled = False
            self.page_table = None
            shape = (self.S, self.L, kvh, hd)
            self.caches = [(torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev))
                           for _ in range(cfg.num_hidden_layers)]
        self._resolve_attention(fused_kernels, paged, spec, spec_k)
        self._decode_key = "decode" if paged else "decode_contig"
        self._restore_ms: List[float] = []
        # device-resident per-slot state
        i32 = dict(dtype=torch.int32, device=dev)
        self.lens = torch.zeros(self.S, **i32)
        self.tokens = torch.zeros(self.S, **i32)       # last token
        self.active = torch.zeros(self.S, dtype=torch.bool, device=dev)
        self.temps = torch.zeros(self.S, dtype=torch.float32, device=dev)
        self.eos_ids = torch.full((self.S,), -1, **i32)
        self.budgets = torch.zeros(self.S, **i32)      # tokens left
        self.top_ks = torch.zeros(self.S, **i32)       # 0 = off
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(seed))
        # the decode chunk's payload: tokens (-1 where idle), last column =
        # active at the chunk's end
        self.packed = torch.zeros((self.S, self.chunk + 1), **i32)
        self._host_slots = [_Slot() for _ in range(self.S)]
        self._first_pending: Dict[int, torch.Tensor] = {}  # slot -> 0-d
        self.stats = {"tokens_out": 0, "requests": 0, "decode_calls": 0,
                      "decode_steps": 0, "peak_busy": 0,
                      "restore_failures": 0}
        # host wall of the most recent decode chunks, queue to readback (ms)
        self.chunk_ms: List[float] = []
        # program registry (captured programs) and the plan keys whose first
        # build or run has happened (captures, and admissions per bucket)
        self._programs: Dict[str, object] = {}
        self._warmed: set = set()
        self._warm_info: Optional[Dict[str, object]] = None
        self._bundle_info: Optional[Dict[str, object]] = None
        self._costed: set = set()        # perf plane: programs counted
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        self.spec = None
        if spec:
            from .speculative import SpeculativeDecoder

            self.spec = SpeculativeDecoder(self, draft, spec_k, draft_quant,
                                           seed=seed)
            self._spec_steps_per_chunk = max(
                1, self.chunk // (self.spec.k + 1))
            # one verify payload per outer step, read back once a chunk
            self._spec_packed = torch.zeros(
                (self.S, self._spec_steps_per_chunk, self.spec.k + 3), **i32)
        self.compile_plan = _cp.CompilePlan.for_engine(self)
        # weak: the memory ledger must never extend the engine's lifetime
        _memledger.register_engine(self)
        if bundle is not None:
            # never fatal: a stale or foreign bundle logs and the engine
            # builds its kernel libraries as usual
            self.load_serving_bundle(bundle)
        if self.kernel == "cuda":
            # build (or load) the kernel library now, so that a build error
            # surfaces at construction rather than mid-decode
            _pa.build()

    def _resolve_attention(self, fused_kernels: Optional[bool], paged: bool,
                           spec: bool, spec_k: int) -> None:
        """How decode attends, resolved once (reference ``_resolve_fused``
        :598-639): the paged kernel, its plain version, or (contiguous) the
        model's own cached attention. ``self.fused`` is the reference's
        ``health()["fused"]`` block. On the card the kernel's support check
        runs here for every W this engine launches (1, and k+1 under
        speculation): a configuration the kernel does not take raises now,
        never a quiet downgrade later."""
        cfg = self.cfg
        nh, kvh, hd = self._nh, self._kvh, cfg.head_dim
        want = fused_kernels is None or bool(fused_kernels)
        self.kernel = "plain"
        self._attend = _pa.paged_attention
        self.fused = {"enabled": False, "paged_attention": "off"}
        if not paged:
            self._attend = None
            if want:
                reason = "kv_layout contiguous (no page table)"
                self.fused["paged_attention"] = f"fallback: {reason}"
                if fused_kernels:
                    sys.stderr.write(
                        f"[serving] fused paged-attention kernel "
                        f"unavailable ({reason}); serving the model's "
                        "cached attention\n")
                    safe_inc("paddle_fused_kernel_fallbacks_total",
                             "fused-kernel requests that fell back to the "
                             "reference formulation",
                             kernel="paged_attention",
                             reason=reason.split(" ")[0])
                    _flight.record("compile", "fused_fallback",
                                   kernel="paged_attention", reason=reason)
            return
        if not want:
            self._attend = _pa.paged_attention_plain
            return
        if self.device.type != "cuda":
            # the wrapper's plain version serves CPU tensors
            self.fused = {"enabled": True, "paged_attention": "plain (cpu)"}
            return
        if not _pa.reference_kernel_head_dim(hd):
            # a head dim the reference's gate never sends to a kernel
            self._attend = _pa.paged_attention_plain
            self.fused["paged_attention"] = (
                f"fallback: head_dim {hd} (the reference's gate refuses it)")
            return
        for w in (1, int(spec_k) + 1) if spec else (1,):
            ok, reason = _pa.paged_attention_supported(
                page_size=self.page_size, head_dim=hd, num_heads=nh,
                num_kv_heads=kvh, dtype=self._kv_dtype, w=w,
                kv_quant=self.kv_quant)
            if not ok:
                raise ValueError(
                    f"paged-attention kernel does not take this engine "
                    f"configuration at W={w}: {reason}" +
                    (" (the TPU kernel takes it: open coverage of ROADMAP "
                     "queue B row 1)" if w > 1 else ""))
        _build.check_device(self.device)
        self.kernel = "cuda"
        self.fused = {"enabled": True, "paged_attention": "cuda"}

    def kernel_libraries(self) -> List[str]:
        """The kernel sources (``ops/kernels/csrc/<name>.cu``) this engine
        launches: the paged-attention library where decode attends through
        the kernel, none otherwise (prefill and the draft attend through
        the model's cached attention)."""
        return ["paged_attention"] if self.kernel == "cuda" else []

    def fused_info(self) -> Dict[str, object]:
        """``health()["fused"]``: which kernel this engine decodes through,
        and why not when it does not."""
        return dict(self.fused)

    def spec_info(self) -> Dict[str, object]:
        """``health()["spec"]``: ``{"enabled": False}`` without a draft."""
        return {"enabled": False} if self.spec is None else self.spec.info()

    def mesh_info(self) -> Dict[str, object]:
        """``health()["mesh"]``: the plan's mesh (reference :473), or
        ``{"enabled": False}`` without one."""
        if self.plan is None:
            return {"enabled": False}
        return self.plan.describe()

    # -- tensor parallel (reference :266-291, :470-491) ------------------------
    def _init_plan(self, mesh, plan, spec: bool) -> None:
        from ..distributed.shard_plan import ShardingPlan, decode_plan

        if plan is None:
            plan = mesh if isinstance(mesh, ShardingPlan) else decode_plan(mesh)
        cfg = self.cfg
        # loud: a head count tp does not divide would fit away to a full
        # copy of the pool on every rank
        plan.validate_divisible(
            num_attention_heads=cfg.num_attention_heads,
            num_key_value_heads=cfg.num_key_value_heads,
            intermediate_size=cfg.intermediate_size,
            vocab_size=cfg.vocab_size)
        if self.kv_quant is not None:
            raise ValueError(
                "kv_quant with a tensor-parallel plan: sharding the "
                "(codes, scale) pair per layer is a named follow-up seam "
                "(shard_kv places plain pools only) — serve int8 KV "
                "single-card or drop the plan")
        if spec:
            raise not_ported("speculative decoding under a plan (the "
                             "reference replicates the draft on every rank)",
                             "A10 slice 1")
        plan.require_group()
        self.plan = plan
        self.net = plan.shard(self.net)
        if plan.n_devices > 1:
            self._ctl = _Control(plan)
        self._mesh_gauges()

    def _mesh_gauges(self) -> None:
        """One-time mesh gauges (construction, cold path)."""
        axes = "x".join(f"{a}{s}" for a, s in self.plan.axes.items())
        safe_set("paddle_mesh_devices",
                 "devices in the serving engine's mesh",
                 self.plan.n_devices, axes=axes)
        safe_set("paddle_mesh_axes",
                 "named axes in the serving engine's mesh",
                 len(self.plan.axes), axes=axes)
        safe_set("paddle_tp_degree",
                 "tensor-parallel degree of the decode engine",
                 self.plan.tp_degree)

    @property
    def is_driver(self) -> bool:
        """True on rank 0 of a plan (and on every engine without one)."""
        return self._ctl is None or self._ctl.driver

    def follow(self) -> int:
        """A follower's loop (ranks > 0 of a plan): run each step rank 0
        broadcasts, in its order, until rank 0's :meth:`stop`. A
        ``ValueError`` (an unservable request) raised on rank 0 too, from
        the same checks on the same state before any collective, and rank 0
        failed that request alone: it is logged and the loop goes on. Any
        other exception may be this rank's alone (device memory, a CUDA or
        transport error) and leaves the step half run, so it propagates:
        this rank dies, and its closed connections fail rank 0's next
        collective at once. Returns the number of steps run."""
        ctl = self._ctl
        if ctl is None or ctl.driver:
            raise RuntimeError("follow() is for ranks > 0 of a plan")
        n = 0
        while True:
            name, args, kwargs = ctl.receive()
            if name == _STOP:
                return n
            ctl.depth += 1
            try:
                getattr(self, name)(*args, **kwargs)
            except ValueError as e:
                _log.warning("follower step %s raised ValueError: %s",
                             name, e)
            finally:
                ctl.depth -= 1
            n += 1

    def stop(self) -> None:
        """On rank 0 of a plan: release the followers (their
        :meth:`follow` returns). Idempotent; nothing to do without a
        plan."""
        ctl = self._ctl
        if ctl is not None and ctl.driver and not ctl.stopped:
            ctl.send(_STOP, (), {})
            ctl.stopped = True

    # -- KV observability ----------------------------------------------------
    def _kv_gauges(self, total: bool = False) -> None:
        """Pool occupancy gauges (reference :494-513), refreshed on the
        per-request host paths (admit / release), never per token."""
        if self.kv_layout != "paged":
            return
        if total:
            safe_set("paddle_serving_kv_pages_total",
                     "allocatable KV pages in the paged pool",
                     self.pool.usable)
        safe_set("paddle_serving_kv_pages_free",
                 "KV pages currently on the free list", self.pool.free_count)
        if self.kv_host is not None:
            safe_set("paddle_serving_kv_host_bytes",
                     "bytes of spilled prefix slabs resident in the "
                     "host-RAM tier", self.kv_host.used_bytes)
            safe_set("paddle_serving_kv_host_occupancy",
                     "host-tier bytes used over its byte budget "
                     "(the kv_host_tier_full alert input)",
                     round(self.kv_host.occupancy, 4))

    def _restore_percentile(self, q: float) -> Optional[float]:
        """p-th percentile of recent host-tier restore latencies (ms)."""
        if not self._restore_ms:
            return None
        xs = sorted(self._restore_ms)
        return round(xs[min(len(xs) - 1, int(q * len(xs)))], 3)

    def kv_stats(self) -> Dict[str, object]:
        """KV-pool snapshot: page accounting, bytes (int8 codes plus their
        scales under int8), prefix-cache hit data and the host tier's
        spill/restore counters (reference :522)."""
        cfg = self.cfg
        kvh, hd, nl = self._kvh, cfg.head_dim, cfg.num_hidden_layers
        quant = self.kv_quant == "int8"
        itemsize = 1 if quant else self._kv_dtype.itemsize
        per_tok = 2 * kvh * hd * itemsize * nl
        if self.kv_layout != "paged":
            return {"layout": "contiguous",
                    "kv_bytes": int(self.S * self.L * per_tok)}
        scale_bytes = 2 * kvh * 4 * nl if quant else 0
        page_bytes = int(self.page_size * per_tok + scale_bytes)
        pool, pfx = self.pool, self.prefix
        host = {"enabled": False}
        if self.kv_host is not None:
            host = dict(self.kv_host.stats(), enabled=True,
                        restore_ms_p50=self._restore_percentile(0.50),
                        restore_ms_p99=self._restore_percentile(0.99))
        return {
            "layout": "paged",
            "kv_quant": self.kv_quant or "off",
            "page_size": self.page_size,
            "pages_total": pool.usable,
            "pages_free": pool.free_count,
            "pages_used": pool.used,
            "pages_peak": pool.peak_used,
            "occupancy": round(pool.used / max(pool.usable, 1), 4),
            "page_bytes": page_bytes,
            "kv_bytes": int(pool.num_pages * page_bytes),
            "prefix": {
                "enabled": self.prefix_enabled,
                "entries": len(pfx),
                "cached_pages": pfx.cached_pages,
                "hits": pfx.hits,
                "misses": pfx.misses,
                "evictions": pfx.evictions,
            },
            "host": host,
        }

    # -- device pieces -------------------------------------------------------
    def _forward_paged(self, toks: torch.Tensor, lens: torch.Tensor):
        """One forward over ``toks [S, W]`` at per-slot positions
        ``lens..lens+W-1``: each layer scatters its W new K/V rows to their
        physical pages, then attends through the page table. Positions past
        ``max_len`` are redirected to the null page, and the page index is
        clamped to the table, as in the reference (decode_engine.py:671-680).
        Under int8 the rows are quantized into their pages first and the
        kernel's int8 variant attends (reference :780-803). W is 1 for a
        decode step and k+1 for a speculative verify. Device-only: nothing
        is read back, so the forward can be captured. Returns logits
        ``[S, W, V]``."""
        S, ps, P, L = self.S, self.page_size, self.P, self.L
        W = toks.shape[1]
        nh, kvh, hd = self._nh, self._kvh, self.cfg.head_dim
        rep, scale = nh // kvh, 1.0 / math.sqrt(hd)
        pos = lens.long()[:, None] + torch.arange(W, device=self.device)[None, :]
        page_idx = torch.clamp(pos // ps, max=P - 1)
        phys = torch.where(pos < L, self.page_table.gather(1, page_idx).long(),
                           0)
        off = pos % ps
        mdl = self.net.model
        x = mdl.embed_tokens(toks.long())
        # rope rows for this step's positions, shared by every layer
        c, s = rope_at(mdl.rope_cos, mdl.rope_sin, lens, W, x.dtype)
        for layer, (kc, vc) in zip(mdl.layers, self.caches):
            attn = layer.self_attn
            h_pre = layer.input_layernorm(x)
            q = attn.q_proj(h_pre).reshape(S, W, nh, hd)
            k = attn.k_proj(h_pre).reshape(S, W, kvh, hd)
            v = attn.v_proj(h_pre).reshape(S, W, kvh, hd)
            q, k = rotate(q, c, s), rotate(k, c, s)
            # write first, then attend: the causal rule admits this step's
            # own positions. In place, where the reference donated the pool
            if self.kv_quant == "int8":
                (kq, ksc), (vq, vsc) = kc, vc
                _kv_quant_scatter(kq, ksc, k.to(self._kv_dtype), phys, off)
                _kv_quant_scatter(vq, vsc, v.to(self._kv_dtype), phys, off)
                out = self._attend(q, kq, vq, self.page_table, lens, rep=rep,
                                   scale=scale, k_scale=ksc, v_scale=vsc)
            else:
                kc.index_put_((phys, off), k.to(kc.dtype))
                vc.index_put_((phys, off), v.to(vc.dtype))
                out = self._attend(q, kc, vc, self.page_table, lens, rep=rep,
                                   scale=scale)
            x = x + attn.o_proj(out.reshape(S, W, nh * hd))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        return self.net.logits(mdl.norm(x))

    def _forward_contiguous(self, toks: torch.Tensor,
                            lens: torch.Tensor) -> torch.Tensor:
        """The contiguous layout's step (reference ``_forward`` :648 at a
        per-slot ``pos``): the model's own cached attention writes each
        slot's new K/V at ``lens`` in place and attends over that slot's
        valid prefix. Device-only. Returns logits ``[S, W, V]``."""
        hidden, _ = self.net.model(toks.long(), caches=self.caches, pos=lens)
        return self.net.logits(hidden)

    def _sample(self, rows: torch.Tensor, temps: torch.Tensor,
                top_ks: torch.Tensor) -> torch.Tensor:
        """Per-slot sampling over f32 ``rows [n, V]``: temp <= 0 -> greedy
        (first argmax), else categorical at ``temp`` (Gumbel-max over the
        engine's generator), optionally restricted to the slot's top_k
        logits (k <= TOP_K_CAP)."""
        kcap = min(self.TOP_K_CAP, rows.shape[-1])
        topv = torch.topk(rows, kcap, dim=-1).values           # desc
        kth = topv.gather(1, (top_ks.long()[:, None] - 1).clamp(0, kcap - 1))
        rows = rows.masked_fill((top_ks[:, None] > 0) & (rows < kth),
                                float("-inf"))
        greedy = rows.argmax(dim=-1)
        u = torch.rand(rows.shape, generator=self.gen, device=rows.device)
        scaled = rows / temps[:, None].clamp_min(1e-6)
        sampled = (scaled - torch.log(-torch.log(u))).argmax(dim=-1)
        return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)

    def _set_slot_state(self, slot: int, plen: int, temp: float, eos: int,
                        budget: int, top_k: int, first: torch.Tensor) -> None:
        """Admission epilogue, every per-slot state element set on the
        device; the slot is born inactive when its first token ends it."""
        self.lens[slot] = plen
        self.tokens[slot] = first
        if budget <= 1:
            self.active[slot] = False
        elif eos >= 0:
            self.active[slot] = first != eos
        else:
            self.active[slot] = True
        self.temps[slot] = temp
        self.eos_ids[slot] = eos
        self.budgets[slot] = budget - 1
        self.top_ks[slot] = top_k

    def _admit_paged_impl(self, ids: np.ndarray, slot: int, temp: float,
                          eos: int, budget: int, top_k: int,
                          n_pfx: int = 0) -> torch.Tensor:
        """Prefill through scratch caches (plain attention), sample the
        first token, and write the K/V into this slot's private pages (the
        ones in ``_slot_pages[slot]``, already in its table row).

        ``n_pfx == 0``: prefill exactly the prompt's ``plen`` rows (reference
        :880-930). ``n_pfx > 0``, a prefix hit (``_admit_prefix_program``
        :932-1003): the ``n_pfx`` cached prefix pages are gathered into the
        scratch caches as read-only context (dequantized and cast to the KV
        dtype under int8, :957), only the tail is prefilled at
        ``pos=aligned``, and only the tail's rows are written. The written
        rows are padded with zeros over all the private pages, which under
        int8 equals the reference's ``valid`` mask and starts every decode
        page at scale 0."""
        dev = self.device
        plen = ids.shape[1]
        cfg = self.cfg
        kvh, hd, ps = self._kvh, cfg.head_dim, self.page_size
        dtype = self._kv_dtype
        quant = self.kv_quant == "int8"
        aligned = n_pfx * ps
        tail = plen - aligned
        ids_t = torch.as_tensor(ids[:, aligned:], dtype=torch.long).to(dev)
        pfx = self.page_table[slot, :n_pfx].long()
        scratch = []
        for kc, vc in self.caches:
            pair = []
            for c in (kc, vc):
                buf = torch.zeros((1, plen, kvh, hd), dtype=dtype, device=dev)
                if n_pfx:
                    buf[0, :aligned] = (
                        _kv_dequant_gather(c[0], c[1], pfx, dtype) if quant
                        else c[pfx]).reshape(aligned, kvh, hd)
                pair.append(buf)
            scratch.append(tuple(pair))
        hidden, scratch = self.net.model(ids_t, caches=scratch, pos=aligned)
        row = self.net.logits(hidden[:, tail - 1]).float()     # [1, V]
        first = self._sample(
            row, torch.full((1,), temp, dtype=torch.float32, device=dev),
            torch.full((1,), top_k, dtype=torch.int32, device=dev))[0]
        private = self._slot_pages[slot]
        npg = len(private)
        dest = torch.as_tensor(private, dtype=torch.long, device=dev)
        for (kc, vc), (ks, vs) in zip(self.caches, scratch):
            for c, rows in ((kc, ks), (vc, vs)):
                pages = torch.nn.functional.pad(
                    rows[0, aligned:], (0, 0, 0, 0, 0, npg * ps - tail)
                ).reshape(npg, ps, kvh, hd)
                if quant:
                    codes, scale = _kv_quant_pages(pages.float())
                    c[0][dest] = codes
                    c[1][dest] = scale
                else:
                    c[dest] = pages
        self._set_slot_state(slot, plen, temp, eos, budget, top_k, first)
        return first

    def _admit_contiguous_impl(self, ids: np.ndarray, slot: int, temp: float,
                               eos: int, budget: int,
                               top_k: int) -> torch.Tensor:
        """Contiguous admission (reference ``_admit_impl`` :853-878): the
        prompt padded to its 128 bucket (capped at ``max_len``) prefilled
        through a scratch cache, the first token sampled from row
        ``plen - 1``, and the bucket's K/V rows written into the slot. Rows
        past the prompt hold the padding's K/V; no query reads them before
        decode has written its own there."""
        dev = self.device
        plen = ids.shape[1]
        bucket = min(_bucket(plen), self.L)
        cfg = self.cfg
        kvh, hd = self._kvh, cfg.head_dim
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = ids[0]
        ids_t = torch.from_numpy(padded).to(dev)
        scratch = [(torch.zeros((1, bucket, kvh, hd), dtype=self._kv_dtype,
                                device=dev),
                    torch.zeros((1, bucket, kvh, hd), dtype=self._kv_dtype,
                                device=dev))
                   for _ in range(cfg.num_hidden_layers)]
        hidden, scratch = self.net.model(ids_t, caches=scratch, pos=0)
        row = self.net.logits(hidden[:, plen - 1]).float()     # [1, V]
        first = self._sample(
            row, torch.full((1,), temp, dtype=torch.float32, device=dev),
            torch.full((1,), top_k, dtype=torch.int32, device=dev))[0]
        for (kc, vc), (ks, vs) in zip(self.caches, scratch):
            kc[slot, :bucket] = ks[0]
            vc[slot, :bucket] = vs[0]
        self._set_slot_state(slot, plen, temp, eos, budget, top_k, first)
        return first

    # -- host orchestration --------------------------------------------------
    def _prefix_plan(self, req, ids: np.ndarray, plen: int):
        """(aligned, n_pfx, hash, entry) for a request's declared shared
        prefix (reference :1356): only FULL pages are shared, and at least
        one tail token must remain so the first sample has logits to read."""
        pfx_len = int(getattr(req, "prefix_len", 0) or 0)
        if not self.prefix_enabled or pfx_len <= 0:
            return 0, 0, None, None
        if pfx_len > plen:
            raise ValueError(
                f"prefix_len {pfx_len} exceeds the prompt length {plen}")
        ps = self.page_size
        aligned = (pfx_len // ps) * ps
        if aligned == plen:
            aligned -= ps            # keep >= 1 tail token to sample from
        if aligned < ps:
            return 0, 0, None, None  # too short to share a full page
        h = prefix_hash(ids, aligned)
        return aligned, aligned // ps, h, self.prefix.lookup(h)

    def _reserve_pages(self, plen: int, budget: int, n_pfx_cached: int = 0,
                       exclude: Optional[str] = None) -> Optional[List[int]]:
        """Allocate the request's private pages: its full prompt + budget
        minus the cached prefix pages it hits (reference :1377). None when
        the pool cannot satisfy it right now (the caller waits for
        retirements); :class:`KVCapacityError` when it never could, judged
        on the TOTAL need. Refcount-0 prefixes are evicted LRU-first when
        the free list runs dry, spilling to the host tier when there is
        one; ``exclude`` protects the entry this request is about to hit."""
        total = pages_needed(plen + budget, self.page_size)
        need = total - n_pfx_cached
        if total > self.pool.usable:
            raise KVCapacityError(
                f"prompt {plen} + {budget} new tokens needs {total} KV "
                f"pages (page_size {self.page_size}) but the pool holds "
                f"only {self.pool.usable} even when empty — raise "
                "num_pages or shorten the request", pages_needed=total,
                pages_capacity=self.pool.usable)
        if self.pool.free_count < need:
            spill = self._spill_prefix if self.kv_host is not None else None
            evicted = self.prefix.evict_until(self.pool, need,
                                              exclude=exclude, spill=spill)
            if evicted:
                safe_inc("paddle_serving_kv_prefix_evictions_total",
                         "prefix-cache entries LRU-evicted for pages",
                         evicted)
            if self.pool.free_count < need:
                return None
        return self.pool.alloc(need)

    # -- host-RAM prefix tier (reference :1411-1498) --------------------------
    def _slab_meta(self) -> Dict[str, object]:
        """The engine facts a slab must match to be restored: a mismatch
        (another geometry, quant mode or dtype) is a logged miss, never
        wrong KV."""
        cfg = self.cfg
        return {"page_size": self.page_size,
                "kvh": self._kvh, "hd": cfg.head_dim,
                "layers": cfg.num_hidden_layers,
                "kv_quant": self.kv_quant or "off",
                "dtype": str(self._kv_dtype).replace("torch.", "")}

    def _pool_tensors(self, kc, vc) -> List[torch.Tensor]:
        """One layer's pool tensors in slab order: K, V or, under int8,
        K codes, K scale, V codes, V scale."""
        if self.kv_quant == "int8":
            return [kc[0], kc[1], vc[0], vc[1]]
        return [kc, vc]

    def _spill_prefix(self, h: str, entry) -> bool:
        """``evict_until``'s spill callback: serialize the entry's live
        device pages (and scales) into a slab and hand it to the host tier,
        BEFORE the pages return to the free list. False (the tier refused
        a slab larger than its whole budget) makes it a true discard."""
        idx = torch.as_tensor(entry.pages, dtype=torch.long,
                              device=self.device)
        arrays = [t[idx] for kc, vc in self.caches
                  for t in self._pool_tensors(kc, vc)]
        meta = dict(self._slab_meta(), length=int(entry.length),
                    n_pages=len(entry.pages))
        blob = serialize_page_slab(meta, arrays)
        slab = HostSlab(blob, entry.length, len(entry.pages),
                        entry.last_used)
        ok = self.kv_host.put(h, slab)
        if ok:
            safe_inc("paddle_serving_kv_prefix_spills_total",
                     "prefix entries spilled to the host-RAM tier instead "
                     "of discarded")
            _flight.record("kv", "prefix_spill", hash=h[:16],
                           pages=len(entry.pages), bytes=len(blob))
        return ok

    def _restore_prefix(self, h: str, slab: HostSlab,
                        pfx_pages: List[int]) -> bool:
        """Write a popped slab into freshly reserved device pages and
        re-register the prefix at refcount 0 (the hit about to run takes
        the slot's ref). False on any mismatch or corruption, checked
        before any page is written: the caller serves a full-prefill miss."""
        try:
            meta, arrays = deserialize_page_slab(slab.blob)
            want = dict(self._slab_meta(), length=meta.get("length"),
                        n_pages=len(pfx_pages))
            if meta != want:
                raise ValueError(f"slab/engine mismatch: {meta} != {want}")
            targets = [t for kc, vc in self.caches
                       for t in self._pool_tensors(kc, vc)]
            if len(arrays) != len(targets):
                raise ValueError(f"slab holds {len(arrays)} arrays, the "
                                 f"engine {len(targets)}")
            for a, t in zip(arrays, targets):
                if a.dtype != t.dtype or \
                        tuple(a.shape) != (len(pfx_pages),) + tuple(t.shape[1:]):
                    raise ValueError(f"slab array {a.dtype} {list(a.shape)} "
                                     f"does not fit pool {t.dtype} "
                                     f"{list(t.shape)}")
            idx = torch.as_tensor(pfx_pages, dtype=torch.long,
                                  device=self.device)
            for a, t in zip(arrays, targets):
                t[idx] = a.to(self.device)
            entry = self.prefix.register(h, pfx_pages, int(meta["length"]))
            entry.refcount = 0
            safe_inc("paddle_serving_kv_prefix_restores_total",
                     "prefix entries restored from the host tier into "
                     "device pages")
            _flight.record("kv", "prefix_restore", hash=h[:16],
                           pages=len(pfx_pages), bytes=len(slab.blob))
            return True
        except Exception as e:  # noqa: BLE001 — any bad slab is a miss
            self.stats["restore_failures"] += 1
            _log.warning("host-tier slab %s failed to restore (%s: %s); "
                         "serving the request as a full-prefill miss",
                         h[:16], type(e).__name__, e)
            safe_inc("paddle_serving_kv_host_restore_failures_total",
                     "host-tier slabs that failed validation/restore "
                     "(request served as a miss)", reason=type(e).__name__)
            return False

    @_led
    @torch.no_grad()
    def _admit(self, req) -> bool:
        """Prefill ``req`` into a free slot; False when no slot (or no
        pages) is free. A declared prefix is a hit (tail-only prefill), a
        restore from the host tier followed by a hit, or a miss that
        registers it (reference :1529-1640)."""
        free = [i for i, s in enumerate(self._host_slots) if s.req is None]
        if not free:
            return False
        slot = free[0]
        ids = np.asarray(req.prompt_ids, np.int32).reshape(1, -1)
        plen = ids.shape[1]
        if plen + req.max_new_tokens > self.L:
            raise ValueError(
                f"prompt {plen} + {req.max_new_tokens} new tokens exceeds "
                f"engine max_len {self.L}")
        temp = float(getattr(req, "temperature", 0.0) or 0.0)
        eos = getattr(req, "eos_token_id", None)
        top_k = int(getattr(req, "top_k", 0) or 0)
        if top_k > self.TOP_K_CAP:
            raise ValueError(
                f"top_k {top_k} exceeds the continuous engine's filter cap "
                f"{self.TOP_K_CAP}")
        if self.spec is not None and temp > 0.0:
            raise ValueError(
                f"temperature {temp:g} with speculative decoding armed: "
                "greedy acceptance is token-exact for temperature 0 only "
                "(sampling-correct rejection resampling is a planned seam) "
                "— send temperature=0 or serve without spec_k")
        eos_i = -1 if eos is None else int(eos)
        budget = int(req.max_new_tokens)
        bucket = min(_bucket(plen), self.L)
        if self.kv_layout != "paged":
            first = self._run_admission(
                _cp.admit_key(bucket),
                lambda: self._admit_contiguous_impl(ids, slot, temp, eos_i,
                                                    budget, top_k))
            return self._admitted(req, slot, first, bucket, plen)
        aligned, n_pfx, h, entry = self._prefix_plan(req, ids, plen)
        hit = entry is not None
        restored = False
        slab = None
        if not hit and h is not None and self.kv_host is not None:
            # device miss with a spilled copy: pop the slab BEFORE reserving
            # (the reservation's own spills could push it over the host
            # budget's LRU edge); from here it is restored or put back
            slab = self.kv_host.pop(h)
        try:
            private = self._reserve_pages(
                plen, req.max_new_tokens, n_pfx if hit else 0,
                exclude=h if hit else None)
        except BaseException:
            if slab is not None:
                self.kv_host.put_back(h, slab)
            raise
        if private is None:
            if slab is not None:
                self.kv_host.put_back(h, slab)
            return False              # pool dry: decode frees pages later
        if slab is not None:
            # the no-prefix reservation covers prompt + budget in full: its
            # first n_pfx pages become the restored prefix, the rest stay
            # private, exactly a hit's split
            t0 = time.perf_counter()
            if self._restore_prefix(h, slab, private[:n_pfx]):
                entry = self.prefix.lookup(h)
                hit = restored = True
                private = private[n_pfx:]
                self._restore_ms.append((time.perf_counter() - t0) * 1e3)
                del self._restore_ms[:-512]
        pages_reserved = len(private)
        self._slot_pages[slot] = private
        row = np.zeros((self.P,), np.int32)
        if hit:
            # safe: the reservation excluded this entry from eviction
            self.prefix.ref(h)
            row[:n_pfx] = entry.pages
            row[n_pfx:n_pfx + len(private)] = private
            self._slot_prefix[slot] = h
            safe_inc("paddle_serving_kv_prefix_hits_total",
                     "prefix-cache hits (prefill work skipped)")
        else:
            row[:len(private)] = private
        self.page_table[slot] = torch.from_numpy(row).to(self.device)
        self._kv_gauges()
        if hit:
            tail = plen - aligned
            tail_bucket = min(_bucket(tail),
                              self.cfg.max_position_embeddings - aligned,
                              self.P * self.page_size - aligned)
            key = _cp.prefix_admit_key(n_pfx, tail_bucket)
        else:
            key = _cp.admit_key(bucket)
        try:
            first = self._run_admission(
                key, lambda: self._admit_paged_impl(
                    ids, slot, temp, eos_i, budget, top_k,
                    n_pfx if hit else 0))
        except BaseException:
            # the reservation must not outlive a failed admission
            self._release_kv(slot)
            raise
        if h is not None and not hit:
            # MISS with a declared prefix: the full prefill just wrote the
            # prefix pages; pin them shared (this slot holds the first ref)
            # and keep only the tail and decode pages private
            self.prefix.register(h, private[:n_pfx], aligned)
            self.prefix.misses += 1
            self._slot_pages[slot] = private[n_pfx:]
            self._slot_prefix[slot] = h
        if self.spec is not None:
            # the draft keeps no prefix cache: it prefills the FULL prompt
            # on every admission, hit or miss (reference :1641-1660)
            try:
                self.spec.draft_admit(ids, slot)
            except BaseException:
                # the target's admission already committed: deactivate the
                # lane and return the pages, or the reservation leaks
                self.reset_slots([slot])
                raise
            self._warmed.add(_cp.draft_admit_key(bucket))
        prefix = None
        if h is not None:
            prefix = {"prefix": ("restore" if restored
                                 else "hit" if entry is not None else "miss"),
                      "prefix_pages": n_pfx}
        return self._admitted(req, slot, first, bucket, plen,
                              pages=pages_reserved, prefix=prefix)

    def _run_admission(self, key: str, impl) -> torch.Tensor:
        """Run one admission ``impl()`` for plan key ``key``; with the perf
        plane armed, the first admission at each key is counted as the
        ``serving.admit`` program's cost (reference :1605-1616)."""
        if _perf.enabled() and key not in self._costed:
            self._costed.add(key)
            kind, info = _cp.parse_key(key)
            bucket = (f"pfx{info['n_pfx']}t{info['tail_bucket']}"
                      if kind == "prefix" else f"p{info['bucket']}")
            with _perf.counting("serving.admit", bucket=bucket,
                                quant=self.quant or "off"):
                first = impl()
        else:
            first = impl()
        # only after it succeeded: a failed first admission must not mask
        # the key from a later warmup()
        self._warmed.add(key)
        return first

    def _admitted(self, req, slot: int, first: torch.Tensor, bucket: int,
                  plen: int, pages: Optional[int] = None,
                  prefix: Optional[Dict[str, object]] = None) -> bool:
        """Host bookkeeping of an admission that succeeded, its journey
        spans (reference :1664-1688) and its flight-recorder event."""
        self._host_slots[slot] = _Slot(req, budget=int(req.max_new_tokens))
        self.stats["peak_busy"] = max(self.stats["peak_busy"],
                                      self.busy_slots())
        _stamp(req, "_t_admit")
        tr = _trace_of(req)
        if tr is not None:
            res = req.result
            tr.event("queue.wait", t0=res._t_submit, t1=res._t_admit)
            tr.event("admit", slot=slot, bucket=bucket, plen=plen,
                     **({} if pages is None else {"pages": pages}),
                     **(prefix or {}))
            if self.spec is not None:
                tr.event("spec.draft_prefill", bucket=bucket)
        _flight.record("request", str(getattr(req, "id", "?")),
                       phase="admit", slot=slot, bucket=bucket, plen=plen,
                       **({} if prefix is None else
                          {"prefix_hit": prefix["prefix"] != "miss"}))
        self._first_pending[slot] = first   # device scalar, synced at collect
        self.stats["requests"] += 1
        return True

    def _release_kv(self, slot: int, zero_row: bool = True) -> None:
        """Return a slot's private pages to the free list, drop its prefix
        ref, and (by default) zero its page-table row so later decode
        writes land in the null page. Idempotent; nothing to return under
        the contiguous layout."""
        if self.kv_layout != "paged":
            return
        pages = self._slot_pages[slot]
        if pages:
            self.pool.free(pages)
            self._slot_pages[slot] = []
        h = self._slot_prefix[slot]
        if h is not None:
            self.prefix.unref(h)
            self._slot_prefix[slot] = None
        if zero_row:
            self.page_table[slot] = 0
        self._kv_gauges()

    def _retire(self, slot: int) -> None:
        s = self._host_slots[slot]
        if s.req is not None:
            prompt = np.asarray(s.req.prompt_ids, np.int32).reshape(-1)
            gen = s.emitted[: s.budget]
            eos = getattr(s.req, "eos_token_id", None)
            if eos is not None and eos in gen:
                gen = gen[: gen.index(eos) + 1]   # trim past eos, keep it
            res = getattr(s.req, "result", None)
            if res is not None and getattr(res, "_event", None) is not None \
                    and res._event.is_set():
                # a client cancel raced this retirement: nobody receives
                # these tokens, so they all count as the cancel's kind
                _goodput.account(getattr(res, "_cancel_kind", "cancel"),
                         len(s.emitted))
            else:
                _goodput.account("useful", len(gen))
                # emitted past eos / budget and trimmed here
                _goodput.account("overshoot", len(s.emitted) - len(gen))
            _stamp(s.req, "_n_new", len(gen))
            if self.spec is not None:
                # per-request tokens per target step for slo() consumers
                _stamp(s.req, "_spec_steps", s.spec_steps)
                _stamp(s.req, "_spec_accepted", s.spec_accepted)
            s.req.result._set(output=np.concatenate(
                [prompt, np.asarray(gen, np.int32)]))
        self._release_kv(slot)
        self._host_slots[slot] = _Slot()

    def _collect_firsts(self) -> List[int]:
        """ONE host sync for every first token admitted since the last
        collect; stamps each request's first-token time. Returns the slots
        stamped by THIS collect (the spec chunk counts the tokens that
        landed at the same sync)."""
        if not self._first_pending:
            return []
        slots = sorted(self._first_pending)
        vals = torch.stack([self._first_pending[i] for i in slots]).cpu()
        now = time.perf_counter()
        stamped = []
        for i, slot in enumerate(slots):
            s = self._host_slots[slot]
            if s.req is not None:
                s.emitted.append(int(vals[i]))
                self.stats["tokens_out"] += 1
                if getattr(s.req.result, "_t_first", 1) is None:
                    _stamp(s.req, "_t_first", now)
                    stamped.append(slot)
                    tr = _trace_of(s.req)
                    if tr is not None:
                        tr.event("first_token", t0=now)
        self._first_pending.clear()
        return stamped

    @_led
    def reset_slots(self, slots=None) -> None:
        """Deactivate device-side slot state (all slots, or the given list)
        and return their pages — required after a failed decode or a stop,
        or retired rows keep computing as phantom active lanes. Everything
        is written in place, so a captured program replays over it. A
        reset slot's draft rows and ``prev`` are left as they are: its
        proposals are masked while it is inactive, and the next admission
        prefills them again."""
        if slots is None:
            self.active.zero_()
            self._first_pending.clear()
            for i in range(self.S):
                self._release_kv(i, zero_row=False)
            if self.page_table is not None:
                self.page_table.zero_()
        else:
            for i in slots:
                self.active[int(i)] = False
                self._first_pending.pop(int(i), None)
                self._release_kv(int(i))

    @_led
    def release_slot(self, slot: int, reason: str = "cancel") -> None:
        """Free one slot without delivering a result: the cancellation and
        deadline path (reference :1792). The device lane goes inactive, in
        place, so a captured chunk replays over the same storage; the
        pages return; the caller owns failing the request's future.
        ``reason`` names the goodput kind the slot's decoded tokens are
        wasted as."""
        s = self._host_slots[int(slot)]
        if s.req is not None:
            _goodput.account(reason, len(s.emitted))
        self.reset_slots([slot])
        self._host_slots[int(slot)] = _Slot()

    def busy_slots(self) -> int:
        return sum(1 for s in self._host_slots if s.req is not None)

    # -- device programs and their registry (reference :1066-1106) ----------
    def _decode_body(self) -> None:
        """``chunk`` decode steps over all slots with per-slot eos and
        budget countdown, device-only: reads the static slot buffers,
        updates ``tokens``, ``lens``, ``active`` and ``budgets`` in place
        and writes ``packed [slots, chunk+1]`` (tokens, -1 where idle; last
        column = active). Nothing is read back to the host, so the body can
        be captured; the CPU runs it directly."""
        tokens, lens, active, budgets = (self.tokens, self.lens, self.active,
                                         self.budgets)
        temps, top_ks, eos_ids = self.temps, self.top_ks, self.eos_ids
        step = (self._forward_paged if self.kv_layout == "paged"
                else self._forward_contiguous)
        for t in range(self.chunk):
            rows = step(tokens[:, None], lens)[:, 0].float()
            nxt = self._sample(rows, temps, top_ks)
            nxt = torch.where(active, nxt, tokens)     # frozen when inactive
            live = active.to(torch.int32)
            self.packed[:, t].copy_(torch.where(active, nxt, -1))
            lens.add_(live)
            budgets.sub_(live)
            active.logical_and_(~((eos_ids >= 0) & (nxt == eos_ids))
                                & (budgets > 0))
            tokens.copy_(nxt)
        self.packed[:, self.chunk].copy_(active)

    def _build_program(self, key: str):
        """The program for one registry key: its device-only body on the
        CPU, the body captured as a CUDA graph on the card."""
        k = self.spec.k if self.spec is not None else None
        gens = ()
        if key == self._decode_key:
            body, gens = self._decode_body, (self.gen,)
        elif k is not None and key == f"draft_k{k}":
            body = self.spec.draft_body
        elif k is not None and key == f"verify_k{k}":
            body = self.spec.verify_body
        else:
            raise ValueError(f"unrecognized program key {key!r} (decode, "
                             "decode_contig under kv_layout='contiguous', or "
                             "draft_k<k> / verify_k<k> with spec_k=k armed)")
        if self.device.type != "cuda" or self._eager_reason() is not None:
            return body
        return _CapturedProgram(key, body, self.device, self._graph_pool,
                                generators=gens)

    def _eager_reason(self) -> Optional[str]:
        """Why the programs run eagerly on the card: a plan whose groups
        cannot be captured (gloo), decided by the backend, never by a
        failed capture. None when they are captured."""
        if self.plan is not None and not self.plan.capturable():
            return (f"the plan's collectives run over "
                    f"{self.plan.backend()}, which a CUDA graph cannot "
                    "capture; the chunk runs eagerly (the kernels run "
                    "either way)")
        return None

    def _program(self, key: str):
        """Registry lookup with a lazy build, shared by the decode and the
        speculative chunks and warmup."""
        fn = self._programs.get(key)
        if fn is None:
            fn = self._build_program(key)
            self._programs[key] = fn
        return fn

    def _cost_label(self, key: str):
        """(program, bucket, meta) under which the perf plane records the
        cost of one call of ``key``; None for the speculative programs,
        which the reference does not cost either."""
        if key != self._decode_key:
            return None
        bucket = (f"s{self.S}c{self.chunk}"
                  + ("-fused" if self.fused.get("enabled") else ""))
        return ("serving.decode", bucket,
                {"quant": self.quant or "off", "slots": self.S,
                 "chunk": self.chunk,
                 "fused": self.fused.get("paged_attention", "off")})

    def _cost_window(self, key: str):
        """A context factory counting one execution of ``key`` as its
        program cost (the perf plane, armed, first time only), or None."""
        label = self._cost_label(key)
        if label is None or not _perf.enabled() or key in self._costed:
            return None
        self._costed.add(key)
        name, bucket, meta = label
        return lambda: _perf.counting(name, bucket, **meta)

    def _call_program(self, key: str) -> bool:
        """Run program ``key`` once: a replay, or the first call's eager run
        and capture (on the CPU, the body). With the perf plane armed the
        first eager execution of the decode program is counted. Returns
        whether this call captured the program."""
        fn = self._program(key)
        captured = isinstance(fn, _CapturedProgram) and fn.graph is None
        window = (self._cost_window(key)
                  if captured or not isinstance(fn, _CapturedProgram)
                  else None)
        if isinstance(fn, _CapturedProgram):
            fn.count_ctx = window
            fn()
            fn.count_ctx = None
        else:
            with window() if window is not None else contextlib.nullcontext():
                fn()
        self._warmed.add(_cp.decode_key() if key == self._decode_key
                         else key)
        return captured

    def capture_info(self) -> Dict[str, object]:
        """Per captured program: capture seconds, graph-pool bytes, replays
        and the kernel launches one replay makes (empty on the CPU). On the
        card under a gloo plan each program reads ``{"captured": False,
        "mode": "eager", "reason": ...}``."""
        reason = (self._eager_reason() if self.device.type == "cuda"
                  else None)
        out = {}
        for key, fn in self._programs.items():
            if isinstance(fn, _CapturedProgram):
                out[key] = fn.info()
            elif reason is not None:
                out[key] = {"captured": False, "mode": "eager",
                            "reason": reason}
        return out

    # -- compile plan: warmup and bundles (reference :1184-1354) ------------
    @_led
    def warmup(self, keys: Optional[List[str]] = None) -> Dict[str, object]:
        """Do now what the first requests would otherwise pay for, so the
        serve window after it builds and captures nothing: build the kernel
        libraries the plan launches (on the card; loaded from the bundle
        where one was loaded), capture each captured program of ``keys``
        (default: the whole plan) without serving a chunk, and run one
        throwaway admission per ``admit_p<b>`` / ``draft_admit_p<b>``
        bucket into a free slot. A throwaway admission's pages return, its
        slot is left as it was, and the sampling generator is restored, so
        a warmed engine serves the tokens a cold one would. Idempotent per
        key; needs an idle engine. Returns the summary also kept in
        ``compile_info()["warmup"]``, with its wall split into
        ``build_s``, ``capture_s`` and ``admit_s``."""
        if keys is None:
            keys = self.compile_plan.keys()
        if self.busy_slots():
            raise RuntimeError("warmup() needs an idle engine (no request "
                               "in a decode slot)")
        t0 = time.perf_counter()
        done = skipped = 0
        times = {"build_s": 0.0, "capture_s": 0.0, "admit_s": 0.0}
        with _watchdog.expected_compiles("warmup"):
            libs = self.compile_plan.libraries
            if libs:
                tb = time.perf_counter()
                _build.build_all(libs)
                times["build_s"] = time.perf_counter() - tb
            # admissions first: the generator is not yet registered with a
            # graph on a fresh engine when they save and restore its state
            admits, captures = [], []
            for key in keys:
                kind, info = _cp.parse_key(key)
                if key in self._warmed:
                    skipped += 1
                elif kind in ("admit", "draft_admit"):
                    admits.append((key, kind, info["bucket"]))
                else:
                    captures.append((key, kind))
            ta = time.perf_counter()
            done += self._warm_admissions(admits)
            times["admit_s"] = time.perf_counter() - ta
            for key, kind in captures:
                if kind in ("decode", "draft", "verify"):
                    tc = time.perf_counter()
                    prog = self._program(self._decode_key if kind == "decode"
                                         else key)
                    if isinstance(prog, _CapturedProgram) \
                            and prog.graph is None:
                        prog.count_ctx = self._cost_window(prog.key)
                        prog.capture()
                        prog.count_ctx = None
                    times["capture_s"] += time.perf_counter() - tc
                    self._warmed.add(key)
                    done += 1
                else:
                    raise ValueError(f"warmup: {key!r} is traffic-shaped "
                                     "(prefix hits), not a plan key")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm_info = {
            "programs": len(keys),
            "compiled": done,
            "skipped": skipped,
            "wall_s": round(time.perf_counter() - t0, 3),
            **{k: round(v, 3) for k, v in times.items()},
        }
        safe_set("paddle_serving_warmup_seconds",
                 "wall seconds the last engine warmup spent compiling",
                 self._warm_info["wall_s"])
        safe_set("paddle_serving_warmup_programs",
                 "programs compiled by the last engine warmup", done)
        _flight.record("compile", "warmup", **self._warm_info)
        return dict(self._warm_info)

    @torch.no_grad()
    def _warm_admissions(self, admits) -> int:
        """One throwaway admission (and draft prefill) per bucket, each into
        the first free slot: a prompt of ``min(bucket, max_len - 1)`` ones
        with a budget of one token. Pages, the slot's device state and the
        generator are restored; host bookkeeping is not touched. With the
        perf plane armed, each target admission is counted as its bucket's
        ``serving.admit`` cost, as the reference's warmup captures it."""
        if not admits:
            return 0
        slot = next(i for i, s in enumerate(self._host_slots)
                    if s.req is None)
        state = self.gen.get_state()
        n = 0
        try:
            for key, kind, bucket in admits:
                plen = max(1, min(bucket, self.L - 1))
                ids = np.ones((1, plen), np.int32)
                if kind == "draft_admit":
                    self.spec.draft_admit(ids, slot)
                elif self.kv_layout != "paged":
                    self._run_admission(key, lambda: (
                        self._admit_contiguous_impl(ids, slot, 0.0, -1, 1,
                                                    0)))
                else:
                    private = self._reserve_pages(plen, 1)
                    if private is None:
                        raise RuntimeError(
                            f"warmup: no free pages for a {plen}-token "
                            "admission")
                    self._slot_pages[slot] = private
                    row = np.zeros((self.P,), np.int32)
                    row[:len(private)] = private
                    self.page_table[slot] = torch.from_numpy(row).to(
                        self.device)
                    try:
                        self._run_admission(key, lambda: (
                            self._admit_paged_impl(ids, slot, 0.0, -1, 1,
                                                   0)))
                    finally:
                        self._release_kv(slot)
                self._warmed.add(key)
                n += 1
        finally:
            self.active[slot] = False
            self.gen.set_state(state)
        return n

    def save_serving_bundle(self, path: str,
                            keys: Optional[List[str]] = None
                            ) -> Dict[str, object]:
        """Write this engine's bundle to ``path`` (:func:`.compile_plan.
        save_bundle`: the manifest and the kernel libraries the plan
        launches). An engine built with ``bundle=path`` on a fresh host
        then loads the libraries instead of building them."""
        with _watchdog.expected_compiles("bundle_save"):
            manifest = _cp.save_bundle(self, path, keys=keys)
        _flight.record("compile", "bundle_save", path=str(path),
                       libraries=len(manifest["libraries"]),
                       wall_s=manifest.get("save_wall_s"))
        return manifest

    def load_serving_bundle(self, path: str, strict: bool = False) -> bool:
        """Load a bundle (the constructor's ``bundle=`` path). Non-strict:
        any mismatch or corruption writes one stderr line, bumps
        ``paddle_serving_bundle_fallbacks_total``, records the reason in
        ``compile_info()["bundle"]`` and leaves the engine to build its
        libraries as usual."""
        try:
            manifest = _cp.load_bundle(self, path)
        except Exception as e:
            if strict:
                raise
            sys.stderr.write(
                f"[serving] bundle {path} not loaded "
                f"({type(e).__name__}: {e}); building the kernel libraries "
                "as usual\n")
            safe_inc("paddle_serving_bundle_fallbacks_total",
                     "serving bundles rejected at load (engine fell back "
                     "to compiling)", reason=type(e).__name__)
            self._bundle_info = {"loaded": False, "path": str(path),
                                 "error": f"{type(e).__name__}: {e}"}
            _flight.record("compile", "bundle_fallback", path=str(path),
                           error=f"{type(e).__name__}: {str(e)[:200]}")
            return False
        self._bundle_info = {
            "loaded": True,
            "path": str(path),
            "programs": len(manifest.get("keys", [])),
            "libraries": [lib["file"] for lib in manifest.get("libraries",
                                                              [])],
            "fingerprint": str(manifest.get("fingerprint"))[:16],
            "version": manifest.get("version"),
        }
        safe_set("paddle_serving_bundle_loaded",
                 "an AOT serving bundle is live in this engine (1 = yes)", 1)
        safe_set("paddle_serving_bundle_programs",
                 "programs loaded from the serving bundle",
                 self._bundle_info["programs"])
        _flight.record("compile", "bundle_load", path=str(path),
                       programs=self._bundle_info["programs"])
        return True

    def compile_info(self) -> Dict[str, object]:
        """``health()["compile"]`` (reference :1338): the plan's size and
        fingerprint, how many programs are built (captured programs in the
        registry) and warm (plan keys whose first capture or admission has
        run), the warmup summary, the bundle status, and the captures."""
        plan = self.compile_plan
        return {
            "plan": {"entries": len(plan.entries),
                     "fingerprint": plan.fingerprint()[:16]},
            "programs_built": len(self._programs),
            "programs_warmed": len(self._warmed),
            "warmup": self._warm_info,
            "bundle": self._bundle_info or {"loaded": False},
            "captured": self.capture_info(),
        }

    # -- host loop -----------------------------------------------------------
    @_led
    @torch.no_grad()
    def _decode_chunk(self) -> None:
        """One decode chunk: the ``"decode"`` (``"decode_contig"``)
        program (a graph replay on the card), then ONE readback of the
        packed ``[slots, chunk+1]`` payload, then the host's emit / retire
        bookkeeping and each request's ``decode.chunk`` span. With
        speculative decoding armed, the spec chunk instead."""
        if self.spec is not None:
            return self._spec_chunk()
        # first tokens of this cycle's admissions reach the host before the
        # chunk is queued, so time-to-first-token excludes the chunk
        self._collect_firsts()
        t0 = time.perf_counter()
        captured = self._call_program(self._decode_key)
        pk = self.packed.cpu().numpy()                 # the ONE sync per chunk
        t_sync = time.perf_counter()
        self.chunk_ms.append((t_sync - t0) * 1e3)
        del self.chunk_ms[:-512]
        if _perf.enabled() and not captured:
            label = self._cost_label(self._decode_key)
            _perf.observe(label[0], t_sync - t0, bucket=label[1])
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += self.chunk
        em, act = pk[:, :-1], pk[:, -1].astype(bool)
        for slot, s in enumerate(self._host_slots):
            if s.req is None:
                continue
            toks = [int(t) for t in em[slot] if t >= 0]
            s.emitted.extend(toks)
            self.stats["tokens_out"] += len(toks)
            tr = _trace_of(s.req)
            if tr is not None and toks:
                tr.event("decode.chunk", t0=t0, t1=t_sync, tokens=len(toks))
            if not act[slot] or len(s.emitted) >= s.budget:
                self._retire(slot)

    def _spec_chunk(self) -> None:
        """The speculative chunk (reference :1808-1872): per outer step ONE
        draft program (k greedy proposals) and ONE verify program (the W =
        k+1 target forward and the masked accept/reject), each a graph
        replay on the card; the steps' payloads sync to the host as a
        single transfer. As in the reference, the admissions' first tokens
        are collected after the chunk is queued, at the same sync as its
        tokens, and ``_n_at_first`` records how many arrived together, so
        TPOT divides by the tokens that arrived after the first. Rejected
        proposals are wasted draft work (goodput ``spec_rejected``)."""
        spec = self.spec
        k = spec.k
        steps = self._spec_steps_per_chunk
        t0 = time.perf_counter()
        dkey, vkey = _cp.draft_key(k), _cp.verify_key(k)
        for t in range(steps):
            self._call_program(dkey)
            self._call_program(vkey)
            self._spec_packed[:, t].copy_(spec.payload)
        stamped = self._collect_firsts()
        pk = self._spec_packed.cpu().numpy()           # the ONE chunk sync
        self.chunk_ms.append((time.perf_counter() - t0) * 1e3)
        del self.chunk_ms[:-512]
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += steps
        em = pk[:, :, : k + 1]               # emitted tokens, -1 padded
        acc = pk[:, :, k + 1]                # raw accepted-run lengths
        act = pk[:, -1, k + 2].astype(bool)
        chunk_emitted = 0
        for slot, s in enumerate(self._host_slots):
            if s.req is None:
                continue
            toks = [int(t) for t in em[slot].ravel() if t >= 0]
            s.emitted.extend(toks)
            chunk_emitted += len(toks)
            self.stats["tokens_out"] += len(toks)
            summary = spec.round_summary(acc[slot])
            s.spec_steps += summary["steps"]
            s.spec_accepted += summary["accepted"]
            _goodput.account("spec_rejected",
                     summary["proposed"] - summary["accepted"])
            tr = _trace_of(s.req)
            if tr is not None and summary["steps"]:
                tr.event("spec.round", t0=t0, t1=time.perf_counter(),
                         tokens=len(toks), **summary)
            if slot in stamped and toks:
                _stamp(s.req, "_n_at_first", 1 + len(toks))
            if not act[slot] or len(s.emitted) >= s.budget:
                self._retire(slot)
        spec.record_chunk(acc, chunk_emitted)

    @_led
    def flush(self) -> None:
        """Deliver results for slots that finished at admission (first
        token hit eos / budget 1) without waiting for a decode chunk."""
        self._collect_firsts()
        act = self.active.cpu().numpy()
        for slot, s in enumerate(self._host_slots):
            if s.req is not None and (not act[slot]
                                      or len(s.emitted) >= s.budget):
                self._retire(slot)

    def serve(self, requests, timeout: float = 600.0) -> Dict[str, object]:
        """Run GenerationRequest-shaped objects to completion with
        continuous batching. Returns aggregate stats."""
        pending = list(requests)
        t0 = time.perf_counter()
        n_out0 = self.stats["tokens_out"]
        deadline = t0 + timeout
        while (pending or self.busy_slots()) and time.perf_counter() < deadline:
            while pending:
                try:
                    if not self._admit(pending[0]):
                        break                  # no slot/pages free: decode
                except ValueError as e:
                    # unservable request (max_len / top_k / KV capacity):
                    # fail ITS future and keep serving the rest
                    pending[0].result._set(error=e)
                pending.pop(0)
            if self.busy_slots():
                self._decode_chunk()
        self.flush()
        dt = time.perf_counter() - t0
        toks = self.stats["tokens_out"] - n_out0
        return {"wall_s": round(dt, 3), "new_tokens": toks,
                "agg_tokens_per_sec": round(toks / max(dt, 1e-9), 1),
                "decode_calls": self.stats["decode_calls"]}
