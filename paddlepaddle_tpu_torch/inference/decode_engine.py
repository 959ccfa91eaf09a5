"""Continuous-batching decode engine — paged KV pool, ragged lengths.

Port of ``paddlepaddle_tpu/inference/decode_engine.py`` for the paged layout
with full-precision KV: ``BatchDecodeEngine(kv_layout="paged",
kv_quant=None)``, no draft model, no mesh, no bundle.

* PAGED KV POOL: one ``[num_pages, page_size, kvh, hd]`` K and V buffer per
  layer plus a device page table ``[slots, max_len/page_size]`` int32.
  Admission reserves pages for the request's full prompt + budget from the
  host free list (:mod:`.kv_pool`), prefills the prompt, and writes the K/V
  prefix page by page; retirement returns the pages and zeroes the slot's
  table row so stray writes land in the null page 0.
* DECODE: each step scatters its new K/V into their physical pages first,
  then attends through :func:`~..ops.kernels.paged_attention.paged_attention`,
  which walks the page table itself (the CUDA kernel on the card, the plain
  version on the CPU). A chunk of ``chunk`` steps runs as a Python loop with
  every per-slot state tensor on the device and ONE host readback at its
  end, like the packed payload of the reference's scanned program.
* The pools, the page table and the slot state are updated IN PLACE
  (``index_put_``) where the reference donated its buffers to XLA.

Options the port does not serve yet raise ``NotImplementedError`` naming the
ROADMAP item that brings them; none is silently ignored.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.llama import rope_at, rotate
from ..ops.kernels import _build
from ..ops.kernels import paged_attention as _pa
from .kv_pool import PagePool, pages_needed
from .robustness import KVCapacityError


def not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to paddlepaddle_tpu_torch yet "
        f"(ROADMAP {item})")


def _stamp(req, attr: str, value=None) -> None:
    """SLO timestamp on the request's result future, when it has one."""
    res = getattr(req, "result", None)
    if res is not None:
        setattr(res, attr, time.perf_counter() if value is None else value)


class _Slot:
    __slots__ = ("req", "emitted", "budget")

    def __init__(self, req=None, budget=0):
        self.req = req
        self.emitted: List[int] = []
        self.budget = budget


class BatchDecodeEngine:
    """Slot-based continuous-batching decoder for a port
    ``LlamaForCausalLM``. ``device=None`` means the card (raises without
    CUDA); the model must already live on that device."""

    TOP_K_CAP = 128  # bound for the per-slot top-k filter

    def __init__(self, model, max_slots: int = 16, max_len: Optional[int] = None,
                 chunk: int = 16, quant: Optional[str] = None,
                 kv_layout: str = "paged", page_size: int = 64,
                 num_pages: Optional[int] = None,
                 mesh=None, plan=None, bundle: Optional[str] = None,
                 draft=None, spec_k: int = 0, kv_quant: Optional[str] = None,
                 kv_host_bytes: Optional[int] = None,
                 device: DeviceLike = None, seed: int = 0):
        if kv_layout == "contiguous":
            raise not_ported("kv_layout='contiguous'", "A4.2")
        if kv_layout != "paged":
            raise ValueError(
                f"kv_layout must be 'paged' or 'contiguous', got {kv_layout!r}")
        if quant is not None:
            raise not_ported(f"quant={quant!r}", "A4.3")
        if kv_quant not in (None, "", "off") or kv_host_bytes:
            raise not_ported("kv_quant / kv_host_bytes", "A4.4")
        if draft is not None or spec_k:
            raise not_ported("speculative decoding (draft=/spec_k=)", "A4.5")
        if bundle is not None:
            raise not_ported("bundle=", "A6")
        if mesh is not None or plan is not None:
            raise not_ported("tensor-parallel serving (mesh=/plan=)", "A10")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {self.device}")
        cfg = model.config
        self.model = model
        self.cfg = cfg
        self.S = int(max_slots)
        self.L = int(max_len or cfg.max_position_embeddings)
        if self.L > cfg.max_position_embeddings:
            raise ValueError(f"max_len {self.L} exceeds the model's "
                             f"max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        self.chunk = int(chunk)
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        dtype = model.dtype
        self.kernel = "plain"
        if self.device.type == "cuda":
            # resolved once here: an unsupported config raises now, never a
            # quiet downgrade to the plain version later
            ok, reason = _pa.paged_attention_supported(
                page_size=self.page_size, head_dim=hd, num_heads=nh,
                num_kv_heads=kvh, dtype=dtype, w=1)
            if not ok:
                raise ValueError(
                    f"paged-attention kernel does not take this engine "
                    f"configuration: {reason}")
            _build.check_device(self.device)
            _pa.build()
            self.kernel = "cuda"
        self.P = pages_needed(self.L, self.page_size)        # pages per slot
        n_pages = self.S * self.P + 1 if num_pages is None else int(num_pages)
        self.pool = PagePool(n_pages, self.page_size)
        dev = self.device
        shape = (n_pages, self.page_size, kvh, hd)
        self.caches = [(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev))
                       for _ in range(cfg.num_hidden_layers)]
        self.page_table = torch.zeros((self.S, self.P), dtype=torch.int32,
                                      device=dev)
        self._slot_pages: List[List[int]] = [[] for _ in range(self.S)]
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
        self._host_slots = [_Slot() for _ in range(self.S)]
        self._first_pending: Dict[int, torch.Tensor] = {}  # slot -> 0-d
        self.stats = {"tokens_out": 0, "requests": 0, "decode_calls": 0,
                      "decode_steps": 0, "peak_busy": 0}
        # host wall of the most recent decode chunks, queue to readback (ms)
        self.chunk_ms: List[float] = []

    # -- device pieces -------------------------------------------------------
    def _forward_paged(self, toks: torch.Tensor, lens: torch.Tensor):
        """One forward over ``toks [S, W]`` at per-slot positions
        ``lens..lens+W-1``: each layer scatters its W new K/V rows to their
        physical pages, then attends through the page table. Positions past
        ``max_len`` are redirected to the null page, and the page index is
        clamped to the table, as in the reference (decode_engine.py:671-680).
        Returns logits ``[S, W, V]``."""
        S, ps, P, L = self.S, self.page_size, self.P, self.L
        W = toks.shape[1]
        cfg = self.cfg
        nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        rep, scale = nh // kvh, 1.0 / math.sqrt(hd)
        pos = lens.long()[:, None] + torch.arange(W, device=self.device)[None, :]
        page_idx = torch.clamp(pos // ps, max=P - 1)
        phys = torch.where(pos < L, self.page_table.gather(1, page_idx).long(),
                           0)
        off = pos % ps
        mdl = self.model.model
        x = mdl.embed_tokens(toks.long())
        # rope rows for this step's positions, shared by every layer
        c, s = rope_at(mdl.rope_cos, mdl.rope_sin, lens, W, x.dtype)
        for layer, (kp, vp) in zip(mdl.layers, self.caches):
            attn = layer.self_attn
            h_pre = layer.input_layernorm(x)
            q = attn.q_proj(h_pre).reshape(S, W, nh, hd)
            k = attn.k_proj(h_pre).reshape(S, W, kvh, hd)
            v = attn.v_proj(h_pre).reshape(S, W, kvh, hd)
            q, k = rotate(q, c, s), rotate(k, c, s)
            # write first, then attend: the causal rule admits this step's
            # own positions. In place, where the reference donated the pool
            kp.index_put_((phys, off), k.to(kp.dtype))
            vp.index_put_((phys, off), v.to(vp.dtype))
            out = _pa.paged_attention(q, kp, vp, self.page_table, lens,
                                      rep=rep, scale=scale)
            x = x + attn.o_proj(out.reshape(S, W, nh * hd))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        return self.model.logits(mdl.norm(x))

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
                          eos: int, budget: int, top_k: int) -> torch.Tensor:
        """Prefill exactly the prompt's ``plen`` rows through scratch caches
        (plain attention), sample the first token, and write the K/V prefix
        page by page into the pages the host put in this slot's table row."""
        dev = self.device
        plen = ids.shape[1]
        cfg = self.cfg
        kvh, hd, ps = cfg.num_key_value_heads, cfg.head_dim, self.page_size
        dtype = self.caches[0][0].dtype
        ids_t = torch.as_tensor(ids, dtype=torch.long).to(dev)
        scratch = [(torch.zeros((1, plen, kvh, hd), dtype=dtype, device=dev),
                    torch.zeros((1, plen, kvh, hd), dtype=dtype, device=dev))
                   for _ in range(cfg.num_hidden_layers)]
        hidden, scratch = self.model.model(ids_t, caches=scratch, pos=0)
        row = self.model.logits(hidden[:, plen - 1]).float()   # [1, V]
        first = self._sample(
            row, torch.full((1,), temp, dtype=torch.float32, device=dev),
            torch.full((1,), top_k, dtype=torch.int32, device=dev))[0]
        npg = pages_needed(plen, ps)
        pad = npg * ps - plen
        dest = self.page_table[slot, :npg].long()
        for (kp, vp), (ks, vs) in zip(self.caches, scratch):
            kp[dest] = torch.nn.functional.pad(
                ks[0], (0, 0, 0, 0, 0, pad)).reshape(npg, ps, kvh, hd)
            vp[dest] = torch.nn.functional.pad(
                vs[0], (0, 0, 0, 0, 0, pad)).reshape(npg, ps, kvh, hd)
        self._set_slot_state(slot, plen, temp, eos, budget, top_k, first)
        return first

    # -- host orchestration --------------------------------------------------
    def _reserve_pages(self, plen: int, budget: int) -> Optional[List[int]]:
        """Allocate the request's pages for its full prompt + budget.
        None when the pool cannot satisfy it right now (the caller waits
        for retirements); :class:`KVCapacityError` when it never could."""
        total = pages_needed(plen + budget, self.page_size)
        if total > self.pool.usable:
            raise KVCapacityError(
                f"prompt {plen} + {budget} new tokens needs {total} KV "
                f"pages (page_size {self.page_size}) but the pool holds "
                f"only {self.pool.usable} even when empty — raise "
                "num_pages or shorten the request", pages_needed=total,
                pages_capacity=self.pool.usable)
        if self.pool.free_count < total:
            return None
        return self.pool.alloc(total)

    @torch.no_grad()
    def _admit(self, req) -> bool:
        """Prefill ``req`` into a free slot; False when no slot (or no
        pages) is free."""
        free = [i for i, s in enumerate(self._host_slots) if s.req is None]
        if not free:
            return False
        slot = free[0]
        if getattr(req, "prefix_len", None):
            raise not_ported("prefix_len (prefix-cache hits)", "A4.1")
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
        pages = self._reserve_pages(plen, req.max_new_tokens)
        if pages is None:
            return False              # pool dry: decode frees pages later
        self._slot_pages[slot] = pages
        row = np.zeros((self.P,), np.int32)
        row[:len(pages)] = pages
        self.page_table[slot] = torch.from_numpy(row).to(self.device)
        try:
            first = self._admit_paged_impl(
                ids, slot, temp, -1 if eos is None else int(eos),
                int(req.max_new_tokens), top_k)
        except BaseException:
            # the reservation must not outlive a failed admission
            self._release_kv(slot)
            raise
        self._host_slots[slot] = _Slot(req, budget=int(req.max_new_tokens))
        self.stats["peak_busy"] = max(self.stats["peak_busy"],
                                      self.busy_slots())
        _stamp(req, "_t_admit")
        self._first_pending[slot] = first   # device scalar, synced at collect
        self.stats["requests"] += 1
        return True

    def _release_kv(self, slot: int, zero_row: bool = True) -> None:
        """Return a slot's pages to the free list and (by default) zero its
        page-table row so later decode writes land in the null page.
        Idempotent."""
        pages = self._slot_pages[slot]
        if pages:
            self.pool.free(pages)
            self._slot_pages[slot] = []
        if zero_row:
            self.page_table[slot] = 0

    def _retire(self, slot: int) -> None:
        s = self._host_slots[slot]
        if s.req is not None:
            prompt = np.asarray(s.req.prompt_ids, np.int32).reshape(-1)
            gen = s.emitted[: s.budget]
            eos = getattr(s.req, "eos_token_id", None)
            if eos is not None and eos in gen:
                gen = gen[: gen.index(eos) + 1]   # trim past eos, keep it
            _stamp(s.req, "_n_new", len(gen))
            s.req.result._set(output=np.concatenate(
                [prompt, np.asarray(gen, np.int32)]))
        self._release_kv(slot)
        self._host_slots[slot] = _Slot()

    def _collect_firsts(self) -> None:
        """ONE host sync for every first token admitted since the last
        collect; stamps each request's first-token time."""
        if not self._first_pending:
            return
        slots = sorted(self._first_pending)
        vals = torch.stack([self._first_pending[i] for i in slots]).cpu()
        now = time.perf_counter()
        for i, slot in enumerate(slots):
            s = self._host_slots[slot]
            if s.req is not None:
                s.emitted.append(int(vals[i]))
                self.stats["tokens_out"] += 1
                if getattr(s.req.result, "_t_first", 1) is None:
                    _stamp(s.req, "_t_first", now)
        self._first_pending.clear()

    def reset_slots(self, slots=None) -> None:
        """Deactivate device-side slot state (all slots, or the given list)
        and return their pages — required after a failed decode or a stop,
        or retired rows keep computing as phantom active lanes."""
        if slots is None:
            self.active.zero_()
            self._first_pending.clear()
            for i in range(self.S):
                self._release_kv(i, zero_row=False)
            self.page_table.zero_()
        else:
            for i in slots:
                self.active[int(i)] = False
                self._first_pending.pop(int(i), None)
                self._release_kv(int(i))

    def release_slot(self, slot: int) -> None:
        """Free one slot without delivering a result (the caller owns the
        request's future)."""
        self.reset_slots([slot])
        self._host_slots[int(slot)] = _Slot()

    def busy_slots(self) -> int:
        return sum(1 for s in self._host_slots if s.req is not None)

    @torch.no_grad()
    def _decode_chunk(self) -> None:
        """``chunk`` decode steps over all slots with per-slot eos and
        budget countdown on the device, then one readback of the packed
        ``[slots, chunk+1]`` payload (tokens, -1 where idle, last column =
        active)."""
        # first tokens of this cycle's admissions reach the host before the
        # chunk is queued, so time-to-first-token excludes the chunk
        self._collect_firsts()
        t0 = time.perf_counter()
        tokens, lens, active, budgets = (self.tokens, self.lens, self.active,
                                         self.budgets)
        temps, top_ks, eos_ids = self.temps, self.top_ks, self.eos_ids
        steps = []
        for _ in range(self.chunk):
            rows = self._forward_paged(tokens[:, None], lens)[:, 0].float()
            nxt = self._sample(rows, temps, top_ks)
            nxt = torch.where(active, nxt, tokens)     # frozen when inactive
            step = active.to(torch.int32)
            lens = lens + step
            steps.append(torch.where(active, nxt, -1))
            budgets = budgets - step
            active = active & ~((eos_ids >= 0) & (nxt == eos_ids)) \
                & (budgets > 0)
            tokens = nxt
        self.tokens, self.lens, self.active, self.budgets = (
            tokens, lens, active, budgets)
        packed = torch.cat([torch.stack(steps, dim=1),
                            active[:, None].to(torch.int32)], dim=1)
        pk = packed.cpu().numpy()                      # the ONE sync per chunk
        self.chunk_ms.append((time.perf_counter() - t0) * 1e3)
        del self.chunk_ms[:-512]
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += self.chunk
        em, act = pk[:, :-1], pk[:, -1].astype(bool)
        for slot, s in enumerate(self._host_slots):
            if s.req is None:
                continue
            toks = [int(t) for t in em[slot] if t >= 0]
            s.emitted.extend(toks)
            self.stats["tokens_out"] += len(toks)
            if not act[slot] or len(s.emitted) >= s.budget:
                self._retire(slot)

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
