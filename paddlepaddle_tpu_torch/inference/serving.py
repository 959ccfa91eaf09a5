"""Serving engine — request queue + continuous-batching decode, with the
admission checks and circuit breaker of the reference.

Port of ``paddlepaddle_tpu/inference/serving.py`` in ``mode="continuous"``:
one engine thread owns the device; callers ``submit()`` requests into a
queue and get :class:`GenerationResult` futures. The thread admits queued
requests into free decode slots of :class:`~.decode_engine.BatchDecodeEngine`
mid-flight, runs decode chunks, and the engine delivers each future when its
slot retires.

Ported: ``submit`` (with ``prefix_len`` for shared-prefix hits) /
``generate`` / ``start`` / ``stop`` / context manager, the engine's
``prefix_cache`` / ``kv_quant`` / ``kv_host_bytes`` options, speculative
decoding (``draft=`` / ``spec_k=``, greedy requests only), the
``_check_admission`` validation with typed ``RequestValidationError`` /
``KVCapacityError`` / ``ServerOverloadedError`` / ``CircuitOpenError``,
``max_queue`` / ``max_queue_wait_s`` shedding, and the breaker's success and
failure bookkeeping around each decode chunk (a failed chunk fails its
requests' futures). Deadlines, cancellation, drain/SIGTERM, the hang
watchdog, observability hooks and static mode raise ``NotImplementedError``
(ROADMAP A4.6) when asked for; so does a quantized draft (``draft_quant``,
A4.3).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..core import flags as _flags
from ..device import DeviceLike
from .decode_engine import BatchDecodeEngine, not_ported
from .kv_pool import pages_needed
from .robustness import (
    CircuitBreaker,
    CircuitOpenError,
    KVCapacityError,
    QueueWaitEstimator,
    RequestValidationError,
    ServerOverloadedError,
)

_REQ_IDS = itertools.count(1)


class GenerationResult:
    """Future for one request, carrying its lifecycle timestamps (submit
    -> admit -> first token on the host -> finish), so TTFT, TPOT and queue
    wait are measured per request (:meth:`slo`)."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._output = None
        self._error: Optional[BaseException] = None
        self._t_submit = time.perf_counter()
        self._t_admit: Optional[float] = None
        self._t_first: Optional[float] = None
        self._t_done: Optional[float] = None
        self._n_new = 0
        # tokens already on the host at _t_first: 1, or more when a
        # speculative chunk's tokens landed with the first one
        self._n_at_first = 1
        self._req_id: Optional[int] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self._error is not None:
            raise self._error
        return self._output

    def slo(self) -> Dict[str, object]:
        """Per-request SLO numbers (None where the lifecycle point was never
        reached). TPOT is the per-token average over the tokens that
        arrived after the first one (reference :227-252)."""
        end, t_first = self._t_done, self._t_first
        return {
            "req_id": self._req_id,
            "new_tokens": self._n_new,
            "queue_wait_s": (None if self._t_admit is None
                             else self._t_admit - self._t_submit),
            "ttft_s": None if t_first is None else t_first - self._t_submit,
            "tpot_s": (None if (t_first is None or end is None
                                or self._n_new <= self._n_at_first)
                       else (end - t_first)
                       / (self._n_new - self._n_at_first)),
            "latency_s": None if end is None else end - self._t_submit,
        }

    def _set(self, output=None, error=None) -> None:
        with self._lock:
            if self._event.is_set():
                return            # first outcome wins
            self._output = output
            self._error = error
            self._t_done = time.perf_counter()
            self._event.set()


def slo_summary(results) -> Dict[str, Optional[float]]:
    """TTFT p50/p99, TPOT and queue-wait percentiles over completed
    :class:`GenerationResult` futures, in ms."""
    slos = [r.slo() for r in results]
    ttfts = sorted(s["ttft_s"] for s in slos if s["ttft_s"] is not None)
    tpots = sorted(s["tpot_s"] for s in slos if s["tpot_s"] is not None)
    waits = sorted(s["queue_wait_s"] for s in slos
                   if s["queue_wait_s"] is not None)

    def pct(vals, q):
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))]

    def ms(v):
        return None if v is None else round(v * 1e3, 2)

    return {
        "ttft_p50_ms": ms(pct(ttfts, 0.50)),
        "ttft_p99_ms": ms(pct(ttfts, 0.99)),
        "tpot_ms": ms(pct(tpots, 0.50)),
        "tpot_p99_ms": ms(pct(tpots, 0.99)),
        "queue_wait_p50_ms": ms(pct(waits, 0.50)),
        "queue_wait_p99_ms": ms(pct(waits, 0.99)),
    }


class GenerationRequest:
    """One request, in the reference's parameter order (:346). A
    ``deadline`` that is not None raises until deadlines are ported."""

    def __init__(self, prompt_ids, max_new_tokens, temperature=0.0, top_k=0,
                 eos_token_id=None, deadline: Optional[float] = None,
                 prefix_len: Optional[int] = None):
        if deadline is not None:
            raise not_ported("deadline", "A4.6")
        arr = np.asarray(prompt_ids, np.int32)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1:
            raise ValueError(
                f"submit() takes ONE prompt (1-D ids or [1, L]); got shape "
                f"{arr.shape} — submit a batch as separate requests")
        self.prompt_ids = arr.reshape(1, -1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_token_id = eos_token_id
        self.prefix_len = None if prefix_len is None else int(prefix_len)
        self.id = next(_REQ_IDS)
        self.result = GenerationResult()
        self.result._req_id = self.id


def _flag_or(value, flag_name, off_value=0):
    """Explicit argument wins, else the FLAGS_serving_* flag; the "off"
    sentinel (0 / 0.0) maps to None from both sources."""
    if value is None:
        value = _flags.flag_value(flag_name)
    return None if value == off_value else value


class ServingEngine:
    """Continuous-batching generation server over a port
    ``LlamaForCausalLM``. ``device=None`` means the card."""

    def __init__(self, model, max_batch_size: int = 8,
                 max_wait_ms: float = 5.0, mode: str = "continuous",
                 max_len: Optional[int] = None, decode_chunk: int = 16,
                 max_queue: Optional[int] = None,
                 max_queue_wait_s: Optional[float] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 decode_timeout_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None,
                 drain_on_sigterm: bool = False,
                 quant: Optional[str] = None,
                 kv_layout: str = "paged",
                 kv_page_size: int = 64,
                 kv_num_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 mesh=None, plan=None, bundle: Optional[str] = None,
                 draft=None, spec_k: int = 0,
                 draft_quant: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 kv_host_bytes: Optional[int] = None,
                 device: DeviceLike = None, seed: int = 0):
        if mode not in ("continuous", "static"):
            raise ValueError(
                f"mode must be 'continuous' or 'static', got {mode!r}")
        if (draft is not None or spec_k) and mode != "continuous":
            raise ValueError(
                "speculative decoding (draft=/spec_k=) requires the "
                "continuous engine — static mode decodes through the "
                "model's own generate_cached")
        if mode == "static":
            raise not_ported("mode='static'", "A4.6")
        for name, value in (("default_deadline_s", default_deadline_s),
                            ("decode_timeout_s", decode_timeout_s),
                            ("drain_timeout_s", drain_timeout_s)):
            if value:
                raise not_ported(name, "A4.6")
        if drain_on_sigterm:
            raise not_ported("drain_on_sigterm", "A4.6")
        self.model = model
        self.mode = mode
        self.max_batch_size = max_batch_size
        self.max_wait = max_wait_ms / 1e3
        self._queue: "queue.Queue[GenerationRequest]" = queue.Queue()
        self._deferred: "deque[GenerationRequest]" = deque()  # FIFO head
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "decode_tokens": 0, "batches_failed": 0, "shed": 0,
                      "decode_failures": 0}
        self.max_queue = _flag_or(max_queue, "serving_max_queue")
        self.max_queue_wait_s = _flag_or(max_queue_wait_s,
                                         "serving_max_queue_wait_s", 0.0)
        self._breaker = CircuitBreaker(
            threshold=(breaker_threshold if breaker_threshold is not None
                       else _flags.flag_value("serving_breaker_threshold")),
            reset_s=(breaker_reset_s if breaker_reset_s is not None
                     else _flags.flag_value("serving_breaker_reset_s")))
        self._estimator = QueueWaitEstimator()
        self._limits_armed = (self.max_queue is not None
                              or self.max_queue_wait_s is not None)
        self._engine = BatchDecodeEngine(
            model, max_slots=max_batch_size, max_len=max_len,
            chunk=decode_chunk, quant=quant, kv_layout=kv_layout,
            page_size=kv_page_size, num_pages=kv_num_pages,
            prefix_cache=prefix_cache, mesh=mesh, plan=plan, bundle=bundle,
            draft=draft, spec_k=spec_k, draft_quant=draft_quant,
            kv_quant=kv_quant,
            kv_host_bytes=kv_host_bytes, device=device, seed=seed)
        self._max_len = self._engine.L
        self._top_k_cap = self._engine.TOP_K_CAP
        self._kv_page_size = self._engine.page_size
        self._kv_capacity = self._engine.pool.usable

    @property
    def engine(self) -> BatchDecodeEngine:
        return self._engine

    def _bump(self, key, n=1):
        with self._stats_lock:
            self.stats[key] += n

    def _shed(self, exc: BaseException) -> None:
        self._bump("shed")
        raise exc

    def _queue_depth(self) -> int:
        return self._queue.qsize() + len(self._deferred)

    def _check_admission(self, req: GenerationRequest) -> None:
        """Every reason a request may not enter the queue, cheapest first."""
        plen = req.prompt_ids.shape[1]
        if req.max_new_tokens < 1:
            raise RequestValidationError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if plen + req.max_new_tokens > self._max_len:
            raise RequestValidationError(
                f"prompt {plen} + {req.max_new_tokens} new tokens exceeds "
                f"engine max_len {self._max_len} — shorten the prompt or "
                "lower max_new_tokens")
        if req.top_k > self._top_k_cap:
            raise RequestValidationError(
                f"top_k {req.top_k} exceeds the continuous engine's filter "
                f"cap {self._top_k_cap}")
        if req.prefix_len is not None and not 0 <= req.prefix_len <= plen:
            raise RequestValidationError(
                f"prefix_len {req.prefix_len} must be within the prompt "
                f"(length {plen})")
        # page-pool capacity, not just max_len: a request needing more pages
        # than the pool HOLDS is shed here instead of waiting forever. Total
        # need governs even on a prefix hit (the pinned prefix pages occupy
        # capacity too), so this check is exact
        need = pages_needed(plen + req.max_new_tokens, self._kv_page_size)
        if need > self._kv_capacity:
            self._shed(KVCapacityError(
                f"prompt {plen} + {req.max_new_tokens} new tokens needs "
                f"{need} KV pages (page_size {self._kv_page_size}) but the "
                f"pool holds only {self._kv_capacity} even when empty — "
                "raise kv_num_pages or shorten the request",
                pages_needed=need, pages_capacity=self._kv_capacity))
        breaker = self._breaker
        if breaker._state != "closed" and not breaker.allow():
            self._shed(CircuitOpenError(
                f"decode circuit breaker is open after "
                f"{breaker.consecutive_failures} consecutive failures; "
                "submits fail fast until a half-open probe succeeds",
                retry_after_s=breaker.retry_after_s()))
        if self._limits_armed:
            depth = self._queue_depth()
            est = self._estimator.estimate_wait_s(depth, self.max_batch_size)
            if self.max_queue is not None and depth >= self.max_queue:
                self._shed(ServerOverloadedError(
                    f"serving queue full ({depth} >= max_queue "
                    f"{self.max_queue})", queue_depth=depth,
                    retry_after_s=max(est, self.max_wait)))
            if (self.max_queue_wait_s is not None
                    and est > self.max_queue_wait_s):
                self._shed(ServerOverloadedError(
                    f"estimated queue wait {est:.2f}s exceeds "
                    f"max_queue_wait_s {self.max_queue_wait_s:g}",
                    queue_depth=depth, retry_after_s=est))

    # -- client API ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               top_k=0, eos_token_id=None,
               deadline_s: Optional[float] = None,
               prefix_len: Optional[int] = None) -> GenerationResult:
        """Queue one generation request; raises a typed error instead of
        queueing when the request cannot (validation) or should not
        (overload, open breaker) be served. ``prefix_len`` declares the
        prompt's first tokens a shared prefix (a system prompt): its full
        pages are cached and later requests with the same prefix prefill
        only their tail."""
        if deadline_s is not None:
            raise not_ported("deadline_s", "A4.6")
        req = GenerationRequest(prompt_ids, max_new_tokens, temperature,
                                top_k, eos_token_id, prefix_len=prefix_len)
        self._check_admission(req)
        if self._thread is None:
            self.start()  # lazy start: a future must always have a server
        self._bump("requests")
        self._queue.put(req)
        return req.result

    def generate(self, prompt_ids, timeout: float = 300.0, **kw) -> np.ndarray:
        return self.submit(prompt_ids, **kw).result(timeout)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop_continuous,
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the engine thread; fail whatever is still queued or in a
        decode slot, so no caller blocks on a future nobody serves."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError("serving engine thread did not stop "
                                   "within 60 s")
            self._thread = None
        err = RuntimeError("serving engine stopped")
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.result._set(error=err)
        while self._deferred:
            self._deferred.popleft().result._set(error=err)
        eng = self._engine
        for i, s in enumerate(eng._host_slots):
            if s.req is not None:
                s.req.result._set(error=err)
                eng._host_slots[i] = type(s)()
        eng.reset_slots()  # no phantom active device lanes

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- scheduler -----------------------------------------------------------
    def _next_request(self, block: bool,
                      timeout: float = 0.05) -> Optional[GenerationRequest]:
        """Pop the next request: the deferred FIFO drains ahead of the
        queue (no reordering behind newer arrivals)."""
        if self._deferred:
            return self._deferred.popleft()
        try:
            return (self._queue.get(timeout=timeout) if block
                    else self._queue.get_nowait())
        except queue.Empty:
            return None

    def _loop_continuous(self) -> None:
        """Admit queued requests into free decode slots, run decode chunks,
        retire finished slots mid-flight (the engine delivers each future
        on retirement)."""
        eng = self._engine
        while not self._stop.is_set():
            busy = eng.busy_slots() > 0
            admitted = False
            if self._breaker.allow():
                probe = self._breaker.state == "half_open"
                while True:
                    req = self._next_request(block=not busy)
                    if req is None:
                        break
                    try:
                        if eng._admit(req):
                            admitted = busy = True
                            self._bump("batched_requests")
                            if probe:
                                break   # one-request half-open probe
                        else:
                            # no free slot: hold at the FIFO head, decode to
                            # free one — never rotated behind arrivals
                            self._deferred.appendleft(req)
                            break
                    except Exception as e:  # noqa: BLE001 — to the caller
                        req.result._set(error=e)
            elif not busy:
                time.sleep(0.02)
                continue
            if not busy:
                continue
            before = eng.stats["tokens_out"]
            t0 = time.monotonic()
            try:
                eng._decode_chunk()
            except Exception as e:  # noqa: BLE001 — fail the slots' futures
                for i, s in enumerate(eng._host_slots):
                    if s.req is not None:
                        s.req.result._set(error=e)
                        eng._host_slots[i] = type(s)()
                eng.reset_slots()  # clear phantom device lanes too
                self._bump("batches_failed")
                self._bump("decode_failures")
                self._breaker.record_failure()
                continue
            self._estimator.observe(time.monotonic() - t0)
            self._breaker.record_success()
            self._bump("decode_tokens", eng.stats["tokens_out"] - before)
            if admitted:
                self._bump("batches")
