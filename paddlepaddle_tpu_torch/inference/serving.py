"""Serving engine — request queue + batched decode, wrapped in the
reference's overload-and-failure protection layer.

Port of ``paddlepaddle_tpu/inference/serving.py``. One engine thread owns
the device; callers ``submit()`` requests into a queue and get
:class:`GenerationResult` futures. Two schedulers:

* ``mode="continuous"`` (default): slot-based continuous batching over
  :class:`~.decode_engine.BatchDecodeEngine`. The thread admits queued
  requests into free decode slots mid-flight, runs decode chunks, and the
  engine delivers each future when its slot retires. Every engine option
  passes through (``quant`` / ``quant_group_size``, ``kv_layout``, the
  paged pool, prefix hits, int8 KV, the host tier, speculative decoding
  with ``draft_quant``, ``fused_kernels``).
* ``mode="static"``: groups compatible requests (same prompt length and
  sampling parameters, :meth:`GenerationRequest.batch_key`) into one
  ``model.generate_cached`` call. No streaming: TTFT is the whole batch's
  latency and TPOT is None.

The protection layer (robustness.py), all opt-in except the breaker:
admission checks with typed errors; ``max_queue`` / ``max_queue_wait_s``
shedding; per-request deadlines (``submit(deadline_s=)``,
``default_deadline_s``), shed while queued and released mid-decode;
``GenerationResult.cancel()``; the circuit breaker around each decode
attempt, with the hang watchdog (``decode_timeout_s``) that trips it;
``drain(timeout)`` and ``install_preemption_hook()`` (SIGTERM drains
before exit 143); and ``health()``, the readiness snapshot.

A decode chunk on the card is a CUDA-graph replay that returns at once;
the chunk ends at its one readback. The watchdog times each attempt from
before the replay to after that readback, so a hung chunk shows as an
attempt in flight.

Cold start: ``warmup()`` warms the engine's whole compile plan before the
first request, ``save_serving_bundle()`` writes a bundle and ``bundle=``
loads one (:mod:`.compile_plan`). Observability (:mod:`..observability`):
the serving hook ``_obs_srv`` (request latency and outcome, the SLO
histograms, batch size, queue depth, decode-attempt outcomes), request
journeys (``submit(trace=)`` takes one; with tracing armed and none
passed, the engine mints one), the goodput ledger's serving-side waste
paths, the flight recorder, and the ``/healthz`` provider of a running
exporter. The fleet's seams (reference :99, :204-226): ``_flight_record``,
and ``GenerationResult._add_done_callback``, on which the router
(:mod:`.router`) hangs failover, hedging and its wrapper futures; the chaos
seams ``serving.admit`` and ``serving.decode`` (:mod:`..resilience.chaos`).
Tensor parallel (``mesh=`` / ``plan=``, reference :409-443): passed to the
continuous engine, one ``ServingEngine`` per rank of the job. Rank 0
serves (``submit`` / ``generate``); on ranks > 0 ``start()`` runs the
engine's follower loop in the serving thread and ``stop()`` waits for rank
0 to release it, so one script runs on every rank. Static mode with a mesh
raises, naming the continuous engine.
"""

from __future__ import annotations

import itertools
import queue
import sys
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..core import flags as _flags
from ..device import DeviceLike
from ..observability import exporter as _exporter
from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import reqtrace as _reqtrace
from ..observability.recorder import trace_region
from ..resilience.chaos import chaos_point
from .decode_engine import BatchDecodeEngine
from .kv_pool import pages_needed
from .robustness import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    EngineDrainingError,
    KVCapacityError,
    QueueWaitEstimator,
    RequestCancelledError,
    RequestValidationError,
    ServerOverloadedError,
    safe_inc,
    safe_set,
)

# observability hook: _obs_srv(event, value) with events "latency" (seconds
# submit-to-result for one completed request), "error"/"cancelled" (a request
# failed / was cancelled), "slo" (one completed request's lifecycle numbers),
# "batch_size" (decode slots / requests active in the current batch),
# "queue_depth" (requests waiting, queue + deferred), "batch" (value
# "ok"|"error": one decode attempt's outcome). None when observability is
# off; observability.enable() installs it.
_obs_srv = None

_BREAKER_STATE_NUM = {"closed": 0, "half_open": 1, "open": 2}

# process-wide request ids: the join key across SLO metrics, trace spans
# (request#<id>) and flight-recorder lifecycle events
_REQ_IDS = itertools.count(1)


# the reference's name (:99) for the flight recorder's feed, which the
# router and the fleet import from here
_flight_record = _flight.record


class GenerationResult:
    """Future for one request, carrying its lifecycle timestamps (submit
    -> admit -> first token on the host -> finish), so TTFT, TPOT and queue
    wait are measured per request (:meth:`slo`); a completed request feeds
    the ``paddle_serving_{ttft,tpot,queue_wait,deadline_margin}_seconds``
    histograms, a ``request#<id>`` span, the flight recorder and, when it
    owns one, closes its journey."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()   # one writer wins: a delivery racing
        #   a client cancel() must not tear the outcome
        self._output = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._cancel_kind = "cancel"   # goodput kind a cancel wastes as
        self._callbacks: List = []     # run once, after the outcome is set
        self._obs_emit = True   # False on a router's wrapper future, whose
        #   replica-side inner future already feeds the SLO histograms and
        #   the flight recorder: one request, one record
        self._t_submit = time.perf_counter()
        self._t_admit: Optional[float] = None
        self._t_first: Optional[float] = None
        self._t_done: Optional[float] = None
        self._n_new = 0
        # tokens already on the host at _t_first: 1, or more when a
        # speculative chunk's tokens landed with the first one
        self._n_at_first = 1
        self._req_id: Optional[int] = None
        self._deadline: Optional[float] = None   # absolute monotonic
        self._streaming = True    # False: tokens arrive as one batch
        #                           (static mode), so TPOT is undefined
        self._trace = None        # reqtrace Journey riding this request
        self._trace_owner = False  # True on the future whose _set closes it
        self._t_dispatch: Optional[float] = None  # the winning attempt's
        #   own submit time after a router failover: queue wait is per
        #   attempt, not from the first submit across every retry

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self, reason: str = "cancel") -> bool:
        """Cancel the request (reference :180-195): the future fails with
        :class:`RequestCancelledError` now, a queued request is dropped when
        popped, and an in-flight decode slot is released on the next
        scheduler cycle. True if the request had not finished. ``reason``
        names the goodput kind the abandoned tokens count as."""
        self._cancelled = True
        self._cancel_kind = reason
        if self._event.is_set():
            return False
        self._set(error=RequestCancelledError("request cancelled by client"))
        return True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self._error is not None:
            raise self._error
        return self._output

    def _add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` exactly once when the outcome lands (now, if it
        already has; reference :204). The router's failover, hedging and
        wrapper futures hang off this. A callback runs on whichever thread
        sets the outcome, often the engine's scheduler thread, so it must
        not block there; an exception it raises is swallowed."""
        self._callbacks.append(fn)
        if self._event.is_set():
            self._drain_callbacks()

    def _drain_callbacks(self) -> None:
        # pop one at a time: a drain racing another drain runs each
        # callback once
        while True:
            try:
                fn = self._callbacks.pop(0)
            except IndexError:
                return
            try:
                fn(self)
            except Exception:
                pass

    def slo(self) -> Dict[str, object]:
        """Per-request SLO numbers (None where the lifecycle point was never
        reached). TPOT is the per-token average over the tokens that
        arrived after the first one, and None in static mode, where there
        is no streaming (reference :227-252). Queue wait is measured from
        the winning attempt's own submit after a router failover."""
        end, t_first = self._t_done, self._t_first
        t_base = (self._t_dispatch if self._t_dispatch is not None
                  else self._t_submit)
        return {
            "req_id": self._req_id,
            "new_tokens": self._n_new,
            "queue_wait_s": (None if self._t_admit is None
                             else self._t_admit - t_base),
            "ttft_s": None if t_first is None else t_first - self._t_submit,
            "tpot_s": (None if (t_first is None or end is None
                                or self._n_new <= self._n_at_first
                                or not self._streaming)
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
            self._t_done = now = time.perf_counter()
            self._event.set()
        obs = _obs_srv if self._obs_emit else None
        outcome = ("ok" if error is None
                   else "cancelled" if isinstance(error, RequestCancelledError)
                   else "error")
        if obs is not None:
            if error is None:
                obs("latency", now - self._t_submit)
                s = self.slo()
                obs("slo", {
                    "id": self._req_id,
                    "latency": s["latency_s"],
                    "ttft": s["ttft_s"],
                    "tpot": s["tpot_s"],
                    "queue_wait": s["queue_wait_s"],
                    "deadline_margin": (None if self._deadline is None
                                        else self._deadline
                                        - time.monotonic()),
                    "tokens": self._n_new,
                })
            else:
                obs(outcome, 1)
        if self._obs_emit:
            _flight.record(
                "request", str(self._req_id or "?"), phase="finish",
                outcome=outcome, tokens=self._n_new,
                latency_ms=round((now - self._t_submit) * 1e3, 3),
                **({} if self._t_first is None else
                   {"ttft_ms": round((self._t_first - self._t_submit)
                                     * 1e3, 3)}))
        try:
            if error is None and self._obs_emit and (
                    _flags.flag_value("slo_ttft_ms") > 0
                    or _flags.flag_value("slo_tpot_ms") > 0):
                s = self.slo()
                _reqtrace.slo_observe(s["ttft_s"], s["tpot_s"])
            if self._trace is not None and self._trace_owner:
                _reqtrace.finish_future(self._trace, self, outcome)
        except Exception:
            pass       # observability must never break request delivery
        self._drain_callbacks()


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
    """One request, in the reference's parameter order (:346). ``deadline``
    is an absolute ``time.monotonic()`` time, or None."""

    def __init__(self, prompt_ids, max_new_tokens, temperature=0.0, top_k=0,
                 eos_token_id=None, deadline: Optional[float] = None,
                 prefix_len: Optional[int] = None):
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
        self.deadline = deadline
        self.prefix_len = None if prefix_len is None else int(prefix_len)
        self.id = next(_REQ_IDS)
        self.result = GenerationResult()
        self.result._req_id = self.id
        self.result._deadline = deadline

    def batch_key(self):
        """Static-mode batching: one prompt length and one sampling
        configuration share a ``generate_cached`` call."""
        return (self.prompt_ids.shape[1], self.temperature, self.top_k,
                self.eos_token_id)


def _flag_or(value, flag_name, off_value=0):
    """Explicit argument wins, else the FLAGS_serving_* flag; the "off"
    sentinel (0 / 0.0) maps to None from both sources."""
    if value is None:
        value = _flags.flag_value(flag_name)
    return None if value == off_value else value


class ServingEngine:
    """Batched generation server over a port ``LlamaForCausalLM``, in the
    reference's parameter order (:392-417); ``device`` and ``seed`` are
    keyword-only and reach the continuous engine (``device=None`` means the
    card). Static mode decodes on the device the model lives on."""

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
                 quant_group_size: int = -1,
                 kv_layout: str = "paged",
                 kv_page_size: int = 64,
                 kv_num_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 mesh=None, plan=None, bundle: Optional[str] = None,
                 draft=None, spec_k: int = 0,
                 draft_quant: Optional[str] = None,
                 fused_kernels: Optional[bool] = None,
                 kv_quant: Optional[str] = None,
                 kv_host_bytes: Optional[int] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        if mode not in ("continuous", "static"):
            raise ValueError(
                f"mode must be 'continuous' or 'static', got {mode!r}")
        if (kv_quant not in (None, "", "off")
                or kv_host_bytes) and mode != "continuous":
            raise ValueError(
                "kv_quant/kv_host_bytes require the continuous engine — "
                "the paged KV pool (int8 pages, host spill tier) lives "
                "there; static mode decodes through generate_cached")
        if (draft is not None or spec_k) and mode != "continuous":
            raise ValueError(
                "speculative decoding (draft=/spec_k=) requires the "
                "continuous engine — static mode decodes through the "
                "model's own generate_cached")
        if bundle is not None and mode != "continuous":
            raise ValueError(
                "bundle= requires the continuous engine (static mode "
                "decodes through the model's own generate_cached; AOT "
                "bundles serialize the decode engine's compiled programs)")
        if quant is not None and mode != "continuous":
            raise ValueError(
                "quant mode requires the continuous engine (static mode "
                "decodes through the model's own generate_cached, whose "
                "bound params are full precision)")
        if (mesh is not None or plan is not None) and mode != "continuous":
            raise ValueError(
                "tensor-parallel serving (mesh=/plan=) requires the "
                "continuous engine — static mode decodes through the "
                "model's own generate_cached, whose bound params are "
                "single-chip")
        self.model = model
        self.mode = mode
        self.max_batch_size = max_batch_size
        self.max_wait = max_wait_ms / 1e3
        self._queue: "queue.Queue[GenerationRequest]" = queue.Queue()
        self._deferred: "deque[GenerationRequest]" = deque()  # FIFO head
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._follower_error: Optional[BaseException] = None
        self._drain_reason = "drain"
        self._thread: Optional[threading.Thread] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "decode_tokens": 0, "batches_failed": 0, "shed": 0,
                      "cancelled": 0, "deadline_expired": 0,
                      "decode_failures": 0}
        self.max_queue = _flag_or(max_queue, "serving_max_queue")
        self.max_queue_wait_s = _flag_or(max_queue_wait_s,
                                         "serving_max_queue_wait_s", 0.0)
        self.default_deadline_s = _flag_or(default_deadline_s,
                                           "serving_default_deadline_s", 0.0)
        self.decode_timeout_s = _flag_or(decode_timeout_s,
                                         "serving_decode_timeout_s", 0.0)
        self.drain_timeout_s = (drain_timeout_s if drain_timeout_s is not None
                                else _flags.flag_value(
                                    "serving_drain_timeout_s"))
        self._breaker = CircuitBreaker(
            threshold=(breaker_threshold if breaker_threshold is not None
                       else _flags.flag_value("serving_breaker_threshold")),
            reset_s=(breaker_reset_s if breaker_reset_s is not None
                     else _flags.flag_value("serving_breaker_reset_s")),
            on_transition=self._on_breaker_transition)
        self._estimator = QueueWaitEstimator()
        self._static_inflight = 0     # the static scheduler's batch size
        self._decode_started_at: Optional[float] = None
        self._hang_tripped = False
        self._last_decode_ok: Optional[float] = None
        self._drain_on_sigterm = bool(drain_on_sigterm)
        self._limits_armed = (self.max_queue is not None
                              or self.max_queue_wait_s is not None)
        self._engine: Optional[BatchDecodeEngine] = None
        self.quant = quant
        if mode == "continuous":
            self._engine = BatchDecodeEngine(
                model, max_slots=max_batch_size, max_len=max_len,
                chunk=decode_chunk, quant=quant,
                quant_group_size=quant_group_size, kv_layout=kv_layout,
                page_size=kv_page_size, num_pages=kv_num_pages,
                prefix_cache=prefix_cache, mesh=mesh, plan=plan,
                bundle=bundle, draft=draft, spec_k=spec_k,
                draft_quant=draft_quant, fused_kernels=fused_kernels,
                kv_quant=kv_quant, kv_host_bytes=kv_host_bytes,
                device=device, seed=seed)
            self._spec_enabled = self._engine.spec is not None
            self._max_len = self._engine.L
            self._top_k_cap = self._engine.TOP_K_CAP
            # page-pool capacity admission facts (None = contiguous)
            paged = kv_layout == "paged"
            self._kv_page_size = self._engine.page_size if paged else None
            self._kv_capacity = self._engine.pool.usable if paged else None
            # a crash dump carries the pool state at the moment of death;
            # weakly bound, so the annotation never pins a dropped engine
            eng_ref = weakref.ref(self._engine)

            def _kv_annotation():
                eng = eng_ref()
                return (eng.kv_stats() if eng is not None
                        else {"layout": "engine-released"})

            _flight.annotate("serving_kv", _kv_annotation)
            if self._spec_enabled:
                self._announce_spec()
            if quant is not None:
                self._announce_quant(self._engine.quant_meta)
            if (self._engine.kv_quant is not None
                    or self._engine.kv_host is not None):
                self._announce_kv_memory()
        else:
            self._max_len = max_len or getattr(
                getattr(model, "config", None), "max_position_embeddings",
                None)
            self._top_k_cap = None
            self._kv_page_size = None
            self._kv_capacity = None
            self._spec_enabled = False

    @property
    def engine(self) -> Optional[BatchDecodeEngine]:
        return self._engine

    def _bump(self, key, n=1):
        with self._stats_lock:
            self.stats[key] += n

    def _announce_quant(self, meta: Dict[str, object]) -> None:
        """One-time observability for quant mode (reference :556): the
        ``paddle_serving_quant_*`` gauges, the flight-recorder header
        annotation and a stderr line."""
        safe_set("paddle_serving_quant_enabled",
                 "serving weight-only quantization armed (1 = on)", 1,
                 mode=self.quant)
        safe_set("paddle_serving_quant_weights",
                 "matmul weights quantized by the serving engine",
                 len(meta.get("quantized", ())))
        safe_set("paddle_serving_quant_bytes_saved",
                 "HBM weight bytes a decode step no longer reads",
                 meta.get("bytes_saved", 0))
        _flight.annotate("serving_quant", {
            "mode": self.quant,
            "group_size": meta.get("group_size", -1),
            "weights": len(meta.get("quantized", ())),
            "bytes_saved": meta.get("bytes_saved", 0)})
        sys.stderr.write(
            f"[serving] weight-only quant armed: {self.quant}, "
            f"{len(meta.get('quantized', ()))} weights, "
            f"{meta.get('bytes_saved', 0) / 1e6:.1f} MB HBM reads saved "
            "per full weight pass\n")

    def _announce_kv_memory(self) -> None:
        """One-time observability for int8 KV pages and the host tier
        (reference :586)."""
        eng = self._engine
        parts = []
        if eng.kv_quant is not None:
            parts.append(f"kv_quant={eng.kv_quant}")
        if eng.kv_host is not None:
            safe_set("paddle_serving_kv_host_budget_bytes",
                     "byte budget of the host-RAM prefix spill tier",
                     eng.kv_host.max_bytes)
            parts.append(f"host tier {eng.kv_host.max_bytes / 1e6:.1f} MB")
        sys.stderr.write(
            f"[serving] KV memory: {', '.join(parts)} "
            f"({eng.pool.usable} device pages x "
            f"{eng.kv_stats()['page_bytes']} B)\n")

    def _announce_spec(self) -> None:
        """One-time observability for speculative decoding (reference
        :605): gauges and a stderr line."""
        spec = self._engine.spec
        draft = spec.describe_draft()
        safe_set("paddle_serving_spec_enabled",
                 "speculative decoding armed (1 = on)", 1,
                 k=spec.k, draft_quant=spec.draft_quant or "off")
        safe_set("paddle_serving_spec_k",
                 "draft proposals per speculative target step", spec.k)
        sys.stderr.write(
            f"[serving] speculative decoding armed: k={spec.k}, draft "
            f"{draft['params_m']}M params ({draft['hidden_size']}h x "
            f"{draft['num_hidden_layers']}L, quant {draft['quant']})\n")

    # -- admission control ---------------------------------------------------
    def _on_breaker_transition(self, old: str, new: str) -> None:
        sys.stderr.write(f"[serving] circuit breaker {old} -> {new}\n")
        safe_inc("paddle_serving_breaker_transitions_total",
                 "serving circuit-breaker state transitions", to=new)
        safe_set("paddle_serving_breaker_state",
                 "serving breaker state (0 closed, 1 half-open, 2 open)",
                 _BREAKER_STATE_NUM[new])
        _flight.record("breaker", "serving", **{"from": old, "to": new})
        if new == "open" and _flight.is_enabled():
            # capture the black box while the evidence is in the ring; on a
            # thread, since this callback runs under the breaker's lock
            threading.Thread(target=lambda: _flight.dump("breaker_open"),
                             daemon=True, name="flight-breaker-dump").start()

    def _shed(self, reason: str, exc: BaseException) -> None:
        self._bump("shed")
        safe_inc("paddle_serving_shed_total",
                 "requests shed by serving admission control, by reason",
                 reason=reason)
        _flight.record("shed", reason)
        raise exc

    def _queue_depth(self) -> int:
        return self._queue.qsize() + len(self._deferred)

    def _check_admission(self, req: GenerationRequest) -> None:
        """Every reason a request may not enter the queue, cheapest first
        (reference :666-746)."""
        plen = req.prompt_ids.shape[1]
        if req.max_new_tokens < 1:
            raise RequestValidationError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        ml = self._max_len
        if ml is not None and plen + req.max_new_tokens > ml:
            raise RequestValidationError(
                f"prompt {plen} + {req.max_new_tokens} new tokens exceeds "
                f"engine max_len {ml} — shorten the prompt or lower "
                "max_new_tokens")
        if self._top_k_cap is not None and req.top_k > self._top_k_cap:
            raise RequestValidationError(
                f"top_k {req.top_k} exceeds the continuous engine's filter "
                f"cap {self._top_k_cap} (use the static serving mode or "
                "lower top_k)")
        if self._spec_enabled and req.temperature > 0.0:
            raise RequestValidationError(
                f"temperature {req.temperature:g} with speculative "
                "decoding armed: greedy acceptance is token-exact for "
                "temperature 0 only — send temperature=0 or serve this "
                "engine without spec_k")
        if req.prefix_len is not None and not 0 <= req.prefix_len <= plen:
            raise RequestValidationError(
                f"prefix_len {req.prefix_len} must be within the prompt "
                f"(length {plen})")
        if self._kv_capacity is not None:
            # page-pool capacity, not just max_len: a request needing more
            # pages than the pool HOLDS is shed here instead of waiting
            # forever (total need governs even on a prefix hit)
            need = pages_needed(plen + req.max_new_tokens,
                                self._kv_page_size)
            if need > self._kv_capacity:
                self._shed("kv_capacity", KVCapacityError(
                    f"prompt {plen} + {req.max_new_tokens} new tokens needs "
                    f"{need} KV pages (page_size {self._kv_page_size}) but "
                    f"the pool holds only {self._kv_capacity} even when "
                    "empty — raise kv_num_pages or shorten the request",
                    pages_needed=need, pages_capacity=self._kv_capacity))
        if self._draining.is_set():
            self._shed("draining", EngineDrainingError(
                "serving engine is draining; no new requests admitted"))
        breaker = self._breaker
        if breaker._state != "closed" and not breaker.allow():
            self._shed("breaker_open", CircuitOpenError(
                f"decode circuit breaker is open after "
                f"{breaker.consecutive_failures} consecutive failures; "
                "submits fail fast until a half-open probe succeeds",
                retry_after_s=breaker.retry_after_s()))
        if req.deadline is not None and time.monotonic() >= req.deadline:
            self._bump("deadline_expired")
            self._shed("deadline", DeadlineExceededError(
                "request deadline expired before admission"))
        if self._limits_armed:
            depth = self._queue_depth()
            est = self._estimator.estimate_wait_s(depth, self.max_batch_size)
            if self.max_queue is not None and depth >= self.max_queue:
                self._shed("queue_full", ServerOverloadedError(
                    f"serving queue full ({depth} >= max_queue "
                    f"{self.max_queue})", queue_depth=depth,
                    retry_after_s=max(est, self.max_wait)))
            if (self.max_queue_wait_s is not None
                    and est > self.max_queue_wait_s):
                self._shed("queue_wait", ServerOverloadedError(
                    f"estimated queue wait {est:.2f}s exceeds "
                    f"max_queue_wait_s {self.max_queue_wait_s:g}",
                    queue_depth=depth, retry_after_s=est))
        chaos_point("serving.admit")

    # -- client API ----------------------------------------------------------
    @property
    def is_driver(self) -> bool:
        """False on ranks > 0 of a tensor-parallel plan (followers)."""
        return self._engine is None or self._engine.is_driver

    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               top_k=0, eos_token_id=None,
               deadline_s: Optional[float] = None,
               prefix_len: Optional[int] = None,
               trace=None) -> GenerationResult:
        """Queue one generation request; raises a typed error instead of
        queueing when the request cannot (validation) or should not
        (overload, open breaker, draining, expired deadline) be served.
        ``deadline_s`` (else ``default_deadline_s``) is relative to now.
        ``prefix_len`` declares the prompt's first tokens a shared prefix
        (a system prompt) for the paged engine's prompt cache; the static
        scheduler and the contiguous layout ignore it. ``trace`` is a request
        journey (:mod:`..observability.reqtrace`) minted by the caller, which
        then owns it; with none passed and tracing armed, the engine mints
        one and the future closes it."""
        if not self.is_driver:
            raise RuntimeError("this rank follows rank 0 under the plan; "
                               "submit on rank 0")
        dl = deadline_s if deadline_s is not None else self.default_deadline_s
        req = GenerationRequest(
            prompt_ids, max_new_tokens, temperature, top_k, eos_token_id,
            deadline=None if dl is None else time.monotonic() + dl,
            prefix_len=prefix_len)
        self._check_admission(req)
        tr = trace
        if tr is None and _reqtrace.enabled():
            tr = _reqtrace.mint(req.id)
            req.result._trace_owner = tr is not None
        req.result._trace = tr
        if tr is not None:
            tr.event("engine.submit", prompt=req.prompt_ids.shape[1],
                     budget=req.max_new_tokens,
                     queue_depth=self._queue_depth())
        _flight.record("request", str(req.id), phase="submit",
                       prompt=req.prompt_ids.shape[1],
                       budget=req.max_new_tokens,
                       queue_depth=self._queue_depth())
        if self._thread is None:
            self.start()  # lazy start: a future must always have a server
        self._bump("requests")
        self._queue.put(req)
        if self._draining.is_set():
            # lost the race with a concurrent drain(): fail the future here
            # so no caller blocks on a request no server owns
            t = self._thread
            if (t is None or not t.is_alive() or self._drained.is_set()) \
                    and not req.result.done():
                self._bump("shed")
                safe_inc("paddle_serving_shed_total",
                         "requests shed by serving admission control, "
                         "by reason", reason="draining")
                req.result._set(error=EngineDrainingError(
                    "serving engine drained while the request was being "
                    "submitted"))
        return req.result

    def generate(self, prompt_ids, timeout: float = 300.0, **kw) -> np.ndarray:
        return self.submit(prompt_ids, **kw).result(timeout)

    # -- cold-start control --------------------------------------------------
    def warmup(self) -> Dict[str, object]:
        """Warm the continuous engine's whole compile plan before the first
        request (:meth:`BatchDecodeEngine.warmup`). Static mode has no plan
        (its programs are the model's own ``generate_cached``), so it
        returns a no-op summary (reference :814)."""
        if self._engine is None:
            return {"programs": 0, "compiled": 0, "skipped": 0,
                    "wall_s": 0.0, "mode": "static"}
        return self._engine.warmup()

    def save_serving_bundle(self, path: str) -> Dict[str, object]:
        """Write the continuous engine's bundle to ``path``, the artifact
        ``ServingEngine(..., bundle=path)`` loads."""
        if self._engine is None:
            raise ValueError(
                "save_serving_bundle requires the continuous engine")
        return self._engine.save_serving_bundle(path)

    def health(self) -> Dict[str, object]:
        """Readiness and liveness snapshot with the reference's keys
        (:835-928), including the goodput ledger, the SLO burn block and
        the compile-plan / warmup / bundle block."""
        now = time.monotonic()
        alive = self._thread is not None and self._thread.is_alive()
        state = ("draining" if self._draining.is_set() and alive
                 else "serving" if alive else "stopped")
        eng = self._engine
        busy = eng.busy_slots() if eng is not None else 0
        started = self._decode_started_at
        breaker = self._breaker.state
        with self._stats_lock:
            stats = dict(self.stats)
        kv = eng.kv_stats() if eng is not None else {"layout": "none"}
        est = self._estimator.estimate_wait_s(self._queue_depth(),
                                              self.max_batch_size)
        return {
            "state": state,
            "goodput": _goodput.snapshot(),
            "mode": self.mode,
            "slo_burn": _reqtrace.burn_snapshot(),
            "quant": self.quant or "off",
            "kv": kv,
            "spec": (eng.spec_info() if eng is not None
                     else {"enabled": False}),
            "fused": (eng.fused_info() if eng is not None
                      else {"enabled": False}),
            "mesh": (eng.mesh_info() if eng is not None
                     else {"enabled": False}),
            "compile": (eng.compile_info() if eng is not None
                        else {"programs_built": 0, "mode": "static"}),
            "ok": alive and not self._draining.is_set()
                  and breaker != "open",
            "queue_depth": self._queue_depth(),
            "busy_slots": busy,
            "est_wait_s": est,
            "inflight": busy if self.mode == "continuous"
                        else self._static_inflight,
            "pages_free": kv.get("pages_free"),
            "max_slots": self.max_batch_size,
            "max_queue": self.max_queue,
            "breaker": breaker,
            "breaker_consecutive_failures":
                self._breaker.consecutive_failures,
            "decode_inflight_s": 0.0 if started is None else now - started,
            "last_decode_ok_age_s":
                None if self._last_decode_ok is None
                else now - self._last_decode_ok,
            "estimated_queue_wait_s": est,
            "stats": stats,
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is None:
            if self._draining.is_set():
                # restart after a COMPLETED drain: re-open admission and
                # re-arm the failure machinery for the new serving epoch
                self._draining.clear()
                self._breaker.reset()
                self._hang_tripped = False
                self._decode_started_at = None
            self._stop.clear()
            self._drained.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
            if self.decode_timeout_s is not None \
                    and (self._watchdog_thread is None
                         or not self._watchdog_thread.is_alive()):
                self._watchdog_thread = threading.Thread(
                    target=self._watchdog_loop, daemon=True)
                self._watchdog_thread.start()
            if self._drain_on_sigterm:
                self.install_preemption_hook()
            # a running telemetry exporter serves this engine's readiness
            # under /healthz (unique: a second engine must not clobber it)
            served = _exporter.get()
            if served is not None:
                self._health_reg_name = served.register_health(
                    "serving", self.health, unique=True)
        return self

    def install_preemption_hook(self, timeout: Optional[float] = None):
        """Register ``drain(timeout)`` as a preemption callback: a SIGTERM'd
        server finishes in-flight requests (bounded by the drain timeout),
        sheds the rest with a typed error, then exits 143."""
        from ..resilience.preemption import install_preemption_handler

        return install_preemption_handler(
            lambda: self.drain(timeout, reason="sigterm"))

    def drain(self, timeout: Optional[float] = None,
              reason: str = "drain") -> Dict[str, object]:
        """Graceful shutdown (reference :980): stop admission (submits raise
        :class:`EngineDrainingError`), let in-flight requests finish up to
        ``timeout`` seconds (else ``drain_timeout_s``), shed everything
        still waiting with a typed error, then stop the engine thread.
        Idempotent. Returns ``{"clean", "shed", "wall_s"}``."""
        timeout = self.drain_timeout_s if timeout is None else timeout
        t0 = time.monotonic()
        self._drain_reason = str(reason)
        self._draining.set()
        finished = True
        if self._thread is not None:
            finished = self._drained.wait(timeout)
        with self._stats_lock:
            shed_before = self.stats["shed"]
        try:
            self._shutdown(EngineDrainingError(
                "request shed: serving engine drained before it was served"))
        except RuntimeError:
            finished = False       # the engine thread overran the stop join
        with self._stats_lock:
            shed = self.stats["shed"] - shed_before
        safe_inc("paddle_serving_drains_total", "graceful drains completed",
                 outcome="clean" if finished else "timeout",
                 reason=self._drain_reason)
        obs = _obs_srv
        if obs is not None:
            obs("queue_depth", 0)
        return {"clean": finished, "shed": shed,
                "wall_s": round(time.monotonic() - t0, 3)}

    def _shed_waiting(self, error: BaseException) -> int:
        """Fail everything queued or deferred (reference :1015); the engine
        thread must be down or draining-idle."""
        n = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.result.done():
                req.result._set(error=error)
                n += 1
        while self._deferred:
            req = self._deferred.popleft()
            if not req.result.done():
                req.result._set(error=error)
                n += 1
        if n:
            self._bump("shed", n)
            safe_inc("paddle_serving_shed_total",
                     "requests shed by serving admission control, by reason",
                     n, reason=self._drain_reason if isinstance(
                         error, EngineDrainingError) else "stop")
        return n

    def stop(self) -> None:
        """Stop the engine thread; fail whatever is still queued or in a
        decode slot, so no caller blocks on a future nobody serves. A
        running exporter stops reporting this engine under /healthz."""
        served = _exporter.get()
        if served is not None:
            served.unregister_health(
                getattr(self, "_health_reg_name", "serving"), fn=self.health)
        self._shutdown(RuntimeError("serving engine stopped"))

    def _shutdown(self, shed_error: BaseException) -> None:
        self._stop.set()
        overran = False
        if not self.is_driver:
            # a follower serves until rank 0 releases it, or until its
            # loop fails, which ends this rank
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            err, self._follower_error = self._follower_error, None
            if err is not None:
                raise RuntimeError("this rank's follower loop failed; rank "
                                   "0 cannot go on without it") from err
            return
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # keep the handle, so a later submit() cannot start a
                # SECOND loop over the same slot state
                overran = True
            else:
                self._thread = None
        if self._watchdog_thread is not None \
                and not self._watchdog_thread.is_alive():
            self._watchdog_thread = None
        self._shed_waiting(shed_error)
        eng = self._engine
        if eng is not None:
            kind = ("drain" if isinstance(shed_error, EngineDrainingError)
                    else "stop")
            for i, s in enumerate(eng._host_slots):
                if s.req is not None and not s.req.result.done():
                    s.req.result._set(error=shed_error)
                    # mid-flight output abandoned by the shutdown
                    _goodput.account(kind, len(s.emitted))
                    eng._host_slots[i] = type(s)()
            eng.reset_slots()  # no phantom active device lanes
            eng.stop()         # a plan's followers are released
        if overran:
            raise RuntimeError(
                "serving engine thread did not stop within 30 s; "
                "outstanding futures were failed; call stop() again to "
                "re-wait")

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        try:
            self.stop()
        except RuntimeError:
            if exc_type is None:
                raise  # don't mask the with-body's original exception
        return False

    # -- scheduler -----------------------------------------------------------
    def _precheck(self, req: GenerationRequest) -> bool:
        """True when a popped request should be served; cancelled and
        expired ones are failed (shed) here, before they cost any decode."""
        if req.result._event.is_set():  # cancel() already failed the future
            self._bump("cancelled")
            safe_inc("paddle_serving_cancelled_total",
                     "requests cancelled by clients")
            return False
        if req.deadline is not None and time.monotonic() >= req.deadline:
            self._bump("deadline_expired")
            safe_inc("paddle_serving_shed_total",
                     "requests shed by serving admission control, by reason",
                     reason="deadline")
            req.result._set(error=DeadlineExceededError(
                "request deadline expired while queued"))
            return False
        return True

    def _next_request(self, block: bool,
                      timeout: float = 0.05) -> Optional[GenerationRequest]:
        """Pop the next serveable request: the deferred FIFO drains ahead
        of the queue (no reordering behind newer arrivals)."""
        while self._deferred:
            req = self._deferred.popleft()
            if self._precheck(req):
                return req
        while True:
            try:
                req = (self._queue.get(timeout=timeout) if block
                       else self._queue.get_nowait())
            except queue.Empty:
                return None
            if self._precheck(req):
                return req

    def _requeue_expired_sweep(self) -> None:
        """While the breaker is open nothing is popped for decode: sweep the
        waiting set so expired and cancelled requests still shed promptly.
        Queue entries move to the deferred FIFO (which drains first), so
        arrival order is kept (reference :1138)."""
        while True:
            try:
                self._deferred.append(self._queue.get_nowait())
            except queue.Empty:
                break
        self._deferred = deque(r for r in self._deferred
                               if self._precheck(r))

    def _collect_batch(self) -> List[GenerationRequest]:
        """One leader request + everything compatible, up to
        ``max_batch_size`` (reference :1151): first from the deferred FIFO,
        then whatever arrives within the batching window. Incompatible
        arrivals park in the deferred FIFO, so a mismatched request leads
        the next batch instead of starving behind compatible ones."""
        leader = self._next_request(block=True, timeout=0.1)
        if leader is None:
            return []
        if self._breaker.state == "half_open":
            return [leader]     # one-request probe decides the breaker
        batch = [leader]
        keep: "deque[GenerationRequest]" = deque()
        while self._deferred and len(batch) < self.max_batch_size:
            req = self._deferred.popleft()
            if not self._precheck(req):
                continue
            if req.batch_key() == leader.batch_key():
                batch.append(req)
            else:
                keep.append(req)
        self._deferred.extendleft(reversed(keep))  # keep FIFO order
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch_size:
            rest = deadline - time.monotonic()
            if rest <= 0:
                break
            try:
                req = self._queue.get(timeout=rest)
            except queue.Empty:
                break
            if not self._precheck(req):
                continue
            if req.batch_key() == leader.batch_key():
                batch.append(req)
            else:
                self._deferred.append(req)  # next cycle's leader
        return batch

    def _watchdog_loop(self) -> None:
        """A decode attempt in flight longer than ``decode_timeout_s`` trips
        the breaker (reference :1191): the hung thread cannot be
        interrupted, but new submits fail fast and ``health()`` goes
        not-ok instead of the queue growing silently."""
        interval = max(0.005, min(1.0, self.decode_timeout_s / 4))
        while not self._stop.wait(interval):
            started = self._decode_started_at
            if (started is not None and not self._hang_tripped
                    and time.monotonic() - started > self.decode_timeout_s):
                self._hang_tripped = True
                sys.stderr.write(
                    f"[serving] decode in flight for more than "
                    f"{self.decode_timeout_s:g}s — tripping breaker\n")
                safe_inc("paddle_serving_decode_hangs_total",
                         "decode attempts the watchdog declared hung")
                self._breaker.trip()

    def _decode_attempt(self, fn) -> bool:
        """Run one decode attempt (a static batch or a continuous chunk)
        under the hang watchdog (reference :1209). The attempt's clock runs
        until ``fn`` returns, which for a continuous chunk is after its one
        readback: a captured chunk's replay returns at once, and a hung one
        shows only there."""
        self._hang_tripped = False
        self._decode_started_at = time.monotonic()
        try:
            # the chaos seam fires on the host, before the chunk's replay
            # (never inside a capture)
            chaos_point("serving.decode")
            # a host span: a captured chunk's replay returns at once, so the
            # span ends at the chunk's readback
            with trace_region("serving.decode_chunk", "serving"):
                fn()
        finally:
            dt = time.monotonic() - self._decode_started_at
            self._decode_started_at = None
        self._estimator.observe(dt)
        return True

    def _loop(self) -> None:
        try:
            if not self.is_driver:
                try:
                    self._engine.follow()
                except BaseException as e:
                    self._follower_error = e    # stop() raises it
                    raise
            elif self.mode == "continuous":
                self._loop_continuous()
            else:
                self._loop_static()
        finally:
            self._drained.set()

    def _loop_static(self) -> None:
        """Collect a compatible batch, decode it in one ``generate_cached``
        call under the breaker (reference :1244)."""
        while not self._stop.is_set():
            if self._draining.is_set():
                return   # current batch finished; drain() sheds the rest
            obs = _obs_srv
            if obs is not None:
                obs("queue_depth", self._queue_depth())
            if not self._breaker.allow():
                self._requeue_expired_sweep()
                time.sleep(0.02)
                continue
            batch = self._collect_batch()
            if not batch:
                continue
            self._static_inflight = len(batch)
            try:
                self._decode_attempt(lambda: self._run_static_batch(batch))
            except Exception as e:  # noqa: BLE001 — to the callers
                for req in batch:
                    req.result._set(error=e)
                self._bump("batches_failed")
                self._bump("decode_failures")
                self._breaker.record_failure()
                if obs is not None:
                    obs("batch", "error")
                continue
            finally:
                self._static_inflight = 0
            self._breaker.record_success()
            self._last_decode_ok = time.monotonic()
            self._bump("batches")
            self._bump("batched_requests", len(batch))
            if obs is not None:
                obs("batch_size", len(batch))
                obs("batch", "ok")

    def _run_static_batch(self, batch: List[GenerationRequest]) -> None:
        """One ``generate_cached`` call over the batch's prompts (one
        length), at the largest budget; each row is trimmed to its own
        budget and eos (reference :1283). Every request's first token
        reaches the host with the whole batch: TTFT is the batch's
        latency, TPOT is None. The lockstep tail past each row's eos or
        budget is goodput ``overshoot``."""
        ids = np.concatenate([r.prompt_ids for r in batch], axis=0)
        leader = batch[0]
        t_admit = time.perf_counter()
        for req in batch:
            req.result._t_admit = t_admit
            tr = req.result._trace
            if tr is not None:
                tr.event("queue.wait", t0=req.result._t_submit, t1=t_admit)
                tr.event("admit", mode="static", batch=len(batch),
                         plen=leader.prompt_ids.shape[1])
        out = self.model.generate_cached(
            ids, max_new_tokens=max(r.max_new_tokens for r in batch),
            temperature=leader.temperature, top_k=leader.top_k,
            eos_token_id=leader.eos_token_id)
        out = np.asarray(out.numpy())
        t_first = time.perf_counter()
        plen = leader.prompt_ids.shape[1]
        lockstep = max(r.max_new_tokens for r in batch)
        useful = overshoot = 0
        for i, req in enumerate(batch):
            row = out[i, : plen + req.max_new_tokens]
            req.result._t_first = t_first
            req.result._streaming = False
            gen = row[plen:]
            eos = req.eos_token_id
            if eos is not None and eos in gen:  # don't count post-eos pad
                gen = gen[: int(np.argmax(gen == eos)) + 1]
            req.result._n_new = len(gen)
            useful += len(gen)
            overshoot += lockstep - len(gen)
            tr = req.result._trace
            if tr is not None:
                tr.event("decode.batch", t0=t_admit, t1=t_first,
                         tokens=len(gen))
            req.result._set(output=row)
        _goodput.account("useful", useful)
        _goodput.account("overshoot", overshoot)

    def _sweep_slots(self) -> None:
        """Release in-flight slots whose client cancelled or whose deadline
        passed (reference :1328): the device stops spending on them
        mid-decode, and their pages return."""
        eng = self._engine
        now = time.monotonic()
        for i, s in enumerate(eng._host_slots):
            req = s.req
            if req is None:
                continue
            if req.result.done():       # cancelled (first outcome won)
                eng.release_slot(i, reason=getattr(
                    req.result, "_cancel_kind", "cancel"))
                self._bump("cancelled")
                safe_inc("paddle_serving_cancelled_total",
                         "requests cancelled by clients")
            elif req.deadline is not None and now >= req.deadline:
                req.result._set(error=DeadlineExceededError(
                    "request deadline expired mid-decode"))
                eng.release_slot(i, reason="deadline")
                self._bump("deadline_expired")
                safe_inc("paddle_serving_shed_total",
                         "requests shed by serving admission control, "
                         "by reason", reason="deadline")

    def _loop_continuous(self) -> None:
        """Admit queued requests into free decode slots, run decode chunks,
        retire finished slots mid-flight (the engine delivers each future
        on retirement); sweep cancelled and expired slots every cycle, and
        while draining admit nothing and return once the slots are empty
        (reference :1352)."""
        eng = self._engine
        while not self._stop.is_set():
            self._sweep_slots()
            busy = eng.busy_slots() > 0
            draining = self._draining.is_set()
            if draining and not busy:
                return               # in-flight finished; drain() sheds rest
            admitted = False
            if not draining:
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
                                # no free slot: hold at the FIFO head,
                                # decode to free one
                                self._deferred.appendleft(req)
                                break
                        except Exception as e:  # noqa: BLE001 — to the caller
                            req.result._set(error=e)
                elif not busy:
                    self._requeue_expired_sweep()
                    time.sleep(0.02)
                    continue
            obs = _obs_srv
            if obs is not None:
                obs("queue_depth", self._queue_depth())
            if not busy:
                continue
            if obs is not None:
                obs("batch_size", eng.busy_slots())
            before = eng.stats["tokens_out"]
            try:
                self._decode_attempt(eng._decode_chunk)
            except Exception as e:  # noqa: BLE001 — fail the slots
                for i, s in enumerate(eng._host_slots):
                    if s.req is not None:
                        s.req.result._set(error=e)
                        # partial output discarded with the failed chunk
                        _goodput.account("retry_discard", len(s.emitted))
                        eng._host_slots[i] = type(s)()
                eng.reset_slots()  # clear phantom device lanes too
                self._bump("batches_failed")
                self._bump("decode_failures")
                self._breaker.record_failure()
                if obs is not None:
                    obs("batch", "error")
                continue
            self._breaker.record_success()
            self._last_decode_ok = time.monotonic()
            self._bump("decode_tokens", eng.stats["tokens_out"] - before)
            if obs is not None:
                obs("batch", "ok")
            if admitted:
                self._bump("batches")
