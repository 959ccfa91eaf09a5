"""Fleet goodput ledger — attribute every decoded token useful vs wasted.

The port's own copy of the jax-free ``paddlepaddle_tpu/observability/
goodput.py``, unchanged. The port's engine feeds it from the same seams
(``_retire``, ``release_slot``, the spec chunk) and the serving layer from
its waste paths (a failed chunk, drain / stop, static batches); hedged
requests and retries arrive with the fleet (ROADMAP A7).

The serving stack now burns work ON PURPOSE: hedged requests decode the
same prompt twice and throw the loser away, speculative decoding drafts
tokens the verifier rejects, retries discard a failed chunk's partial
output, drains and cancels abandon whatever was mid-flight. Aggregate
``tokens/s`` can therefore look healthy while half the chip is producing
tokens nobody receives. This module is the single ledger that splits the
two: every token the engine stamps into ``stats["tokens_out"]`` is
attributed to exactly one kind, so ``goodput_tok_s`` (useful tokens/s)
and ``waste_pct`` become first-class series the alerts, the bench, and
``perf_gate`` consume.

Kinds (``paddle_goodput_tokens_total{kind=}``):

* ``useful`` — delivered to a caller by a retiring slot (post eos/budget
  trim) or a static batch;
* ``overshoot`` — emitted past eos / past budget and trimmed at
  retirement (the k-token spec chunk's tail, the static batch's padding);
* ``hedge_loser`` — decoded by the replica whose hedge twin won;
* ``retry_discard`` — partial output discarded when a decode chunk
  failed and the slot was failed back to the caller;
* ``cancel`` / ``deadline`` — abandoned mid-decode by a client cancel or
  an expired deadline;
* ``drain`` / ``stop`` — abandoned by a graceful drain or engine stop;
* ``spec_rejected`` — DRAFTED by the speculative decoder and rejected by
  the verifier. These tokens never reached ``tokens_out`` (the draft ran,
  the target did not advance past them), so they sit OUTSIDE the
  reconciliation identity below but are real wasted device work.

Accounting invariant (test-pinned): over any interval,

    sum(counts[k] for k in DECODED_KINDS) == engine stats["tokens_out"]

i.e. every decoded token is attributed exactly once. The engine is the
single accounting point for decoded tokens (``_retire`` /
``release_slot``); the serving/router layers only thread the *reason*
through (``GenerationResult.cancel(reason="hedge_loser")``) — a remote
replica's cancel is a socket disconnect with no reason channel, so a
remote hedge loser folds into ``cancel`` on the replica's own ledger.

The ledger is always on (same contract as ``safe_inc``: waste accounting
must be visible without ``obs.enable()``), costs one lock + dict add per
retirement/chunk — never per token — and never raises into the engine.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

KINDS = ("useful", "overshoot", "hedge_loser", "retry_discard", "cancel",
         "deadline", "drain", "stop", "spec_rejected")

#: kinds whose tokens were stamped into the engine's ``tokens_out`` —
#: their sum reconciles exactly against the decoded-token total.
DECODED_KINDS = tuple(k for k in KINDS if k != "spec_rejected")

#: everything except ``useful`` — the numerator of ``waste_pct``.
WASTE_KINDS = tuple(k for k in KINDS if k != "useful")


def _emit(kind: str, n: int, waste_pct: Optional[float]) -> None:
    # lazy: goodput is imported by the inference hot paths, which must not
    # drag the whole observability package in at import time
    try:
        from . import safe_inc, safe_set

        safe_inc("paddle_goodput_tokens_total",
                 "decoded/drafted tokens attributed useful vs wasted, "
                 "by kind", n, kind=kind)
        if waste_pct is not None:
            safe_set("paddle_goodput_waste_pct",
                     "wasted share of attributed tokens over the sliding "
                     "window, percent (waste_burn alert input)", waste_pct)
    except Exception:
        pass


class GoodputLedger:
    """Monotonic per-kind token counts plus a sliding-window waste gauge.

    The cumulative counters feed the reconciliation identity and the
    bench's per-run diffs; the window (default 60 s) feeds the
    ``paddle_goodput_waste_pct`` gauge so the ``waste_burn`` alert sees a
    hedge storm NOW instead of diluted into the process's lifetime."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in KINDS}
        self._events: deque = deque()   # (t, is_useful, n) in the window
        # running window sums: account() is on the slot-retirement path,
        # so the window must be O(1) amortized, not a deque scan
        self._win_useful = 0
        self._win_waste = 0

    def account(self, kind: str, n: int = 1,
                now: Optional[float] = None) -> Optional[float]:
        """Attribute ``n`` tokens to ``kind``. Returns the current
        sliding-window waste percentage (None until any tokens land)."""
        if kind not in self._counts:
            raise ValueError(f"unknown goodput kind {kind!r} "
                             f"(expected one of {KINDS})")
        n = int(n)
        if n <= 0:
            return None
        t = time.monotonic() if now is None else now
        useful = kind == "useful"
        with self._lock:
            self._counts[kind] += n
            self._events.append((t, useful, n))
            if useful:
                self._win_useful += n
            else:
                self._win_waste += n
            return self._waste_pct_locked(t)

    def _waste_pct_locked(self, now: float) -> Optional[float]:
        edge = now - self.window_s
        ev = self._events
        while ev and ev[0][0] < edge:
            _, useful, n = ev.popleft()
            if useful:
                self._win_useful -= n
            else:
                self._win_waste -= n
        total = self._win_useful + self._win_waste
        if total <= 0:
            return None
        return 100.0 * self._win_waste / total

    def waste_pct(self, now: Optional[float] = None) -> Optional[float]:
        """Sliding-window waste share in percent (None: no recent data)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            return self._waste_pct_locked(t)

    def snapshot(self) -> Dict[str, object]:
        """Cumulative ledger state — the ``health()["goodput"]`` block and
        the bench's before/after diff basis."""
        with self._lock:
            counts = dict(self._counts)
            window = self._waste_pct_locked(time.monotonic())
        useful = counts["useful"]
        decoded = sum(counts[k] for k in DECODED_KINDS)
        wasted = sum(counts[k] for k in WASTE_KINDS)
        attributed = useful + wasted
        return {
            "kinds": counts,
            "useful_tokens": useful,
            "wasted_tokens": wasted,
            "decoded_tokens": decoded,
            "waste_pct": (round(100.0 * wasted / attributed, 3)
                          if attributed else None),
            "window_waste_pct": (None if window is None
                                 else round(window, 3)),
        }

    def reset(self) -> None:
        with self._lock:
            self._counts = {k: 0 for k in KINDS}
            self._events.clear()
            self._win_useful = self._win_waste = 0


# -- module singleton (always on) -------------------------------------------

_ledger = GoodputLedger()


def get() -> GoodputLedger:
    return _ledger


def account(kind: str, n: int = 1) -> None:
    """Best-effort module-level accounting used by the engine/serving/
    router seams: updates the ledger, bumps the registry counter, and
    refreshes the window gauge. Never raises — waste accounting must not
    be the thing that breaks decode."""
    try:
        waste = _ledger.account(kind, n)
    except Exception:
        return
    if n > 0:
        _emit(kind, int(n), waste)


def snapshot() -> Dict[str, object]:
    return _ledger.snapshot()


def reset() -> None:
    _ledger.reset()
