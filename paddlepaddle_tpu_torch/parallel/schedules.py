"""Pipeline schedule builder: static instruction tables for the pipeline
executor (counterpart of ``paddlepaddle_tpu/parallel/schedules.py``, pure
numpy, kept here as the port's own copy: the tables are bit-equal).

Reference surface: the static-graph schedule passes
(python/paddle/distributed/passes/pipeline_scheduler_pass/__init__.py:32-37 —
FThenB / 1F1B / VPP; pipeline_zero_bubble.py:62) and the dygraph runtime
schedules (fleet/meta_parallel/pipeline_parallel.py:575 forward_backward_pipeline,
:1179 PipelineParallelWithInterleave). A schedule is a dense [T, S] opcode
table; each pipeline rank of :func:`~.pipeline_spmd.spmd_pipeline_train`
walks its own column of it, slot by slot.

Schedules produced here differ in *bubble* and *peak activation memory*:

* gpipe  (FThenB):   all forwards, then all backwards; stash O(M).
* 1f1b:              warmup capped at S-s in-flight, then strict B/F
                     alternation; stash O(S) — same bubble as GPipe when
                     t_f == t_b but constant memory in M.
* interleaved (VPP): V chunks per device (virtual stage g = c*S + s runs on
                     device s); warmup (S-s-1)*2 + (V-1)*S; bubble shrinks
                     toward (S-1)/V at the cost of V× stash entries.
* zbh1 (zero-bubble): each inner backward SPLIT into BX (input grad, the
                     critical path) and BW (weight grad, fills bubbles) —
                     slot-count bubble drops well below 1F1B at stash S+1
                     (e.g. S=4 M=16: 0.059 vs 0.158). Under the executor's
                     recompute semantics each split op re-runs the block's
                     forward, one extra forward per microbatch.

Every built schedule is validated by an exact dependency simulator (arrival
one slot after the producing op, one op per device per slot) and annotated
with bubble fraction and the buffer capacities the executor must allocate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

OP_IDLE = 0
OP_F = 1
OP_B = 2        # fused inner backward: cotangent arrives from the right neighbor
OP_B_LAST = 3   # fused backward of the LAST virtual stage: loss grad in-op
OP_BX = 4       # zero-bubble split: input-grad only (critical path)
OP_BW = 5       # zero-bubble split: weight-grad only (fills bubbles)
OP_BX_LAST = 6  # last stage input-grad + loss (loss grad computed in-op)
OP_BW_LAST = 7  # last stage weight-grad (+ head-param grads)

OP_NAMES = {OP_IDLE: ".", OP_F: "F", OP_B: "B", OP_B_LAST: "L",
            OP_BX: "X", OP_BW: "W", OP_BX_LAST: "Y", OP_BW_LAST: "Z"}

_BX_OPS = (OP_B, OP_B_LAST, OP_BX, OP_BX_LAST)   # produce the input cotangent
_BW_OPS = (OP_B, OP_B_LAST, OP_BW, OP_BW_LAST)   # produce the weight grads


@dataclass
class PipelineSchedule:
    """Static schedule: op/mb/chunk tables [T, S] + executor buffer sizes."""

    S: int
    M: int
    V: int
    ops: np.ndarray      # [T, S] int32 opcode
    mbs: np.ndarray      # [T, S] int32 microbatch index of the op
    chunks: np.ndarray   # [T, S] int32 chunk index of the op
    stash_cap: int = 0   # activation stash entries per (device, chunk)
    inbox_f_cap: int = 0  # forward-arrival buffer entries per (device, chunk)
    inbox_b_cap: int = 0  # cotangent-arrival buffer entries per (device, chunk)
    gstash_cap: int = 1  # held cotangents between a split BX and its BW
    stats: Dict = field(default_factory=dict)

    @property
    def T(self) -> int:
        return self.ops.shape[0]

    @property
    def num_virtual(self) -> int:
        return self.V * self.S

    @property
    def has_split_backward(self) -> bool:
        """True when the table carries zero-bubble BX/BW ops — the single
        predicate both the executor's gstash allocation and
        memory_estimate key off (keep them in lockstep)."""
        return int(self.ops.max()) >= OP_BX

    @property
    def gstash_entries(self) -> int:
        """Gstash entries per (device, chunk) the executor actually
        allocates: max(cap, 1) with split ops, zero-size otherwise."""
        return max(self.gstash_cap, 1) if self.has_split_backward else 0

    def memory_estimate(self, act_shape: Tuple[int, ...],
                        dtype_bytes: int = 2) -> Dict[str, int]:
        """Executor buffer bytes PER DEVICE for a microbatch activation of
        ``act_shape`` (e.g. (mb, seq, hidden)): the stash/inbox/gstash
        allocations spmd_pipeline_train actually makes, so a config can be
        memory-checked BEFORE compiling (the reference sizes its p2p and
        recompute buffers the same way, pipeline_parallel.py send/recv
        caches). dacts ([M] cotangents) is included — it scales with M."""
        import math as _m

        act = int(_m.prod(act_shape)) * dtype_bytes
        out = {
            "stash": self.V * self.stash_cap * act,
            "inbox_f": self.V * self.inbox_f_cap * act,
            "inbox_b": self.V * self.inbox_b_cap * act,
            "gstash": self.V * self.gstash_entries * act,
            "dacts": self.M * act,
        }
        out["total"] = sum(out.values())
        return out

    def pretty(self) -> str:
        """Timeline diagram, one row per device (F3 = forward mb 3)."""
        rows = []
        for s in range(self.S):
            cells = []
            for t in range(self.T):
                op = self.ops[t, s]
                if op == OP_IDLE:
                    cells.append("..")
                else:
                    tag = OP_NAMES[int(op)]
                    if self.V > 1:
                        tag += f"{self.chunks[t, s]}"
                    cells.append(f"{tag}{self.mbs[t, s]}")
            rows.append(f"s{s}: " + " ".join(f"{c:>4}" for c in cells))
        return "\n".join(rows)


def _arrival_tables(sched: PipelineSchedule):
    """Derive, for each (t, s): does a forward activation / cotangent arrive
    this slot (produced by a neighbor at t-1), and for which (mb, chunk).

    Forward act: produced by F at virtual stage g on device g%S, consumed by
    g+1 on device (g+1)%S — the up ring. Cotangent: produced by B at g,
    consumed by g-1 — the down ring.
    """
    S, V, T = sched.S, sched.V, sched.T
    G = sched.num_virtual
    fin_v = np.zeros((T, S), np.int32)
    fin_m = np.zeros((T, S), np.int32)
    fin_c = np.zeros((T, S), np.int32)
    bin_v = np.zeros((T, S), np.int32)
    bin_m = np.zeros((T, S), np.int32)
    bin_c = np.zeros((T, S), np.int32)
    for t in range(1, T):
        for s in range(S):
            left = (s - 1) % S
            op = sched.ops[t - 1, left]
            if op == OP_F:
                g = sched.chunks[t - 1, left] * S + left
                if g + 1 < G and (g + 1) % S == s:
                    fin_v[t, s] = 1
                    fin_m[t, s] = sched.mbs[t - 1, left]
                    fin_c[t, s] = (g + 1) // S
            right = (s + 1) % S
            op = sched.ops[t - 1, right]
            if op in _BX_OPS:
                g = sched.chunks[t - 1, right] * S + right
                if g - 1 >= 0 and (g - 1) % S == s:
                    bin_v[t, s] = 1
                    bin_m[t, s] = sched.mbs[t - 1, right]
                    bin_c[t, s] = (g - 1) // S
    return fin_v, fin_m, fin_c, bin_v, bin_m, bin_c


def validate(sched: PipelineSchedule) -> PipelineSchedule:
    """Exact dependency check + buffer sizing. Raises on an illegal schedule.

    Rules (one-hop ring transport, one slot latency):
      F(m, g):       g == 0, or F(m, g-1) done at slot <= t-1
      BX(m, G-1):    F(m, G-1) done at slot <= t-1 (loss grad computed in-op)
      BX(m, g<G-1):  F(m, g) done and BX(m, g+1) done at slot <= t-1
      BW(m, g):      BX(m, g) done at slot <= t-1 (same device)
      fused B = BX+BW in one slot; one op per (t, device); every (m, g)
      gets exactly one F and (one fused B) or (one BX and one BW).
    The activation stash entry lives F -> BW (fused B frees it immediately);
    a split BX parks its arrived cotangent in the gstash until its BW.
    """
    S, M, V = sched.S, sched.M, sched.V
    G = sched.num_virtual
    doneF: Dict[Tuple[int, int], int] = {}
    doneBX: Dict[Tuple[int, int], int] = {}
    doneBW: Dict[Tuple[int, int], int] = {}
    stash = np.zeros((S, V), np.int64)    # outstanding F-not-BW per (device, chunk)
    gstash = np.zeros((S, V), np.int64)   # cotangents parked BX -> BW
    inbox_f = np.zeros((S, V), np.int64)  # delivered acts not yet consumed
    inbox_b = np.zeros((S, V), np.int64)
    max_stash = max_if = max_ib = max_gs = 0
    fin_v, fin_m, fin_c, bin_v, bin_m, bin_c = _arrival_tables(sched)
    for t in range(sched.T):
        for s in range(S):
            if fin_v[t, s]:
                inbox_f[s, fin_c[t, s]] += 1
            if bin_v[t, s]:
                inbox_b[s, bin_c[t, s]] += 1
        max_if = max(max_if, inbox_f.max())
        max_ib = max(max_ib, inbox_b.max())
        for s in range(S):
            op = int(sched.ops[t, s])
            if op == OP_IDLE:
                continue
            m, c = int(sched.mbs[t, s]), int(sched.chunks[t, s])
            g = c * S + s
            if not (0 <= m < M and 0 <= c < V):
                raise ValueError(f"slot {t} dev {s}: bad (m={m}, c={c})")
            want_last = (g == G - 1)
            if op == OP_F:
                if (m, g) in doneF:
                    raise ValueError(f"duplicate F(m={m}, g={g})")
                if g > 0:
                    if doneF.get((m, g - 1), t) > t - 1:
                        raise ValueError(
                            f"slot {t} dev {s}: F(m={m},g={g}) before upstream")
                    inbox_f[s, c] -= 1
                doneF[(m, g)] = t
                stash[s, c] += 1
            elif op in (OP_B, OP_B_LAST, OP_BX, OP_BX_LAST):
                if (op in (OP_B_LAST, OP_BX_LAST)) != want_last:
                    raise ValueError(
                        f"slot {t} dev {s}: opcode {op} vs virtual stage {g}")
                if (m, g) in doneBX:
                    raise ValueError(f"duplicate BX(m={m}, g={g})")
                if doneF.get((m, g), t) > t - 1:
                    raise ValueError(f"slot {t} dev {s}: B(m={m},g={g}) before F")
                if g < G - 1:
                    if doneBX.get((m, g + 1), t) > t - 1:
                        raise ValueError(
                            f"slot {t} dev {s}: B(m={m},g={g}) before downstream B")
                    inbox_b[s, c] -= 1
                doneBX[(m, g)] = t
                if op in (OP_B, OP_B_LAST):      # fused: weight grad too
                    doneBW[(m, g)] = t
                    stash[s, c] -= 1
                else:
                    if op == OP_BX:              # park the cotangent for BW
                        gstash[s, c] += 1
            elif op in (OP_BW, OP_BW_LAST):  # see _BW_OPS
                if (op == OP_BW_LAST) != want_last:
                    raise ValueError(
                        f"slot {t} dev {s}: opcode {op} vs virtual stage {g}")
                if (m, g) in doneBW:
                    raise ValueError(f"duplicate BW(m={m}, g={g})")
                if doneBX.get((m, g), t) > t - 1:
                    raise ValueError(f"slot {t} dev {s}: BW(m={m},g={g}) before BX")
                doneBW[(m, g)] = t
                stash[s, c] -= 1
                if op == OP_BW:
                    gstash[s, c] -= 1
            else:
                raise ValueError(f"slot {t} dev {s}: unknown opcode {op}")
        max_stash = max(max_stash, stash.max())
        max_gs = max(max_gs, gstash.max())
        if (inbox_f < 0).any() or (inbox_b < 0).any():
            raise ValueError(f"slot {t}: consumed an arrival that never came")
    if len(doneF) != M * G or len(doneBX) != M * G or len(doneBW) != M * G:
        raise ValueError(
            f"incomplete schedule: {len(doneF)}/{M * G} F, "
            f"{len(doneBX)}/{M * G} BX, {len(doneBW)}/{M * G} BW")
    sched.stash_cap = max(int(max_stash), 1)
    sched.inbox_f_cap = max(int(max_if), 1)
    sched.inbox_b_cap = max(int(max_ib), 1)
    sched.gstash_cap = max(int(max_gs), 1)
    _check_slot_collisions(sched, fin_v, fin_m, fin_c, bin_v, bin_m, bin_c)
    busy = int((sched.ops != OP_IDLE).sum())
    sched.stats = {
        "T": sched.T,
        "busy_slots": busy,
        "total_slots": sched.T * S,
        "bubble_fraction": 1.0 - busy / (sched.T * S),
        "stash_cap": sched.stash_cap,
    }
    return sched


def _check_slot_collisions(sched: PipelineSchedule, fin_v, fin_m, fin_c,
                           bin_v, bin_m, bin_c) -> None:
    """The executor addresses stash/inbox entries as ``m % cap``; bounding the
    peak COUNT (stash_cap et al.) is not enough if a legal-but-out-of-order
    schedule makes two live microbatches share a modular slot. Re-simulate
    occupancy at the executor's addressing granularity and reject collisions.
    """
    S, V = sched.S, sched.V
    stash: Dict[Tuple[int, int, int], int] = {}   # (s, c, m % cap) -> m
    gst: Dict[Tuple[int, int, int], int] = {}
    inf: Dict[Tuple[int, int, int], int] = {}
    inb: Dict[Tuple[int, int, int], int] = {}

    def occupy(buf, keyname, s, c, m, cap, t):
        key = (s, c, m % cap)
        prev = buf.get(key)
        if prev is not None and prev != m:
            raise ValueError(
                f"slot {t} dev {s}: {keyname} collision — microbatches {prev} "
                f"and {m} of chunk {c} both live in slot m%{cap}; the "
                "executor's modular addressing needs a contiguous outstanding "
                "window (reorder the schedule or grow its buffers)")
        buf[key] = m

    for t in range(sched.T):
        for s in range(S):
            if fin_v[t, s]:
                occupy(inf, "forward-inbox", s, int(fin_c[t, s]),
                       int(fin_m[t, s]), sched.inbox_f_cap, t)
            if bin_v[t, s]:
                occupy(inb, "cotangent-inbox", s, int(bin_c[t, s]),
                       int(bin_m[t, s]), sched.inbox_b_cap, t)
        for s in range(S):
            op = int(sched.ops[t, s])
            if op == OP_IDLE:
                continue
            m, c = int(sched.mbs[t, s]), int(sched.chunks[t, s])
            if op == OP_F:
                occupy(stash, "stash", s, c, m, sched.stash_cap, t)
                inf.pop((s, c, m % sched.inbox_f_cap), None)
            elif op in (OP_BX, OP_BX_LAST):
                inb.pop((s, c, m % sched.inbox_b_cap), None)
                if op == OP_BX:
                    occupy(gst, "gstash", s, c, m, sched.gstash_cap, t)
            else:  # fused B / BW: the activation stash entry is released
                stash.pop((s, c, m % sched.stash_cap), None)
                inb.pop((s, c, m % sched.inbox_b_cap), None)
                if op == OP_BW:
                    gst.pop((s, c, m % sched.gstash_cap), None)


def _pack(events: List[Tuple[int, int, int, int, int]], S: int, M: int,
          V: int) -> PipelineSchedule:
    """events: (t, s, op, m, c) -> dense tables."""
    T = max(t for t, *_ in events) + 1
    ops = np.zeros((T, S), np.int32)
    mbs = np.zeros((T, S), np.int32)
    chunks = np.zeros((T, S), np.int32)
    for t, s, op, m, c in events:
        if ops[t, s] != OP_IDLE:
            raise ValueError(f"two ops in slot {t} dev {s}")
        ops[t, s], mbs[t, s], chunks[t, s] = op, m, c
    return validate(PipelineSchedule(S=S, M=M, V=V, ops=ops, mbs=mbs, chunks=chunks))


def build_gpipe(S: int, M: int) -> PipelineSchedule:
    """FThenB: forward wavefront F(m,s)@(m+s), then reverse backward
    wavefront. Stash grows to M per device — the memory cost 1F1B removes."""
    events = []
    for m in range(M):
        for s in range(S):
            events.append((m + s, s, OP_F, m, 0))
    t0 = M + S - 1
    for m in reversed(range(M)):
        for s in reversed(range(S)):
            t = t0 + (M - 1 - m) + (S - 1 - s)
            events.append((t, s, OP_B_LAST if s == S - 1 else OP_B, m, 0))
    return _pack(events, S, M, 1)


def _device_order(S: int, M: int, V: int, s: int) -> List[Tuple[str, int, int]]:
    """Per-device op sequence ('F'/'B', m, c) — warmup forwards, then strict
    1F/1B alternation, then cooldown backwards (the reference's
    forward_backward_pipeline / PipelineParallelWithInterleave order).
    Forwards cycle chunks in groups of S microbatches; backwards mirror the
    pattern with the chunk order reversed."""
    if V == 1:
        f_list = [(m, 0) for m in range(M)]
        b_list = [(m, 0) for m in range(M)]
        warm = min(M, S - 1 - s)
    else:
        f_list = [(r * S + i, c)
                  for r in range(M // S) for c in range(V) for i in range(S)]
        b_list = [(r * S + i, c)
                  for r in range(M // S) for c in reversed(range(V)) for i in range(S)]
        warm = min(M * V, (S - s - 1) * 2 + (V - 1) * S)
    order: List[Tuple[str, int, int]] = []
    fi = bi = 0
    for _ in range(warm):
        m, c = f_list[fi]
        order.append(("F", m, c))
        fi += 1
    while fi < len(f_list):
        m, c = f_list[fi]
        order.append(("F", m, c))
        fi += 1
        m, c = b_list[bi]
        order.append(("B", m, c))
        bi += 1
    while bi < len(b_list):
        m, c = b_list[bi]
        order.append(("B", m, c))
        bi += 1
    return order


def build_1f1b(S: int, M: int, V: int = 1) -> PipelineSchedule:
    """1F1B (V=1) / interleaved VPP (V>1): in-order execution of each
    device's warmup/steady/cooldown sequence, stalling only on data
    dependencies (one-slot ring latency). V=1 reproduces the classic 1F1B
    timeline (T = 2(M+S-1), stash <= S-s); V>1 reproduces the interleaved
    schedule whose bubble shrinks toward (S-1)/V ramp slots."""
    if M % S and V > 1:
        raise ValueError(f"interleaved schedule needs M % S == 0, got M={M} S={S}")
    G = V * S
    doneF: Dict[Tuple[int, int], int] = {}
    doneB: Dict[Tuple[int, int], int] = {}
    orders = [_device_order(S, M, V, s) for s in range(S)]
    pos = [0] * S
    events: List[Tuple[int, int, int, int, int]] = []
    t = 0
    limit = 8 * (M * G + S) + 64
    while any(pos[s] < len(orders[s]) for s in range(S)) and t < limit:
        for s in range(S):
            if pos[s] >= len(orders[s]):
                continue
            kind, m, c = orders[s][pos[s]]
            g = c * S + s
            if kind == "F":
                if g > 0 and doneF.get((m, g - 1), t) > t - 1:
                    continue  # stall: upstream act not delivered yet
                events.append((t, s, OP_F, m, c))
                doneF[(m, g)] = t
            else:
                if doneF.get((m, g), t) > t - 1:
                    continue
                if g < G - 1 and doneB.get((m, g + 1), t) > t - 1:
                    continue  # stall: cotangent not delivered yet
                events.append((t, s, OP_B_LAST if g == G - 1 else OP_B, m, c))
                doneB[(m, g)] = t
            pos[s] += 1
        t += 1
    if any(pos[s] < len(orders[s]) for s in range(S)):
        raise RuntimeError(f"pipeline scheduler deadlocked (S={S}, M={M}, V={V})")
    return _pack(events, S, M, V)


def build_zbh1(S: int, M: int) -> PipelineSchedule:
    """ZBH1 (zero-bubble, handshake-1): each inner backward is SPLIT into
    BX (input grad — stays on the 1F1B critical path) and BW (weight grad —
    fills what would otherwise be bubble slots, especially the cooldown).

    Reference: passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:62
    (PipelineZeroBubblePipelineParallel job order F/B/W). Built by a greedy
    list scheduler per device with priority BX > F > BW, F admission capped
    1F1B-style (at most S-s microbatches in flight before their BX), BW
    forced when the activation stash would exceed the 1F1B bound (S+1) —
    bubble drops below 1F1B at EQUAL memory cap, which the validator
    certifies exactly.

    Under the executor's recompute semantics each of BX and BW re-runs the
    block's forward (one extra forward per microbatch vs fused B).
    """
    G = S
    doneF: Dict[Tuple[int, int], int] = {}
    doneBX: Dict[Tuple[int, int], int] = {}
    fi = [0] * S                      # next microbatch to forward, per device
    bx = [0] * S                      # next microbatch to BX, per device
    pending_bw: List[List[int]] = [[] for _ in range(S)]
    stash_now = [0] * S               # F-not-BW entries (activation memory)
    stash_cap_target = S + 1
    events: List[Tuple[int, int, int, int, int]] = []
    t = 0
    limit = 8 * (3 * M + S) + 64
    while any(fi[s] < M or bx[s] < M or pending_bw[s] for s in range(S)) \
            and t < limit:
        for s in range(S):
            g = s
            # 1) BX if its inputs have arrived (critical path)
            m = bx[s]
            if m < M and doneF.get((m, g), t) <= t - 1 and (
                    g == G - 1 or doneBX.get((m, g + 1), t) <= t - 1):
                op = OP_BX_LAST if g == G - 1 else OP_BX
                events.append((t, s, op, m, 0))
                doneBX[(m, g)] = t
                pending_bw[s].append(m)
                bx[s] += 1
                continue
            # 2) forward, unless the 1F1B in-flight cap or stash bound says no
            m = fi[s]
            can_f = (m < M and (g == 0 or doneF.get((m, g - 1), t) <= t - 1)
                     and (fi[s] - bx[s]) < max(S - s, 1)
                     and stash_now[s] < stash_cap_target)
            if can_f:
                events.append((t, s, OP_F, m, 0))
                doneF[(m, g)] = t
                fi[s] += 1
                stash_now[s] += 1
                continue
            # 3) fill the bubble with a weight grad
            if pending_bw[s]:
                m = pending_bw[s].pop(0)
                op = OP_BW_LAST if g == G - 1 else OP_BW
                events.append((t, s, op, m, 0))
                stash_now[s] -= 1
        t += 1
    if any(fi[s] < M or bx[s] < M or pending_bw[s] for s in range(S)):
        raise RuntimeError(f"zbh1 scheduler deadlocked (S={S}, M={M})")
    return _pack(events, S, M, 1)


def build_zbvpp(S: int, M: int, V: int) -> PipelineSchedule:
    """ZBVPP (zero-bubble interleaved): VPP's virtual-stage order with every
    inner backward SPLIT into BX (input grad, critical path) and BW (weight
    grad, fills bubbles) — the last entry in the reference's schedule zoo
    (passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:151,
    VPP job order + F/B/W split).

    Construction: each device walks its VPP order (warmup forwards, then
    F/B alternation over chunks — _device_order), with B meaning BX; a slot
    where the ordered op must stall on a dependency is filled with the
    oldest pending BW instead of idling, and a BW is forced ahead of a
    forward whenever the activation stash would exceed the VPP bound + 1 —
    the ZBH1 memory contract lifted to V chunks. The exact validator
    certifies dependencies and computes the true buffer caps.

    Same recompute economics as ZBH1 (each split op re-runs the block).
    """
    if M % S:
        raise ValueError(f"zbvpp needs M % S == 0, got M={M} S={S}")
    if V < 2:
        raise ValueError("zbvpp is the V>1 zero-bubble schedule; use zbh1 for V=1")
    G = V * S
    # memory contract: per-(device, chunk) stash bound = VPP's + 1, so the
    # executor buffers match interleaved 1F1B's up to one extra entry
    vpp_cap = build_1f1b(S, M, V=V).stash_cap
    stash_target = vpp_cap + 1
    orders = [_device_order(S, M, V, s) for s in range(S)]
    pos = [0] * S
    doneF: Dict[Tuple[int, int], int] = {}
    doneBX: Dict[Tuple[int, int], int] = {}
    pending_bw: List[List[Tuple[int, int]]] = [[] for _ in range(S)]
    stash_now = [[0] * V for _ in range(S)]   # per (device, chunk)
    events: List[Tuple[int, int, int, int, int]] = []
    t = 0
    limit = 8 * (3 * M * V + S) + 64

    def emit_bw(t, s, chunk=None):
        """Retire the oldest pending weight-grad (preferring ``chunk`` when a
        specific chunk's stash needs shrinking)."""
        i = 0
        if chunk is not None:
            for j, (_, cj) in enumerate(pending_bw[s]):
                if cj == chunk:
                    i = j
                    break
        m, c = pending_bw[s].pop(i)
        g = c * S + s
        events.append((t, s, OP_BW_LAST if g == G - 1 else OP_BW, m, c))
        stash_now[s][c] -= 1

    while any(pos[s] < len(orders[s]) or pending_bw[s] for s in range(S)) \
            and t < limit:
        for s in range(S):
            if pos[s] >= len(orders[s]):
                if pending_bw[s]:
                    emit_bw(t, s)
                continue
            kind, m, c = orders[s][pos[s]]
            g = c * S + s
            if kind == "B":
                ready = (doneF.get((m, g), t) <= t - 1
                         and (g == G - 1 or doneBX.get((m, g + 1), t) <= t - 1))
                if ready:
                    events.append(
                        (t, s, OP_BX_LAST if g == G - 1 else OP_BX, m, c))
                    doneBX[(m, g)] = t
                    pending_bw[s].append((m, c))
                    pos[s] += 1
                elif pending_bw[s]:
                    emit_bw(t, s)   # fill the stall with weight-grad work
                continue
            # kind == "F"
            if stash_now[s][c] >= stash_target and any(
                    cj == c for _, cj in pending_bw[s]):
                emit_bw(t, s, chunk=c)  # memory bound: retire this chunk first
                continue
            ready = g == 0 or doneF.get((m, g - 1), t) <= t - 1
            if ready:
                events.append((t, s, OP_F, m, c))
                doneF[(m, g)] = t
                stash_now[s][c] += 1
                pos[s] += 1
            elif pending_bw[s]:
                emit_bw(t, s)
        t += 1
    if any(pos[s] < len(orders[s]) or pending_bw[s] for s in range(S)):
        raise RuntimeError(f"zbvpp scheduler deadlocked (S={S}, M={M}, V={V})")
    return _pack(events, S, M, V)


def build_schedule(name: str, S: int, M: int, V: int = 1) -> PipelineSchedule:
    """Schedule zoo entry point: 'gpipe'/'FThenB', '1f1b',
    'interleaved'/'vpp', 'zbh1'/'zero-bubble', 'zbvpp'."""
    key = name.lower()
    if key in ("gpipe", "fthenb", "f_then_b"):
        if V != 1:
            raise ValueError("gpipe has no virtual stages")
        return build_gpipe(S, M)
    if key == "1f1b":
        if V != 1:
            raise ValueError(
                "1f1b has no virtual stages; use schedule='interleaved' for V>1")
        return build_1f1b(S, M, V=1)
    if key in ("interleaved", "vpp", "1f1b-interleaved"):
        return build_1f1b(S, M, V=V)
    if key in ("zbh1", "zb", "zero-bubble"):
        if V != 1:
            raise ValueError("zbh1 is a V=1 schedule; use 'zbvpp' for V>1")
        return build_zbh1(S, M)
    if key in ("zbvpp", "zbv", "zero-bubble-vpp"):
        return build_zbvpp(S, M, V=V)  # V<2 raises: the caller's stage
        # layout must match the chunk count, so no silent coercion
    raise ValueError(f"unknown schedule {name!r}")
