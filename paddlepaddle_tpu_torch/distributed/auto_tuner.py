"""Auto-tuner — parallel-config search with pruning rules, a cost model,
and a trial recorder (counterpart of
``paddlepaddle_tpu/distributed/auto_tuner.py`` :1-311).

Reference surface: python/paddle/distributed/auto_tuner/ (search.py
candidate generation over dp/mp/pp/sharding/micro-batch degrees, prune.py's
registry of pruning rules with logged reasons, recorder.py trial history
with resume, cost-model ranking).

Candidates are mesh shapes (dp x fsdp x tp x pp) over the device count
plus a microbatch count for pp configs. Pruning combines a memory model
(params/grads/Adam state/activations per device) with model-shape
divisibility rules (heads % tp, layers % pp, vocab % tp, batch % data
degree), each reporting WHY a config died. Ranking uses a step-time cost
model: tensor-core compute time + link time of the collectives (dp/fsdp
gradient reduce-scatter + all-gather, per-layer tp activation all-reduces)
+ pipeline bubble amplification; ``tune(run_fn)`` measures the survivors
for ground truth, recording every trial to a jsonl history that later runs
resume from, scoped per (model, topology).

The model is the JAX package's, formula for formula; its defaults are the
card's (:class:`AutoTuner`): with the JAX package's numbers passed
explicitly, candidates, prune reasons, estimates and rank order are its.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class ModelSpec:
    """What the tuner needs to know about the model/job."""

    num_params: int
    batch_size: int
    seq_len: int
    hidden: int
    layers: int
    heads: int = 0            # 0 = unknown: head rules skipped
    kv_heads: int = 0
    vocab: int = 0


@dataclass
class TuneConfig:
    dp: int
    fsdp: int
    tp: int
    pp: int
    microbatches: int = 1
    est_param_bytes_per_chip: float = 0.0
    est_activation_bytes_per_chip: float = 0.0
    est_total_bytes_per_chip: float = 0.0
    est_step_time: float = 0.0
    measured_step_time: Optional[float] = None
    pruned_reason: Optional[str] = None

    @property
    def degrees(self):
        return {"dp_degree": self.dp, "sharding_degree": self.fsdp,
                "mp_degree": self.tp, "pp_degree": self.pp,
                "micro_batches": self.microbatches}

    def key(self) -> str:
        return f"dp{self.dp}_fsdp{self.fsdp}_tp{self.tp}_pp{self.pp}_mb{self.microbatches}"

    def __repr__(self):
        t = f", {self.measured_step_time * 1e3:.1f} ms" if self.measured_step_time else ""
        return (f"TuneConfig(dp={self.dp} fsdp={self.fsdp} tp={self.tp} "
                f"pp={self.pp} mb={self.microbatches}, "
                f"~{self.est_total_bytes_per_chip / 2**30:.2f} GiB/chip, "
                f"~{self.est_step_time * 1e3:.2f} ms est{t})")


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


class Recorder:
    """Trial history (reference recorder.py): append-only jsonl, resumable."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history: Dict[str, dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        self.history[rec["key"]] = rec
                    except (json.JSONDecodeError, KeyError):
                        continue

    def seen(self, cfg: TuneConfig, scope: str = "") -> Optional[dict]:
        return self.history.get(f"{scope}__{cfg.key()}")

    def record(self, cfg: TuneConfig, step_time: Optional[float],
               error: Optional[str] = None, scope: str = ""):
        rec = {"key": f"{scope}__{cfg.key()}", **cfg.degrees,
               "est_step_time": cfg.est_step_time,
               "est_bytes_per_chip": cfg.est_total_bytes_per_chip,
               "measured_step_time": step_time, "error": error}
        self.history[cfg.key()] = rec
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def best(self) -> Optional[dict]:
        done = [r for r in self.history.values()
                if r.get("measured_step_time") is not None]
        return min(done, key=lambda r: r["measured_step_time"]) if done else None


# Defaults of the cost model: one H100 SXM5 (80 GB HBM3) of an NVLink
# host. peak_flops: the H100 SXM datasheet's dense bf16 tensor-core rate,
# 989 TFLOP/s (the figure PERF.md's bounds use). link bandwidth: NVLink 4
# on the H100 SXM datasheet, 900 GB/s per card both directions together,
# so 450 GB/s a direction (the model's "bytes/s per link direction").
H100_PEAK_BF16_FLOPS = 989e12
H100_NVLINK_BYTES_PER_S = 450e9
# the launch cost of one collective, a lower bound: a one-float NCCL
# all-reduce at world size 1 on an H100 80GB HBM3 (700 W), host-timed with
# a sync, the median of 200 in chip_smoke.py's nccl_world1 phase: 31.0,
# 47.9, 47.9 and 55.1 us in four runs. It crosses no link (host launch and
# sync only); a hop between cards adds to it and is not measured yet
H100_COLLECTIVE_LATENCY_S = 48e-6


def _card_memory() -> float:
    import torch

    if not torch.cuda.is_available():
        raise ValueError(
            "AutoTuner: no card to read the device memory from; pass "
            "hbm_bytes= (bytes of one device's memory)")
    return float(torch.cuda.get_device_properties(0).total_memory)


class AutoTuner:
    """``hbm_bytes`` defaults to the card's memory
    (``torch.cuda.get_device_properties(0).total_memory``) and is needed as
    an argument where there is no card; ``peak_flops``, ``ici_bandwidth``
    (bytes/s a link direction) and ``collective_latency`` default to an
    H100 SXM's (see the constants above)."""

    def __init__(self, num_devices: int, hbm_bytes: Optional[float] = None,
                 param_dtype_bytes: int = 2, master_weights: bool = True,
                 optimizer_slots: int = 2,
                 peak_flops: float = H100_PEAK_BF16_FLOPS,
                 ici_bandwidth: float = H100_NVLINK_BYTES_PER_S,
                 collective_latency: float = H100_COLLECTIVE_LATENCY_S,
                 history_path: Optional[str] = None):
        self.num_devices = num_devices
        self.hbm_bytes = (_card_memory() if hbm_bytes is None
                          else float(hbm_bytes))
        self.param_bytes = param_dtype_bytes
        # Adam: m+v fp32 (+ fp32 master when training low-precision)
        self.state_bytes = 4 * optimizer_slots + (4 if master_weights else 0)
        self.peak_flops = peak_flops
        self.ici_bw = ici_bandwidth  # bytes/s per link direction
        self.latency = collective_latency  # per-collective launch+hop cost
        self.recorder = Recorder(history_path)

    # -- candidate generation (reference search.py) --------------------------
    def candidates(self, max_tp: int = 8, max_pp: int = 8,
                   spec: Optional[ModelSpec] = None) -> List[TuneConfig]:
        out = []
        n = self.num_devices
        for tp in _divisors(n):
            if tp > max_tp:
                continue
            for pp in _divisors(n // tp):
                if pp > max_pp:
                    continue
                rest = n // (tp * pp)
                for fsdp in _divisors(rest):
                    dp = rest // fsdp
                    if pp == 1:
                        out.append(TuneConfig(dp=dp, fsdp=fsdp, tp=tp, pp=pp))
                        continue
                    # pp: tune the microbatch count too (bubble vs per-mb
                    # efficiency); candidates from the local batch's divisors
                    local_b = (spec.batch_size // max(dp * fsdp, 1)
                               if spec else 8)
                    mbs = sorted({m for m in _divisors(max(local_b, 1))
                                  if m >= pp} | {max(local_b, pp)})
                    # smallest three plus the full-microbatching best-bubble
                    # candidate (which a plain prefix slice would drop)
                    chosen = mbs[:3] + ([mbs[-1]] if mbs[-1] not in mbs[:3]
                                        else [])
                    for m in chosen:
                        out.append(TuneConfig(dp=dp, fsdp=fsdp, tp=tp, pp=pp,
                                              microbatches=m))
        return out

    # -- pruning rules (reference prune.py registry) -------------------------
    def _rules(self, spec: ModelSpec, headroom: float = 0.9):
        def mem(c):
            if c.est_total_bytes_per_chip > self.hbm_bytes * headroom:
                return (f"memory {c.est_total_bytes_per_chip / 2**30:.1f} GiB "
                        f"> {headroom:.0%} of {self.hbm_bytes / 2**30:.0f} GiB")

        def heads_divisible(c):
            if spec.heads and spec.heads % c.tp:
                return f"heads {spec.heads} % tp {c.tp} != 0"
            if spec.kv_heads and c.tp > 1 and spec.kv_heads % c.tp:
                return f"kv_heads {spec.kv_heads} % tp {c.tp} != 0"

        def layers_divisible(c):
            if c.pp > 1 and spec.layers % c.pp:
                return f"layers {spec.layers} % pp {c.pp} != 0"

        def vocab_divisible(c):
            if spec.vocab and c.tp > 1 and spec.vocab % c.tp:
                return f"vocab {spec.vocab} % tp {c.tp} != 0"

        def batch_divisible(c):
            data = c.dp * c.fsdp
            if spec.batch_size % data:
                return f"batch {spec.batch_size} % data degree {data} != 0"
            if c.pp > 1:
                local = spec.batch_size // data
                if local % c.microbatches:
                    return (f"local batch {local} % microbatches "
                            f"{c.microbatches} != 0")

        return [mem, heads_divisible, layers_divisible, vocab_divisible,
                batch_divisible]

    # -- memory + step-time models ------------------------------------------
    def estimate(self, cfg: TuneConfig, spec: ModelSpec) -> TuneConfig:
        n, b, s, h, L = (spec.num_params, spec.batch_size, spec.seq_len,
                         spec.hidden, spec.layers)
        shard = cfg.tp * cfg.fsdp * cfg.pp
        p_bytes = n * self.param_bytes / shard
        g_bytes = n * self.param_bytes / shard
        s_bytes = n * self.state_bytes / shard
        data = max(cfg.dp * cfg.fsdp, 1)
        micro_b = max(1, b // data)
        layers_per_stage = max(1, L // cfg.pp)
        # remat-style footprint: boundary activation per layer (+ 1F1B stash
        # of pp in-flight microbatch boundaries)
        act = (micro_b * s * h * self.param_bytes
               * layers_per_stage / max(cfg.tp, 1))
        if cfg.pp > 1:
            act = act / max(cfg.microbatches, 1) * min(cfg.pp, cfg.microbatches)
        cfg.est_param_bytes_per_chip = p_bytes
        cfg.est_activation_bytes_per_chip = act
        cfg.est_total_bytes_per_chip = p_bytes + g_bytes + s_bytes + act

        # step-time cost model: compute + collectives + pipeline bubble
        tokens_per_chip = b * s / data
        compute = 6.0 * n / (cfg.tp * cfg.pp) * tokens_per_chip / self.peak_flops
        # dp/fsdp grad sync: reduce-scatter + all-gather of the local param
        # shard bytes, ring time ~ 2 * bytes * (d-1)/d / bw
        grad_bytes = n * self.param_bytes / (cfg.tp * cfg.pp)
        comm_dp = (2.0 * grad_bytes * (data - 1) / max(data, 1) / self.ici_bw
                   + 2.0 * self.latency if data > 1 else 0.0)
        # tp: ~4 activation allreduces per layer of [b_local, s, h] bytes,
        # each paying launch latency — many small collectives is what makes
        # tp lose on small models
        comm_tp = (4.0 * layers_per_stage
                   * (micro_b * s * h * self.param_bytes
                      * 2.0 * (cfg.tp - 1) / cfg.tp / self.ici_bw
                      + self.latency)
                   if cfg.tp > 1 else 0.0)
        # pp: 1F1B bubble amplification + boundary sends
        bubble = ((cfg.pp - 1) / max(cfg.microbatches + cfg.pp - 1, 1)
                  if cfg.pp > 1 else 0.0)
        comm_pp = (2.0 * micro_b * s * h * self.param_bytes / self.ici_bw
                   * cfg.pp
                   + 2.0 * (cfg.pp - 1) * cfg.microbatches * self.latency
                   if cfg.pp > 1 else 0.0)
        cfg.est_step_time = (compute + comm_dp + comm_tp + comm_pp) / (1.0 - min(bubble, 0.9))
        return cfg

    def prune(self, cfgs: List[TuneConfig], headroom: float = 0.9, *,
              spec: Optional[ModelSpec] = None) -> List[TuneConfig]:
        """Survivors; pruned configs get ``pruned_reason`` set (reference
        prune.py logs the reason per pruned candidate)."""
        if spec is None:  # memory-only (original API, headroom honored)
            return [c for c in cfgs
                    if c.est_total_bytes_per_chip <= self.hbm_bytes * headroom]
        rules = self._rules(spec, headroom)
        out = []
        for c in cfgs:
            for rule in rules:
                reason = rule(c)
                if reason:
                    c.pruned_reason = reason
                    break
            else:
                out.append(c)
        return out

    @staticmethod
    def rank(cfgs: List[TuneConfig]) -> List[TuneConfig]:
        """Cost-model ranking in 10% bands; within a band prefer the simpler
        config (fewer pp stages, less tp, plain dp) — the model's micro-second
        differences on small jobs are noise, simplicity is not."""
        if not cfgs:
            return []
        floor = min(c.est_step_time for c in cfgs) or 1e-9
        # 10%-of-best bands, but never finer than 100us — the model cannot
        # resolve sub-100us differences, so toy jobs fall into one band and
        # the simplicity tie-break decides
        unit = max(0.1 * floor, 1e-4)

        def band(c):
            return int(c.est_step_time / unit + 1e-9)

        return sorted(cfgs, key=lambda c: (band(c), c.pp, c.tp, -c.dp))

    def tune(self, num_params: int, batch_size: int, seq_len: int, hidden: int,
             layers: int,
             run_fn: Optional[Callable[[TuneConfig], float]] = None,
             top_k: int = 3, *, heads: int = 0, kv_heads: int = 0,
             vocab: int = 0) -> List[TuneConfig]:
        spec = ModelSpec(num_params=num_params, batch_size=batch_size,
                         seq_len=seq_len, hidden=hidden, layers=layers,
                         heads=heads, kv_heads=kv_heads, vocab=vocab)
        # recorded trials are scoped to the (model, topology) so a shared
        # history file can never answer for a different job
        scope = (f"n{num_params}_b{batch_size}_s{seq_len}_h{hidden}"
                 f"_L{layers}_dev{self.num_devices}")
        cfgs = [self.estimate(c, spec)
                for c in self.candidates(spec=spec)]
        survivors = self.rank(self.prune(cfgs, spec=spec))
        if run_fn is None:
            return survivors[:top_k]
        measured = []
        for c in survivors[:top_k]:
            prev = self.recorder.seen(c, scope=scope)
            if prev and prev.get("measured_step_time") is not None:
                c.measured_step_time = prev["measured_step_time"]
                measured.append(c)
                continue
            try:
                c.measured_step_time = float(run_fn(c))
                self.recorder.record(c, c.measured_step_time, scope=scope)
                measured.append(c)
            except Exception as e:
                self.recorder.record(c, None, error=str(e)[:200], scope=scope)
                continue
        return sorted(measured, key=lambda c: c.measured_step_time)
