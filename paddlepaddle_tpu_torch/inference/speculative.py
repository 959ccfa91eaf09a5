"""Speculative decoding: a draft model proposes ``k`` greedy tokens per
slot and ONE target forward verifies all ``k+1`` positions.

Port of ``paddlepaddle_tpu/inference/speculative.py`` (:86-425). A target
step yields ``1 + a*k`` tokens at acceptance rate ``a`` instead of one, and
greedy acceptance emits exactly the non-speculative engine's stream. Three
device programs, owned by a :class:`~.decode_engine.BatchDecodeEngine` with
``spec_k > 0`` and run through its program registry (captured as CUDA
graphs on the card, called directly on the CPU):

* ``draft_admit`` (eager, at admission): the draft prefills the FULL prompt
  into its own slot-contiguous caches ``[S, L, kvh_d, hd_d]``, prefix hit or
  not (the draft keeps no prefix cache), and records the prompt's last token
  as the slot's catch-up ``prev``.
* ``draft_k<K>``: one 2-token catch-up step ``[prev, tokens]`` at positions
  ``max(lens-1, 0)`` (after a fully accepted round the draft cache is one
  position behind, and rewriting a written position gives the same K/V),
  then ``k-1`` single-token greedy steps, through the draft's own
  ``model(ids, caches=, pos=)`` with a per-row ``pos``. Writes past the
  cache are dropped, as the reference's scatter drops them.
* ``verify_k<K>``: the engine's own ``_forward_paged`` at W = k+1 over
  ``[tokens, d_1..d_k]`` (the paged kernel with ``q [S, k+1, h, hd]`` on the
  card, its int8 variant under int8 KV), then the reference's masked greedy
  accept/reject: the longest matching prefix, the target's own token at the
  first mismatch (the bonus), eos and budget masks, ``lens += m``. The
  rollback of rejected positions is an index edit: their K/V sit past the
  new length, masked from every later read and overwritten when decode
  reaches them; positions past the reservation or ``max_len`` land in the
  null page. One ``[S, k+3]`` payload per step: k+1 emitted-token columns
  (-1 padded), the accepted-run length (-1 when inactive), the end-of-step
  active flag.

``draft_quant="weight_only_int8"`` quantizes the draft's weights once, at
construction, into a module view of the draft (reference :148-155,
``quantize_param_tree`` over the draft's parameters); the draft model itself
is left unchanged, which matters when the target is its own draft.

Requests with temperature > 0 are refused at admission (sampling-correct
rejection resampling is a seam of the reference too).

Under a tensor-parallel plan (reference :156-175) the draft is replicated:
every rank holds the whole draft (the target itself when it is its own
draft, never the plan's sharded view) and its own slot-contiguous draft
caches; ``draft_quant`` quantizes each rank's replica alike. The verify is
the target's ``_forward_paged`` on the rank's local heads, its logits
gathered before the accept/reject, so every rank decides on the same
logits. Every rank must also decide on the same proposals, or their pools
fall out of step: after the draft program, rank 0's ``[S, k]`` proposals
are broadcast over the model group (a few hundred bytes a round), so the
ranks agree by construction rather than by the draft kernels' determinism.
"""

from __future__ import annotations

import dataclasses
import weakref
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from ..nn.quant import quantized_view
from ..observability import flight as _flight
from .robustness import safe_inc

__all__ = ["SpeculativeDecoder", "resolve_draft"]


def _is_model(draft) -> bool:
    return hasattr(draft, "config") and callable(getattr(draft, "logits",
                                                         None))


def resolve_draft(draft, target_cfg, max_len: int, spec_k: int,
                  device: torch.device, seed: int = 0):
    """Normalise ``draft=`` into a live port model on ``device``: a
    ``LlamaForCausalLM``-shaped model (the target itself included), or a
    ``LlamaConfig``-shaped config, from which a draft is built on
    ``device`` with ``seed``, its ``max_position_embeddings`` widened to
    the engine's ``max_len + k`` rope positions. Checks the two facts
    speculation cannot survive without: one vocabulary, and rope tables
    that cover every position the draft proposes at (reference :86-123)."""
    if _is_model(draft):
        model = draft
    elif hasattr(draft, "vocab_size"):
        from ..models.llama import LlamaForCausalLM

        cfg = draft
        need = max_len + spec_k
        if cfg.max_position_embeddings < need:
            cfg = dataclasses.replace(cfg, max_position_embeddings=need)
        model = LlamaForCausalLM(cfg, device=device, seed=seed)
    else:
        raise ValueError(
            f"draft must be a model config or a LlamaForCausalLM-shaped "
            f"model, got {type(draft).__name__}")
    dcfg = model.config
    if dcfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft vocab_size {dcfg.vocab_size} != target "
            f"{target_cfg.vocab_size} — speculative proposals are target "
            "token ids, the vocabularies must be identical")
    if dcfg.max_position_embeddings < max_len:
        raise ValueError(
            f"draft max_position_embeddings {dcfg.max_position_embeddings} "
            f"< engine max_len {max_len} — the draft must cover every "
            "position it proposes at")
    if model.device != device:
        raise ValueError(f"draft lives on {model.device}, engine device "
                         f"is {device}")
    return model


class SpeculativeDecoder:
    """Draft state and the draft / verify program bodies of an engine with
    ``spec_k > 0``. Every tensor the bodies read or write is a static
    buffer updated in place (the draft caches, ``prev_tokens``, the
    proposals and the payload), so the engine can capture them as CUDA
    graphs. Host accounting (``stats``, ``runlen``) is updated once per
    spec chunk; :meth:`info` is the reference's ``health()["spec"]``
    block."""

    def __init__(self, engine, draft, spec_k: int,
                 draft_quant: Optional[str] = None, *, seed: int = 0):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if engine.kv_layout != "paged":
            raise ValueError(
                "speculative decoding requires kv_layout='paged' — the "
                "page-table indirection IS the KV rollback mechanism")
        self.engine_ref = weakref.ref(engine)
        self.k = int(spec_k)
        self.draft_model = resolve_draft(draft, engine.cfg, engine.L,
                                         self.k, engine.device, seed)
        dcfg = self.draft_model.config
        self.draft_cfg = dcfg
        self.draft_quant = draft_quant
        self.draft_quant_meta: Dict[str, object] = {}
        # the module the draft programs run: the draft, or its int8 view
        self.draft_net = self.draft_model
        if draft_quant is not None:
            self.draft_net, self.draft_quant_meta = quantized_view(
                self.draft_model, algo=draft_quant)
        S, L, dev = engine.S, engine.L, engine.device
        kvh, hd = dcfg.num_key_value_heads, dcfg.head_dim
        dtype = self.draft_model.dtype
        # slot-contiguous draft KV: the draft is small, so the paged
        # layout's savings do not pay for a second page table
        self.draft_caches = [
            (torch.zeros((S, L, kvh, hd), dtype=dtype, device=dev),
             torch.zeros((S, L, kvh, hd), dtype=dtype, device=dev))
            for _ in range(dcfg.num_hidden_layers)]
        i32 = dict(dtype=torch.int32, device=dev)
        # token at position lens-1 of the committed stream (the catch-up
        # window's first element); engine.tokens is the second
        self.prev_tokens = torch.zeros(S, **i32)
        self.proposals = torch.zeros((S, self.k), **i32)
        self.payload = torch.zeros((S, self.k + 3), **i32)
        self.stats = {"target_steps": 0, "proposed": 0, "accepted": 0,
                      "rollbacks": 0, "emitted": 0}
        self.runlen = [0] * (self.k + 1)   # accepted-run-length histogram
        # CRC-32 of every accepted-run-length matrix this engine folded in,
        # in order: two ranks of a plan that took the same accept lengths
        # hold the same value
        self.accept_crc = 0
        # a crash dump carries the live acceptance (weakly bound)
        ref = weakref.ref(self)

        def _spec_annotation():
            s = ref()
            return s.info() if s is not None else {"enabled": "released"}

        _flight.annotate("serving_spec", _spec_annotation)

    # -- facts ---------------------------------------------------------------
    def facts(self) -> Dict[str, object]:
        """Everything that makes two engines' draft / verify programs
        exchangeable: k, the draft's architecture and its quantization."""
        arch = {k: v for k, v in sorted(vars(self.draft_cfg).items())
                if isinstance(v, (int, float, str, bool, type(None)))}
        return {"k": self.k, "draft_model": arch,
                "draft_quant": self.draft_quant or "off"}

    def describe_draft(self) -> Dict[str, object]:
        dcfg = self.draft_cfg
        return {
            "hidden_size": dcfg.hidden_size,
            "num_hidden_layers": dcfg.num_hidden_layers,
            "num_attention_heads": dcfg.num_attention_heads,
            "vocab_size": dcfg.vocab_size,
            "params_m": round(dcfg.num_params() / 1e6, 2),
            "quant": self.draft_quant or "off",
        }

    def info(self) -> Dict[str, object]:
        """Configuration and live acceptance."""
        st = self.stats
        steps = st["target_steps"]
        return {
            "enabled": True,
            "k": self.k,
            "draft": self.describe_draft(),
            "target_steps": steps,
            "proposed": st["proposed"],
            "accepted": st["accepted"],
            "rollbacks": st["rollbacks"],
            "acceptance_rate": (round(st["accepted"] / st["proposed"], 4)
                                if st["proposed"] else None),
            "tokens_per_target_step": (round(st["emitted"] / steps, 3)
                                       if steps else None),
            "accept_run_p50": self.runlen_pct(0.50),
            "accept_run_p99": self.runlen_pct(0.99),
        }

    def runlen_pct(self, q: float) -> Optional[int]:
        """Percentile of the accepted-run-length histogram (0..k)."""
        total = sum(self.runlen)
        if not total:
            return None
        target = q * (total - 1) + 1
        seen = 0
        for length, n in enumerate(self.runlen):
            seen += n
            if seen >= target:
                return length
        return self.k

    # -- device programs -----------------------------------------------------
    def _forward(self, toks: torch.Tensor, pos) -> torch.Tensor:
        """Draft logits ``[S, s, V]`` for ``toks [S, s]`` at per-row ``pos``,
        writing the draft caches in place."""
        dm = self.draft_net
        hidden, _ = dm.model(toks.long(), caches=self.draft_caches, pos=pos)
        return dm.logits(hidden)

    def draft_admit(self, ids: np.ndarray, slot: int) -> None:
        """Prefill the prompt ``ids [1, plen]`` through the draft into slot
        ``slot`` of its caches and set the slot's ``prev``. The logits are
        discarded: the target's admission sampled the first token, and
        speculation proposes from that same stream."""
        eng = self.engine_ref()
        dcfg = self.draft_cfg
        plen = ids.shape[1]
        kvh, hd = dcfg.num_key_value_heads, dcfg.head_dim
        dev, dtype = eng.device, self.draft_model.dtype
        scratch = [(torch.zeros((1, plen, kvh, hd), dtype=dtype, device=dev),
                    torch.zeros((1, plen, kvh, hd), dtype=dtype, device=dev))
                   for _ in range(dcfg.num_hidden_layers)]
        ids_t = torch.as_tensor(ids, dtype=torch.long).to(dev)
        _, scratch = self.draft_net.model(ids_t, caches=scratch, pos=0)
        for (kc, vc), (ks, vs) in zip(self.draft_caches, scratch):
            kc[slot, :plen] = ks[0]
            vc[slot, :plen] = vs[0]
        self.prev_tokens[slot] = int(ids[0, plen - 1])

    def draft_body(self) -> None:
        """``k`` greedy proposals per slot into ``proposals``. Inactive
        slots' writes land in their own draft rows (prefilled again at the
        next admission) and their proposals are masked by the verify."""
        eng = self.engine_ref()
        lens = eng.lens
        toks0 = torch.stack([self.prev_tokens, eng.tokens], dim=1)   # [S, 2]
        logits = self._forward(toks0, torch.clamp(lens - 1, min=0))
        cur = logits[:, 1].float().argmax(dim=-1).to(torch.int32)
        props = [cur]
        for i in range(1, self.k):
            lg = self._forward(cur[:, None], lens + i)
            cur = lg[:, 0].float().argmax(dim=-1).to(torch.int32)
            props.append(cur)
        self.proposals.copy_(torch.stack(props, dim=1))
        plan = eng.plan
        if plan is not None and plan.tp_degree > 1:
            from ..distributed.collective import _broadcast_

            _broadcast_(self.proposals, 0, plan.mp_group)

    def verify_body(self) -> None:
        """ONE target forward at W = k+1 and the greedy accept/reject as
        masked tensor ops (reference :305-377); writes the step's payload
        and updates the engine's slot state in place. A token is emitted
        iff it extends the longest draft/target matching prefix (the bonus
        always does), the slot's budget has room, and no earlier token of
        this run was the slot's eos; ``lens`` advances by the emitted
        count, which IS the KV rollback."""
        eng = self.engine_ref()
        k, S, dev = self.k, eng.S, eng.device
        tokens, lens, active = eng.tokens, eng.lens, eng.active
        budgets, eos_ids, prev = eng.budgets, eng.eos_ids, self.prev_tokens
        props = self.proposals
        i32 = torch.int32
        rows = torch.arange(S, device=dev)
        toks = torch.cat([tokens[:, None], props], dim=1)           # [S, k+1]
        logits = eng._forward_paged(toks, lens)
        g = logits.float().argmax(dim=-1).to(i32)                   # [S, k+1]
        match = (props == g[:, :k]).to(i32)
        acc = torch.cumprod(match, dim=1)
        a = acc.sum(dim=1, dtype=i32)                               # 0..k
        bonus = g[rows, a.long()]
        idx = torch.arange(k + 1, device=dev)[None, :]
        prop_ext = torch.cat([props, torch.zeros((S, 1), dtype=i32,
                                                 device=dev)], dim=1)
        cand = torch.where(idx < a[:, None], prop_ext, bonus[:, None])
        eos_hit = ((eos_ids[:, None] >= 0)
                   & (cand == eos_ids[:, None])).to(i32)
        prior_eos = torch.cumsum(eos_hit, dim=1, dtype=i32) - eos_hit
        emit = (active[:, None] & (idx <= a[:, None])
                & (idx < budgets[:, None]) & (prior_eos == 0))
        m = emit.sum(dim=1, dtype=i32)                              # emitted
        emitted = torch.where(emit, cand, -1)
        # the committed stream's tail: full[0] is the last token before the
        # step, full[i+1] = cand_i, so the new last and second-to-last
        # tokens are gathers at m and m-1
        full = torch.cat([tokens[:, None], cand], dim=1)
        m_pos = torch.clamp(m, max=k + 1).long()
        tokens_new = torch.where(m > 0, full[rows, m_pos], tokens)
        prev_new = torch.where(
            m > 0, full[rows, torch.clamp(m_pos - 1, min=0)], prev)
        budgets_new = budgets - m
        active_new = (active & (budgets_new > 0)
                      & ~((eos_ids >= 0) & (tokens_new == eos_ids)))
        a_report = torch.where(active, a, -1)
        self.payload.copy_(torch.cat(
            [emitted, a_report[:, None], active_new[:, None].to(i32)], dim=1))
        lens.add_(m)
        budgets.copy_(budgets_new)
        tokens.copy_(tokens_new)
        prev.copy_(prev_new)
        active.copy_(active_new)

    # -- host-side accounting ------------------------------------------------
    def round_summary(self, acc_row: np.ndarray) -> Dict[str, int]:
        """One slot's spec-chunk summary: verify steps run this chunk and
        draft tokens proposed / accepted at this k."""
        live = acc_row[acc_row >= 0]
        return {"k": self.k, "steps": int(live.size),
                "proposed": int(live.size) * self.k,
                "accepted": int(live.sum())}

    def record_chunk(self, acc_matrix: np.ndarray,
                     emitted_count: int) -> None:
        """Fold one spec chunk's accepted-run lengths (``[S, steps]``, -1
        for inactive slot-steps) into ``stats`` and ``runlen``."""
        self.accept_crc = zlib.crc32(
            np.ascontiguousarray(acc_matrix, dtype=np.int32).tobytes(),
            self.accept_crc)
        live = acc_matrix[acc_matrix >= 0]
        if live.size == 0:
            return
        steps = int(live.size)
        accepted = int(live.sum())
        rollbacks = int((live < self.k).sum())
        st = self.stats
        st["target_steps"] += steps
        st["proposed"] += steps * self.k
        st["accepted"] += accepted
        st["rollbacks"] += rollbacks
        st["emitted"] += int(emitted_count)
        counts = np.bincount(live, minlength=self.k + 1)
        for length, n in enumerate(counts[: self.k + 1]):
            if n:
                self.runlen[length] += int(n)
                safe_inc("paddle_serving_spec_accept_run_length_total",
                         "accepted-run-length histogram of speculative "
                         "verify steps, by run length", int(n),
                         len=str(length))
        safe_inc("paddle_serving_spec_proposed_total",
                 "draft tokens proposed to the target verifier",
                 steps * self.k)
        safe_inc("paddle_serving_spec_accepted_total",
                 "draft tokens accepted by the target verifier", accepted)
        if rollbacks:
            safe_inc("paddle_serving_spec_rollbacks_total",
                     "verify steps that rejected at least one draft token "
                     "(KV rolled back by index rewind)", rollbacks)

