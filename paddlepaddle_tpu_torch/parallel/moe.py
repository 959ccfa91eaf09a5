"""Mixture-of-experts layer (counterpart of ``paddlepaddle_tpu/parallel/moe.py``).

A token-routed bank of SwiGLU expert FFNs with stacked ``[E, ...]`` weights
and four dispatch modes, as in the reference's ``MoELayer`` (:552):

* ``"sorted"`` (default): top-k routing by iterated argmax, a stable
  counting sort of the round-major entries, static ``[E, C, d]`` capacity
  buffers run as batched matmuls; tokens past ``capacity`` are dropped;
* ``"fused"``: the same routing, slot maps and combine, with the dispatch
  gather and the expert FFN in the hand-written gather-GEMM kernel
  (``ops/kernels/gather_gemm.py``) on the card;
* ``"dropless"``: the same routing, no capacity bound, one matmul per
  expert group over the sorted rows;
* ``"einsum"``: GShard one-hot dispatch and combine tensors ``[T, E, C]``
  from the gate's ``routing()``; a custom gate that overrides ``routing()``
  always takes this route (the reference's ``stock_gate`` rule, :652).

The reference's custom vjps (``_slot_dispatch``, ``_slot_combine``,
``_dispatch_gather``, ``_combine_gather`` and their ``_pad`` forms) exist to
make both directions gathers on the TPU; here autograd's scatter-add
backward of plain indexing computes the same gradients, so they are plain
indexing. The blocked bf16 prefix-sum matmul of ``_counting_sort`` is a TPU
speed trick with the same result as the stable sort used here.

``_sorted_moe_ffn`` (:114) is the reference's legacy sorted dispatch that
only its tools call: a stable argsort by expert, a ``bincount`` for the
offsets and one scatter into ``[E*C + 1, d]`` rows whose last row takes the
drops; no mode selects it.

Not ported: ``moe_sharding_rules`` and expert-parallel placement (ROADMAP A10; ``ep_axis``
is recorded and otherwise unused), and the reference's loud fallback from
``"fused"`` to ``"sorted"`` with its kill switch ``FLAGS_fused_gather_gemm``
(:603-626): on the card an unsupported ``"fused"`` configuration raises at
construction instead, so no configuration silently bypasses the kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as _tF
from torch import nn

from ..amp import amp_cast
from ..core.dtype import to_torch_dtype
from ..device import DeviceLike, resolve_device
from ..ops.kernels._build import check_device
from .mpu import mark_placement  # noqa: F401  (the reference's path)
from ..ops.kernels.gather_gemm import gather_gemm_ffn, gather_gemm_supported

DISPATCH_MODES = ("einsum", "sorted", "dropless", "fused")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return _tF.one_hot(idx.long(), n).float()


# ---------------------------------------------------------------------------
# einsum routing (the gates' ``routing()``)
# ---------------------------------------------------------------------------


def _top1_routing(logits, capacity: int):
    """Switch routing (:33): ``(dispatch [T,E,C], combine [T,E,C], aux)``."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), -1)
    expert_mask = _one_hot(probs.argmax(-1), E)
    pos_in_expert = torch.cumsum(expert_mask, 0) * expert_mask   # 1-based
    keep = (pos_in_expert <= capacity) * expert_mask
    pos = (pos_in_expert - 1.0) * keep
    dispatch = keep[..., None] * _one_hot(pos.sum(-1), capacity)[:, None, :]
    dispatch = dispatch * expert_mask[..., None]
    gate_val = (probs * expert_mask).sum(-1, keepdim=True)
    combine = dispatch * gate_val[..., None]
    aux = E * (expert_mask.mean(0) * probs.mean(0)).sum()
    return dispatch, combine, aux


def _topk_routing(logits, capacity: int, k: int):
    """GShard top-k (:54): each token to its top-k experts, gate values
    renormalised over the k; one fill counter per expert shared by the k
    rounds, so the first choices fill capacity before any second choice."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), -1)
    dispatch = probs.new_zeros(T, E, capacity)
    combine = probs.new_zeros(T, E, capacity)
    remaining = probs
    fill = probs.new_zeros(E)
    denom = torch.topk(probs, k, dim=-1).values.sum(-1, keepdim=True) + 1e-9
    aux = probs.new_zeros(())
    for _ in range(k):
        mask = _one_hot(remaining.argmax(-1), E)
        pos_in_expert = (torch.cumsum(mask, 0) - 1.0) + fill[None, :]
        keep = (pos_in_expert < capacity) * mask
        pos = pos_in_expert * keep
        d = keep[..., None] * _one_hot(pos.sum(-1), capacity)[:, None, :]
        d = d * mask[..., None]
        gate_val = (probs * mask).sum(-1, keepdim=True) / denom
        dispatch = dispatch + d
        combine = combine + d * gate_val[..., None]
        fill = fill + mask.sum(0)
        aux = aux + E * (mask.mean(0) * probs.mean(0)).sum()
        remaining = remaining * (1.0 - mask)
    return dispatch.clamp(max=1.0), combine, aux / k


class NaiveGate(nn.Module):
    """Linear router ``weight [d_model, E]`` (reference :83). Its weight is
    left uninitialised; :class:`MoELayer` fills the gate it creates."""

    def __init__(self, d_model: int, num_experts: int, topk: int = 2, *,
                 device: DeviceLike = None, dtype="float32"):
        super().__init__()
        self.num_experts = num_experts
        # a token cannot route to more experts than exist
        self.topk = min(topk, num_experts)
        self.weight = nn.Parameter(torch.empty(
            d_model, num_experts, device=resolve_device(device),
            dtype=to_torch_dtype(dtype)))

    def routing(self, x_flat: torch.Tensor, capacity: int):
        logits = x_flat.float() @ self.weight.float()
        if self.topk == 1:
            return _top1_routing(logits, capacity)
        return _topk_routing(logits, capacity, self.topk)


class SwitchGate(NaiveGate):
    def __init__(self, d_model: int, num_experts: int, **kw):
        super().__init__(d_model, num_experts, topk=1, **kw)


class GShardGate(NaiveGate):
    def __init__(self, d_model: int, num_experts: int, **kw):
        super().__init__(d_model, num_experts, topk=2, **kw)


# ---------------------------------------------------------------------------
# routing and slot maps of the sorted, fused and dropless modes
# ---------------------------------------------------------------------------


def _sorted_moe_ffn(x, logits, wg, wu, wd, topk: int, capacity: int):
    """The reference's LEGACY sorted (ragged) dispatch (:114), kept for
    comparison as the reference keeps it: ``x [T, d]``, ``logits [T, E]``,
    weights ``[E, d, h]`` / ``[E, h, d]``. Top-k of the softmax (GShard
    renormalizes for k > 1), entries stably sorted by expert, each entry's
    rank in its expert from the ``bincount`` offsets, entries past
    ``capacity`` sent to the trash row ``E*C``. Returns ``(y [T, d],
    aux_loss)``, the load-balance loss averaged over the k rounds."""
    T, d = x.shape
    E = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, topk, dim=-1)       # [T, k]
    if topk > 1:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    flat_e = expert_idx.reshape(-1)                               # [T*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of = order // topk
    counts = torch.bincount(flat_e, minlength=E)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * topk, device=x.device) - offsets[sorted_e]
    keep = pos < capacity
    slot = torch.where(keep, sorted_e * capacity + pos, E * capacity)
    buf = torch.zeros((E * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), x[token_of])
    xin = buf[:-1].reshape(E, capacity, d)
    h = _tF.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    out = torch.bmm(h, wd).reshape(E * capacity, d)
    out = torch.cat([out, out.new_zeros((1, d))])                 # trash row
    gate_sorted = gate_vals.reshape(-1)[order].to(x.dtype)
    contrib = out[slot] * (gate_sorted * keep.to(x.dtype))[:, None]
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add(
        0, token_of, contrib)
    mean_prob = probs.mean(0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(topk):
        aux = aux + E * torch.sum(_one_hot(expert_idx[:, r], E).mean(0)
                                  * mean_prob)
    return y, aux / topk


def _route_topk_iter(logits, k: int, num_experts: int):
    """Iterated-argmax top-k (:171): ``(gate_vals [T,k], expert_idx [T,k],
    aux)``, the same gate values and load-balance loss as the einsum
    routing; k > 1 renormalises the gate values (GShard), k = 1 keeps the
    raw probability (Switch)."""
    E = num_experts
    probs = torch.softmax(logits.float(), -1)
    rem = probs
    mean_prob = probs.mean(0)
    gvs, eis = [], []
    aux = probs.new_zeros(())
    for _ in range(k):
        idx = rem.argmax(-1)
        oh = _one_hot(idx, E)
        gvs.append((rem * oh).sum(-1))
        eis.append(idx)
        aux = aux + E * (oh.mean(0) * mean_prob).sum()
        rem = rem * (1.0 - oh)
    gate_vals = torch.stack(gvs, -1)
    if k > 1:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return gate_vals, torch.stack(eis, -1), aux / k


def _counting_sort(fe, num_experts: int):
    """Stable sort of expert assignments ``fe [N]`` (:197): ``(dest, sidx,
    counts, offs)`` — entry i lands at sorted slot ``dest[i]``, sorted slot
    s holds entry ``sidx[s]``, ``offs`` is the exclusive cumsum of
    ``counts``."""
    fe = fe.long()
    counts = torch.bincount(fe, minlength=num_experts)
    offs = torch.cumsum(counts, 0) - counts
    sidx = torch.argsort(fe, stable=True)
    dest = torch.empty_like(sidx)
    dest[sidx] = torch.arange(fe.shape[0], device=fe.device)
    return dest, sidx, counts, offs


def _capacity_slot_maps(logits, topk: int, E: int, C: int, T: int):
    """Routing and slot index maps of the capacity dispatch (:321), shared
    by the sorted and fused modes so their drop semantics cannot drift.
    Entries are round-major (entry j = r*T + t: every first choice fills
    capacity before any second choice). Returns ``(gate_vals [T,k], aux,
    slots_of_entry [k,T] (slot id or -1 if dropped), slot_valid [E*C],
    slot_entry [E*C])``."""
    N = T * topk
    gate_vals, expert_idx, aux = _route_topk_iter(logits, topk, E)
    fe = expert_idx.T.reshape(-1)
    dest, sidx, counts, offs = _counting_sort(fe, E)
    pos = dest - offs[fe]                               # rank within expert
    slots_of_entry = torch.where(pos < C, fe * C + pos, -1).reshape(topk, T)
    dev = logits.device
    e_of_slot = torch.arange(E, device=dev).repeat_interleave(C)
    c_of_slot = torch.arange(C, device=dev).repeat(E)
    slot_valid = c_of_slot < counts[e_of_slot].clamp(max=C)
    slot_entry = sidx[(offs[e_of_slot] + c_of_slot).clamp(0, N - 1)]
    return gate_vals, aux, slots_of_entry, slot_valid, slot_entry


def _slot_dispatch(x, slot_entry, slot_valid):
    """``xin[slot] = x[token of the slot's entry]`` (:275), zero rows in
    unfilled slots; the token of entry j is j % T."""
    return torch.where(slot_valid[:, None], x[slot_entry % x.shape[0]], 0)


def _slot_combine_weighted(x, out, gate_vals, slots_of_entry):
    """Each entry reads its slot's expert output, zero if it was dropped
    (``_slot_combine`` :298), and the k contributions are gate-weighted
    onto their token (:342)."""
    kept = (slots_of_entry >= 0)[..., None]
    contrib = torch.where(kept, out[slots_of_entry.clamp(min=0)], 0)
    return (contrib * gate_vals.T.to(x.dtype)[..., None]).sum(0)


def _reference_expert_ffn(x, slot_entry, slot_valid, wg, wu, wd):
    """The capacity path's FFN body (:401): dispatch gather, then the
    SwiGLU expert FFN as batched matmuls in x's dtype. The recompute target
    of the fused mode's backward."""
    E, d, _ = wg.shape
    C = slot_entry.shape[0] // E
    xin = _slot_dispatch(x, slot_entry, slot_valid).reshape(E, C, d)
    hmid = _tF.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    return torch.bmm(hmid, wd).reshape(E * C, d)


def _gathered_capacity_moe_ffn(x, logits, wg, wu, wd, topk: int,
                               capacity: int):
    """Mode ``"sorted"`` (:352): ``(y [T, d], aux)``."""
    T = x.shape[0]
    gate_vals, aux, slots_of_entry, slot_valid, slot_entry = \
        _capacity_slot_maps(logits, topk, wg.shape[0], capacity, T)
    out = _reference_expert_ffn(x, slot_entry, slot_valid, wg, wu, wd)
    return _slot_combine_weighted(x, out, gate_vals, slots_of_entry), aux


class _FusedExpertFFN(torch.autograd.Function):
    """The expert FFN over the capacity slots (``custom_vjp`` :378-433):
    the forward is :func:`gather_gemm_ffn` (the kernel on the card); the
    backward recomputes :func:`_reference_expert_ffn` under autograd and
    returns its gradients for x, wg, wu and wd, as the reference does
    (:422-430). The reference has no backward kernel here."""

    @staticmethod
    def forward(ctx, x, slot_token, slot_entry, slot_valid, wg, wu, wd):
        x = x.contiguous()
        ctx.save_for_backward(x, slot_entry, slot_valid, wg, wu, wd)
        return gather_gemm_ffn(x, slot_token, wg, wu, wd,
                               capacity=slot_token.shape[0] // wg.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, slot_entry, slot_valid, wg, wu, wd = ctx.saved_tensors
        need = [ctx.needs_input_grad[i] for i in (0, 4, 5, 6)]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip((x, wg, wu, wd), need)]
        with torch.enable_grad():
            out = _reference_expert_ffn(ins[0], slot_entry, slot_valid,
                                        *ins[1:])
        wanted = [t for t, n in zip(ins, need) if n]
        got = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        dx, dwg, dwu, dwd = (next(got) if n else None for n in need)
        return dx, None, None, None, dwg, dwu, dwd


def _fused_gather_gemm_moe_ffn(x, logits, wg, wu, wd, topk: int,
                               capacity: int):
    """Mode ``"fused"`` (:436): the sorted mode's routing, slot maps and
    combine; the dispatch gather and expert FFN in the gather-GEMM kernel.
    Returns ``(y [T, d], aux)``."""
    T = x.shape[0]
    gate_vals, aux, slots_of_entry, slot_valid, slot_entry = \
        _capacity_slot_maps(logits, topk, wg.shape[0], capacity, T)
    # the kernel gathers by TOKEN row (entry j reads x[j % T]); the
    # sentinel T marks unfilled slots, which the kernel zeroes
    slot_token = torch.where(slot_valid, slot_entry % T, T).to(torch.int32)
    out = _FusedExpertFFN.apply(x, slot_token, slot_entry, slot_valid,
                                wg, wu, wd)
    return _slot_combine_weighted(x, out, gate_vals, slots_of_entry), aux


def _dropless_moe_ffn(x, logits, wg, wu, wd, topk: int, align: int = 1):
    """Mode ``"dropless"`` (:499): no capacity bound, no drops. Entries are
    counting-sorted by expert (``_dispatch_gather``: ``x[sidx % T]``), each
    expert group runs its FFN as one ``torch.matmul`` per weight over its
    contiguous rows (the reference's ``lax.ragged_dot``, which it leaves to
    XLA outside any kernel), and each entry reads its row back
    (``_combine_gather``: ``out[dest]``). The group sizes cross to the host
    once per layer (one sync) to split the rows.

    ``align`` > 1 pads each group to a multiple of ``align`` with zero rows
    (the ``_pad`` forms, sentinel N). Returns ``(y [T, d], aux)``."""
    T, d = x.shape
    E = wg.shape[0]
    N = T * topk
    gate_vals, expert_idx, aux = _route_topk_iter(logits, topk, E)
    fe = expert_idx.T.reshape(-1)           # round-major (j = r*T + t)
    dest, sidx, counts, offs = _counting_sort(fe, E)
    if align > 1:
        counts_p = (counts + align - 1) // align * align
        counts_p[-1] += N + E * align - counts_p.sum()   # absorb the slack
        offs_p = torch.cumsum(counts_p, 0) - counts_p
        dest = offs_p[fe] + (dest - offs[fe])
        sidx = torch.full((N + E * align,), N, dtype=dest.dtype,
                          device=dest.device)
        sidx[dest] = torch.arange(N, device=dest.device)
        counts = counts_p
        xin = torch.where((sidx < N)[:, None], x[sidx % T], 0)
    else:
        xin = x[sidx % T]
    outs = []
    for e, rows in enumerate(torch.split(xin, counts.tolist())):
        hmid = _tF.silu(rows @ wg[e]) * (rows @ wu[e])
        outs.append(hmid @ wd[e])
    contrib = torch.cat(outs)[dest].reshape(topk, T, d)
    y = (contrib * gate_vals.T.to(x.dtype)[..., None]).sum(0)
    return y, aux


class MoELayer(nn.Module):
    """Token-routed expert FFN bank (reference :552): ``forward(x [b, s, d])
    -> [b, s, d]``, and the load-balance loss of that call in ``l_aux``.

    ``device=None`` builds on the card (raises without CUDA). The expert
    banks ``w_gate_proj``/``w_up_proj`` ``[E, d, h]`` and ``w_down_proj``
    ``[E, h, d]`` and a gate made here are drawn N(0, ``init_std``) from a
    generator seeded with ``seed``; a gate passed in is left as it is. The
    experts are SwiGLU: ``activation`` is accepted and, as in the reference
    (:593), never read. ``ep_axis`` is recorded for expert-parallel
    placement (ROADMAP A10) and otherwise unused. Under AMP the fast modes'
    inputs pass the cast hook as the reference's ``moe_ffn_<mode>`` op.

    With ``dispatch_mode="fused"`` on the card the gather-GEMM kernel's
    support check runs once, here, and an unsupported configuration raises.
    """

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate: Optional[NaiveGate] = None,
                 capacity_factor: float = 1.25, ep_axis: str = "ep",
                 activation=None, dispatch_mode: str = "sorted", *,
                 device: DeviceLike = None, dtype="float32", seed: int = 0,
                 init_std: float = 0.02):
        super().__init__()
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"dispatch_mode must be 'einsum', 'sorted', "
                             f"'dropless' or 'fused', got {dispatch_mode!r}")
        dev = resolve_device(device)
        dt = to_torch_dtype(dtype)
        if dispatch_mode == "fused" and dev.type == "cuda":
            check_device(dev)
            ok, why = gather_gemm_supported(d_model, d_hidden, dt)
            if not ok:
                raise ValueError(f"dispatch_mode='fused': the gather-GEMM "
                                 f"kernel does not take this layer: {why}")
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        self.dispatch_mode = dispatch_mode
        own_gate = gate is None
        self.gate = GShardGate(d_model, num_experts, device=dev,
                               dtype=dt) if own_gate else gate
        E, d, h = num_experts, d_model, d_hidden
        kw = dict(device=dev, dtype=dt)
        self.w_gate_proj = nn.Parameter(torch.empty(E, d, h, **kw))
        self.w_up_proj = nn.Parameter(torch.empty(E, d, h, **kw))
        self.w_down_proj = nn.Parameter(torch.empty(E, h, d, **kw))
        self.l_aux: Optional[torch.Tensor] = None   # set by each forward
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for p in ([self.w_gate_proj, self.w_up_proj, self.w_down_proj]
                      + ([self.gate.weight] if own_gate else [])):
                p.normal_(0.0, init_std, generator=gen)

    def capacity(self, num_tokens: int) -> int:
        per = num_tokens * max(self.gate.topk, 1) / self.num_experts
        return max(4, int(math.ceil(per * self.capacity_factor)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape[0], x.shape[1], self.d_model
        x_flat = x.reshape(b * s, d)
        cap = self.capacity(b * s)
        wg, wu, wd = self.w_gate_proj, self.w_up_proj, self.w_down_proj
        # the fast modes inline softmax + top-k routing; a custom routing()
        # override keeps its behaviour through the einsum route
        stock_gate = type(self.gate).routing is NaiveGate.routing
        if stock_gate and self.dispatch_mode != "einsum":
            topk = max(self.gate.topk, 1)
            x_flat, gate_w, wg, wu, wd = amp_cast(
                "moe_ffn_" + self.dispatch_mode, x_flat, self.gate.weight,
                wg, wu, wd)
            logits = x_flat.float() @ gate_w.float()
            if self.dispatch_mode == "dropless":
                y, aux = _dropless_moe_ffn(x_flat, logits, wg, wu, wd, topk)
            elif self.dispatch_mode == "fused":
                y, aux = _fused_gather_gemm_moe_ffn(x_flat, logits, wg, wu,
                                                    wd, topk, cap)
            else:
                y, aux = _gathered_capacity_moe_ffn(x_flat, logits, wg, wu,
                                                    wd, topk, cap)
            self.l_aux = aux
            return y.reshape(b, s, d)
        dispatch, combine, aux = self.gate.routing(x_flat, cap)
        self.l_aux = aux
        xin = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x_flat)
        hmid = _tF.silu(torch.einsum("ecd,edh->ech", xin, wg)) \
            * torch.einsum("ecd,edh->ech", xin, wu)
        out = torch.einsum("ech,ehd->ecd", hmid, wd)
        y = torch.einsum("tec,ecd->td", combine.to(x.dtype), out)
        return y.reshape(b, s, d)

