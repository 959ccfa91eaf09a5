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

Under a sharding plan (:meth:`~..distributed.shard_plan.ShardingPlan.
wire_module` attaches the groups) the layer computes what the reference's
one global step computes:

* data parallel (a data group of more than one rank: the product of the
  plan's data axes, ``dp`` and ``fsdp`` under the default ``data_axes``):
  each rank holds its rows of the global batch. The routing logits
  ``[T, E]`` are gathered over the data group (backward: a
  reduce-scatter, sum), so capacity (``capacity(global tokens)``), the drop
  priority, the slot maps and ``l_aux`` are the global ones; each rank keeps
  the decisions of its own tokens and runs its own tokens' slots, the
  others' slots taking the sentinel the kernel zeroes. ``aux_share`` is
  ``1/dp`` (``dp`` the data group's size): the model adds ``aux_share *
  l_aux`` on each rank, so the load-balance term counts once in the loss
  the step sums over the data group. The einsum mode gathers ``x`` over
  it and routes it with the gate's own ``routing()`` (a custom gate
  included). The trunk's parameters may be sharded over ``fsdp``
  (:func:`moe_sharding_rules`) and are gathered where they are used; the
  banks, on ``ep`` alone, stay whole on a mesh without ``ep``, so kernel
  8 runs on the full banks there;
* expert parallel (``ep`` > 1, :func:`moe_sharding_rules`): the ranks of
  one ``ep`` group hold the same tokens and ``E/ep`` experts each
  (``w_*_proj [E/ep, ...]``). Each computes the global routing and runs
  its local experts' slots only; the combine is partial over ``ep`` and is
  all-reduced in the forward (Megatron's g). ``x`` and the gate values
  enter the expert region through Megatron's f (all-reduce in backward),
  so the gate and ``x`` get whole gradients on every rank. XLA's
  partitioner emits an all_to_all here; the port replicates tokens and
  all-reduces (ROADMAP, recorded deviations);
* ``ep`` beside a parameter-sharding axis (``fsdp2 ep2`` with data axes
  ``("fsdp",)``, or ``dp x fsdp x ep`` under the default ones): the two
  groups are orthogonal slices of the mesh. The data group (every data
  axis, ``fsdp`` among them) joins ranks of one ``ep`` coordinate that
  hold OTHER tokens; the ``ep`` group joins ranks of one data coordinate
  that hold the SAME tokens. The routing logits are gathered over the
  data group (their backward a summed reduce-scatter there), the capacity
  maps (:func:`_local_capacity_maps`) keep this rank's rows of that global
  batch and this rank's ``E/ep`` experts, the combine is summed over
  ``ep`` and ``x`` / the gate values enter through f over ``ep``, and
  ``aux_share`` is ``1/|data group|``: the ``ep`` ranks compute the same
  ``l_aux``, which counts once when the step sums the loss over the data
  group. The trunk's matrices are gathered over ``fsdp`` where they are
  used (:class:`~.mpu._GatherOnUse`: a reduce-scatter of the gradient over
  ``fsdp`` as a data axis, nothing over ``ep``, whose ranks compute equal
  trunk gradients); the banks are sharded over ``ep`` alone and the step
  sums their gradients over the data group and never over ``ep``.

Not ported: the reference's loud fallback from ``"fused"`` to ``"sorted"``
with its kill switch ``FLAGS_fused_gather_gemm`` (:603-626): on the card an
unsupported ``"fused"`` configuration raises at construction instead, so no
configuration silently bypasses the kernel.
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
from ..distributed.collective import (_grank, _size, c_allgather,
                                      c_identity, mp_allreduce)
from ..ops.kernels._build import check_device
from .mpu import mark_placement
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


def _spread(idx, keep, n: int):
    """Gather rows ``idx % n`` where ``keep``, and elsewhere (a read the
    caller masks to zero) each position's own index mod ``n``. The
    gather's backward is a sorted accumulation on the card that runs
    serially over equal indices: masked reads all aimed at one row (a
    sentinel, or -1 clamped to 0) cost it thousands of steps a layer."""
    own = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape)
    return torch.where(keep, idx, own) % n


def _slot_dispatch(x, slot_entry, slot_valid):
    """``xin[slot] = x[token of the slot's entry]`` (:275), zero rows in
    unfilled slots; the token of entry j is j % T."""
    rows = _spread(slot_entry, slot_valid, x.shape[0])
    return torch.where(slot_valid[:, None], x[rows], 0)


def _reference_expert_ffn(x, slot_entry, slot_valid, wg, wu, wd):
    """The capacity path's FFN body (:401): dispatch gather, then the
    SwiGLU expert FFN as batched matmuls in x's dtype. The recompute target
    of the fused mode's backward."""
    E, d, _ = wg.shape
    C = slot_entry.shape[0] // E
    xin = _slot_dispatch(x, slot_entry, slot_valid).reshape(E, C, d)
    hmid = _tF.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    return torch.bmm(hmid, wd).reshape(E * C, d)


def _gate_weighted_sum(contrib, gate_vals, ep=None):
    """``y[t] = sum_r gate_vals[t, r] * contrib[r, t]`` (:342). Under an
    expert-parallel group ``ep`` the gate values enter through Megatron's f
    (all-reduce in backward): each rank's combine covers its own experts'
    entries only, so the gate's gradient is summed over ``ep``."""
    if ep is not None:
        gate_vals = c_identity(gate_vals, ep)
    return (contrib * gate_vals.T.to(contrib.dtype)[..., None]).sum(0)


def _slot_combine_weighted(out, gate_vals, slots_of_entry, ep=None):
    """Each entry reads its slot's expert output, zero if it was dropped
    or is another rank's (``_slot_combine`` :298), and the k contributions
    are gate-weighted onto their token (:342)."""
    kept = slots_of_entry >= 0
    rows = _spread(slots_of_entry, kept, out.shape[0])
    contrib = torch.where(kept[..., None], out[rows], 0)
    return _gate_weighted_sum(contrib, gate_vals, ep)


def _gathered_capacity_moe_ffn(x, logits, wg, wu, wd, topk: int,
                               capacity: int):
    """Mode ``"sorted"`` (:352): ``(y [T, d], aux)``."""
    return _moe_ffn_on_rank("sorted", x, logits, wg, wu, wd, topk, capacity,
                            None, None)


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
    return _moe_ffn_on_rank("fused", x, logits, wg, wu, wd, topk, capacity,
                            None, None)


def _dropless_moe_ffn(x, logits, wg, wu, wd, topk: int, align: int = 1,
                      t0: int = 0, e0: int = 0, ep=None):
    """Mode ``"dropless"`` (:499): no capacity bound, no drops. Entries are
    counting-sorted by expert (``_dispatch_gather``: ``x[sidx % T]``), each
    expert group runs its FFN as one ``torch.matmul`` per weight over its
    contiguous rows (the reference's ``lax.ragged_dot``, which it leaves to
    XLA outside any kernel), and each entry reads its row back
    (``_combine_gather``: ``out[dest]``). The group sizes cross to the host
    once per layer (one sync) to split the rows.

    ``align`` > 1 pads each group to a multiple of ``align`` with zero rows
    (the ``_pad`` forms, sentinel N). On one rank of a plan ``x [T_loc, d]``
    holds the rows ``[t0, t0 + T_loc)`` of the batch that ``logits [T, E]``
    route, and ``wg``/``wu``/``wd`` the experts ``[e0, e0 + E_loc)``;
    entries routed to another rank's experts sort into one last group that
    runs no FFN and contributes zeros (empty in one process), and ``ep``
    passes to :func:`_gate_weighted_sum`. Returns ``(y [T_loc, d], aux)``,
    ``y`` partial over ``ep``."""
    T, d = x.shape
    E = wg.shape[0]
    N = T * topk
    gate_vals, expert_idx, aux = _route_topk_iter(logits, topk,
                                                  logits.shape[1])
    gate_vals, expert_idx = gate_vals[t0:t0 + T], expert_idx[t0:t0 + T]
    fe = expert_idx.T.reshape(-1) - e0      # round-major (j = r*T + t)
    fe = torch.where((fe >= 0) & (fe < E), fe, E)
    dest, sidx, counts, offs = _counting_sort(fe, E + 1)
    if align > 1:
        G = E + 1
        counts_p = (counts + align - 1) // align * align
        counts_p[-1] += N + G * align - counts_p.sum()   # absorb the slack
        offs_p = torch.cumsum(counts_p, 0) - counts_p
        dest = offs_p[fe] + (dest - offs[fe])
        sidx = torch.full((N + G * align,), N, dtype=dest.dtype,
                          device=dest.device)
        sidx[dest] = torch.arange(N, device=dest.device)
        counts = counts_p
        xin = torch.where((sidx < N)[:, None], x[sidx % T], 0)
    else:
        xin = x[sidx % T]
    groups = torch.split(xin, counts.tolist())
    outs = [(_tF.silu(rows @ wg[e]) * (rows @ wu[e])) @ wd[e]
            for e, rows in enumerate(groups[:E])]
    outs.append(torch.zeros_like(groups[E]))
    contrib = torch.cat(outs)[dest].reshape(topk, T, d)
    return _gate_weighted_sum(contrib, gate_vals, ep), aux


def _local_capacity_maps(logits, topk: int, E: int, C: int, t0: int,
                         T_loc: int, e0: int, E_loc: int):
    """:func:`_capacity_slot_maps` over the GLOBAL logits ``[T, E]``, kept
    for this rank's tokens ``[t0, t0 + T_loc)`` and experts ``[e0, e0 +
    E_loc)``: ``(gate_vals [T_loc, k], aux, slots_of_entry [k, T_loc]
    (local slot id or -1: dropped, or another rank's expert), slot_valid
    [E_loc*C] (filled by one of this rank's tokens), slot_token [E_loc*C]
    (local token row; the sentinel ``T_loc`` elsewhere))``."""
    T = logits.shape[0]
    gate_vals, aux, soe, slot_valid, slot_entry = _capacity_slot_maps(
        logits, topk, E, C, T)
    if T_loc == T and E_loc == E:
        # every token and expert is this rank's: nothing to mask
        return (gate_vals, aux, soe, slot_valid,
                torch.where(slot_valid, slot_entry % T, T))
    lo, hi = e0 * C, (e0 + E_loc) * C
    tok = slot_entry[lo:hi] % T - t0
    valid = slot_valid[lo:hi] & (tok >= 0) & (tok < T_loc)
    slot_token = torch.where(valid, tok, T_loc)
    soe = soe[:, t0:t0 + T_loc]
    soe = torch.where((soe >= lo) & (soe < hi), soe - lo, -1)
    return gate_vals[t0:t0 + T_loc], aux, soe, valid, slot_token


def _moe_ffn_on_rank(mode: str, x, logits, wg, wu, wd, topk: int,
                     capacity: int, dp, ep):
    """The sorted, fused and dropless modes on one rank of a plan (or in
    one process: ``dp`` and ``ep`` None): ``x [T_loc, d]`` this rank's
    tokens, ``logits [T_loc, E]`` their routing logits, ``wg``/``wu``/``wd``
    this rank's ``E/ep`` experts; ``dp`` and ``ep`` the groups (None for an
    axis of one rank). Returns ``(y [T_loc, d], aux)`` with the global
    ``aux``. The kernel gathers by token row; the sentinel ``T_loc`` marks
    the slots that are not this rank's to fill, which the kernel zeroes."""
    T_loc = x.shape[0]
    t0 = _grank(dp) * T_loc
    E_loc = wg.shape[0]
    e0 = _grank(ep) * E_loc
    if dp is not None:
        # over the data group (its ranks hold other tokens): the global
        # batch's logits; backward, a summed reduce-scatter over it
        logits = c_allgather(logits, dp, 0)
    # over ep (its ranks hold the same tokens): each rank's experts give a
    # part of x's gradient, summed here in the backward
    xe = c_identity(x, ep) if ep is not None else x
    if mode == "dropless":
        y, aux = _dropless_moe_ffn(xe, logits, wg, wu, wd, topk, t0=t0,
                                   e0=e0, ep=ep)
    else:
        gate_vals, aux, soe, valid, slot_token = _local_capacity_maps(
            logits, topk, logits.shape[1], capacity, t0, T_loc, e0, E_loc)
        if mode == "fused":
            out = _FusedExpertFFN.apply(xe, slot_token.to(torch.int32),
                                        slot_token, valid, wg, wu, wd)
        else:
            out = _reference_expert_ffn(xe, slot_token, valid, wg, wu, wd)
        y = _slot_combine_weighted(out, gate_vals, soe, ep)
    # over ep: each rank combined its own experts' entries
    return (mp_allreduce(y, ep) if ep is not None else y), aux


class MoELayer(nn.Module):
    """Token-routed expert FFN bank (reference :552): ``forward(x [b, s, d])
    -> [b, s, d]``, and the load-balance loss of that call in ``l_aux``.

    ``device=None`` builds on the card (raises without CUDA). The expert
    banks ``w_gate_proj``/``w_up_proj`` ``[E, d, h]`` and ``w_down_proj``
    ``[E, h, d]`` and a gate made here are drawn N(0, ``init_std``) from a
    generator seeded with ``seed``; a gate passed in is left as it is. The
    experts are SwiGLU: ``activation`` is accepted and, as in the reference
    (:593), never read. The banks carry the placement ``(ep_axis, None,
    None)`` (``dist_spec``), which a plan reads ahead of its rule table, as
    the reference's does (:629-637); a plan's groups are attached by
    :meth:`wire` (see the module docstring). Under AMP the fast modes'
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
        place = (ep_axis, None, None)
        self.w_gate_proj = mark_placement(
            nn.Parameter(torch.empty(E, d, h, **kw)), place)
        self.w_up_proj = mark_placement(
            nn.Parameter(torch.empty(E, d, h, **kw)), place)
        self.w_down_proj = mark_placement(
            nn.Parameter(torch.empty(E, h, d, **kw)), place)
        self.l_aux: Optional[torch.Tensor] = None   # set by each forward
        # a plan's data- and expert-parallel groups (:meth:`wire`), and the
        # share of ``l_aux`` each data-parallel rank adds to its loss
        self._dp_pg = self._ep_pg = None
        self.aux_share = 1.0
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for p in ([self.w_gate_proj, self.w_up_proj, self.w_down_proj]
                      + ([self.gate.weight] if own_gate else [])):
                p.normal_(0.0, init_std, generator=gen)

    def capacity(self, num_tokens: int) -> int:
        per = num_tokens * max(self.gate.topk, 1) / self.num_experts
        return max(4, int(math.ceil(per * self.capacity_factor)))

    def wire(self, dp, ep) -> None:
        """Attach a plan's data group ``dp`` (over every data axis) and
        expert-parallel group ``ep`` (either None). A group of one rank is
        dropped, so such a plan runs the one-process code. ``ep`` is kept
        only when the banks are sharded over it (``E/ep`` experts here);
        banks left whole (a rule table that replicates them) run every
        expert on every rank, with nothing to reduce."""
        dp = dp if _size(dp) > 1 else None
        ep = ep if _size(ep) > 1 else None
        local = self.w_gate_proj.shape[0]
        if ep is not None and local == self.num_experts:
            ep = None
        elif local != self.num_experts and local * _size(ep) != \
                self.num_experts:
            raise ValueError(
                f"{self.num_experts} experts do not split into {local} a "
                f"rank over an expert-parallel group of {_size(ep)}")
        self._dp_pg, self._ep_pg = dp, ep
        self.aux_share = 1.0 / _size(dp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape[0], x.shape[1], self.d_model
        x_flat = x.reshape(b * s, d)
        dp, ep = self._dp_pg, self._ep_pg
        cap = self.capacity(b * s * _size(dp))
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
            y, aux = _moe_ffn_on_rank(self.dispatch_mode, x_flat, logits, wg,
                                      wu, wd, topk, cap, dp, ep)
            self.l_aux = aux
            return y.reshape(b, s, d)
        if dp is None:
            dispatch, combine, aux = self.gate.routing(x_flat, cap)
        else:
            # the gate routes the global batch; this rank keeps its rows
            t0 = _grank(dp) * x_flat.shape[0]
            dispatch, combine, aux = self.gate.routing(
                c_allgather(x_flat, dp, 0), cap)
            rows = slice(t0, t0 + x_flat.shape[0])
            dispatch, combine = dispatch[rows], combine[rows]
        self.l_aux = aux
        xe = x_flat
        if ep is not None:
            e0 = _grank(ep) * wg.shape[0]
            mine = slice(e0, e0 + wg.shape[0])
            dispatch = dispatch[:, mine]
            # f on the whole tensor: each rank's gradient covers its own
            # experts' columns, and the sum over ep assembles them
            combine = c_identity(combine, ep)[:, mine]
            xe = c_identity(x_flat, ep)
        xin = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xe)
        hmid = _tF.silu(torch.einsum("ecd,edh->ech", xin, wg)) \
            * torch.einsum("ecd,edh->ech", xin, wu)
        out = torch.einsum("ech,ehd->ecd", hmid, wd)
        y = torch.einsum("tec,ecd->td", combine.to(x.dtype), out)
        if ep is not None:
            y = mp_allreduce(y, ep)
        return y.reshape(b, s, d)


def moe_sharding_rules(ep_axis="ep", tp_axis="tp", fsdp_axis="fsdp"):
    """Rules for MoE LMs (reference :708-716): the expert banks on
    ``ep_axis`` (their ``dist_spec`` says so too; these are the fallback),
    the router replicated, the dense trunk as Llama."""
    from ..models.llama import llama_sharding_rules

    return [
        (r".*w_(gate|up|down)_proj$", (ep_axis,)),
        (r".*gate\.weight$", ()),
    ] + llama_sharding_rules(tp_axis=tp_axis, fsdp_axis=fsdp_axis)

