"""4D hybrid parallelism: dp x fsdp x tp x pp (and ep) in one mesh
(counterpart of ``paddlepaddle_tpu/parallel/hybrid.py``).

Reference surface: fleet/base/topology.py:189 ``HybridCommunicateGroup``
(data x pipe x sharding x sep x model) and the end-to-end recipe
test/auto_parallel/hybrid_strategy/semi_auto_llama.py. The stage programs
here run inside :func:`~.pipeline_spmd.spmd_pipeline_train` on each rank's
local shards, with explicit collectives over mesh axis names (resolved
through the executor's plan, :mod:`..distributed.collective` ``f_*``):

* **pp**: the stages, walked by the pipeline executor;
* **tp**: Megatron tensor parallel inside each stage: column-parallel
  q/k/v/gate/up (no communication), row-parallel o/down followed by one
  sum over ``tp`` per sub-block (mp_layers.py:336,543), the f/g pair
  (:func:`_fg_pair`), and a vocab-parallel cross-entropy head that never
  builds the full logits;
* **fsdp**: ZeRO-3 as gather-at-use: a weight lives sharded over ``fsdp``
  and is gathered inside the block (``f_all_gather``), whose backward is
  a summed reduce-scatter, the transpose of ``lax.all_gather``: the
  gradient arrives reduce-scattered, and the executor divides it;
* **dp**: the batch over ``dp`` (and ``fsdp``: both are data axes);
* **ep**: the MoE stage's expert banks (:func:`make_moe_block`).

* **sp**: context parallelism: the activations' sequence dim is sharded
  over ``sp_axis`` as well; rope takes the block's global positions, the
  attention sees every earlier block's K/V (all-gathered over ``sp``,
  un-repeated), and the head shifts its labels across the blocks and
  takes its mean over the global positions.

Attention runs :func:`~..ops.kernels.flash_attention.flash_attention_bshd`
on the local heads after the GQA repeat: kernels 2-4 on the card (head
dims 64 and 128; the plain version where ``routes_to_plain`` names the
shape, as the JAX ``_use_pallas`` gate does), the plain version on CPU
tensors. Under ``sp_axis`` the reference computes
:func:`_sp_blockwise_attention` (the gathered blocks one by one, future
blocks selected away), which is the plain version here (CPU tensors, or
``use_flash=False``); on the card the same function is ONE causal flash
call of the local queries over the gathered prefix ``[0, (r+1) s_loc)``:
the kernels' bottom-right causal alignment puts local query ``i`` at
global position ``r s_loc + i``, and the gather's backward (a summed
reduce-scatter, zeros past the prefix) returns each block its dK/dV.
Blocks and heads are callable objects (they pickle by reference, so the
single-process executor sends them to its ranks as they are).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as tF
from torch.utils.checkpoint import checkpoint

from ..distributed import collective as C
from ..models.llama import next_labels, rope_tables, rotate_half
from ..ops.kernels.flash_attention import flash_attention_bshd
from ..ops.kernels.ring_attention import _block_attn_update


class HybridStageConfig(NamedTuple):
    """Shape card for one homogeneous pipeline stage of a Llama-style LM."""

    hidden_size: int
    intermediate_size: int
    num_heads: int
    num_kv_heads: int
    layers_per_stage: int
    vocab_size: int
    max_seq_len: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _rms(x, g, eps):
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * g.float()).to(x.dtype)


def _rope(x, cos, sin):
    return x * cos + rotate_half(x) * sin


class _F:
    """Megatron's f over a mesh axis: identity forward, sum backward."""

    def __init__(self, axis):
        self.axis = axis

    def __call__(self, x):
        if self.axis is None:
            return x
        return C._CIdentity.apply(x, C._axis_pg(self.axis))


class _G:
    """Megatron's g over a mesh axis: sum forward, identity backward."""

    def __init__(self, axis):
        self.axis = axis

    def __call__(self, x):
        if self.axis is None:
            return x
        return C._MPAllReduce.apply(x, C._axis_pg(self.axis))


def _fg_pair(tp_axis):
    """Megatron's conjugate f/g operators (mp_layers.py c_identity /
    mp_allreduce) over ``tp_axis``:

    * ``f``: identity forward, sum backward, where a REPLICATED activation
      enters the tp-sharded region (each member's cotangent is a partial);
    * ``g``: sum forward, identity backward, the row-parallel output
      reduction, whose cotangent is already whole.
    """
    return _F(tp_axis), _G(tp_axis)


class _Gather:
    """ZeRO-3 gather-at-use over ``axis`` along a weight dim; backward, the
    summed reduce-scatter (``lax.all_gather``'s transpose)."""

    def __init__(self, axis):
        self.axis = axis

    def __call__(self, w, dim):
        if self.axis is None:
            return w
        return C.f_all_gather(w, self.axis, concat_axis=dim)


def _axis_index(axis) -> int:
    return 0 if axis is None else C.f_axis_index(axis)


def init_llama_stage(cfg: HybridStageConfig, key, dtype=torch.float32) -> dict:
    """Full (unsharded) parameters for ONE pipeline stage:
    ``layers_per_stage`` decoder layers, leaves with a leading layer dim,
    drawn from the ``torch.Generator`` ``key`` on its device. Stack stages
    with ``pipeline_spmd.stack_stage_params`` and shard with
    ``llama_stage_specs()``."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    hd = cfg.head_dim
    L = cfg.layers_per_stage
    dev = key.device

    def w(shape, fan_in):
        return (torch.randn((L,) + shape, generator=key, dtype=torch.float32,
                            device=dev) / math.sqrt(fan_in)).to(dtype)

    return {
        "ln1": torch.ones((L, h), dtype=dtype, device=dev),
        "ln2": torch.ones((L, h), dtype=dtype, device=dev),
        "wq": w((h, cfg.num_heads * hd), h),
        "wk": w((h, cfg.num_kv_heads * hd), h),
        "wv": w((h, cfg.num_kv_heads * hd), h),
        "wo": w((cfg.num_heads * hd, h), cfg.num_heads * hd),
        "wg": w((h, f), h),
        "wu": w((h, f), h),
        "wd": w((f, h), f),
    }


def init_llama_head(cfg: HybridStageConfig, key, dtype=torch.float32) -> dict:
    """Final norm + vocab projection (the vocab-parallel loss head)."""
    dev = key.device
    return {
        "ln": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev),
        "w": (torch.randn((cfg.hidden_size, cfg.vocab_size), generator=key,
                          dtype=torch.float32, device=dev)
              / math.sqrt(cfg.hidden_size)).to(dtype),
    }


def llama_stage_specs(tp_axis="tp", fsdp_axis="fsdp") -> dict:
    """Placement tuples for one stage's leaves (per-stage dims only; the
    executor handles the V/S dims). Column-parallel weights shard the
    output dim over tp, row-parallel the input dim; fsdp takes the other
    matmul dim (ZeRO-3)."""
    col = (None, fsdp_axis, tp_axis)   # [L, h, f]: gather h, keep f local
    row = (None, tp_axis, fsdp_axis)   # [L, f, h]: keep f local, gather h
    return {
        "ln1": (), "ln2": (),
        "wq": col, "wk": col, "wv": col, "wo": row,
        "wg": col, "wu": col, "wd": row,
    }


def llama_head_specs(tp_axis="tp") -> dict:
    """Head: vocab dim over tp (ParallelCrossEntropy layout); norm
    replicated."""
    return {"ln": (), "w": (None, tp_axis)}


def _sp_blockwise_attention(q, k, v, sp_axis, n_shards, scale, rep=1):
    """Context-parallel causal attention inside the pipeline executor
    (reference :207-241), the plain version: the K/V blocks all-gathered
    over ``sp_axis`` (un-repeated; backward, a summed reduce-scatter), then
    the online softmax over them block by block against the local Q
    block at global offsets, a block fully in the future selected away.
    q ``[b, s_loc, h, d]``, k/v ``[b, s_loc, kvh, d]``."""
    my = _axis_index(sp_axis)
    b, s_loc, h, d = q.shape
    kg = C.f_all_gather(k, sp_axis, concat_axis=1)      # [b, n*s_loc, ...]
    vg = C.f_all_gather(v, sp_axis, concat_axis=1)
    m = torch.full((b, h, s_loc, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    for j in range(my + 1):               # later blocks: fully in the future
        kj = kg[:, j * s_loc:(j + 1) * s_loc]
        vj = vg[:, j * s_loc:(j + 1) * s_loc]
        if rep > 1:                       # the GQA repeat AFTER the gather
            kj = kj.repeat_interleave(rep, dim=2)
            vj = vj.repeat_interleave(rep, dim=2)
        m, l, acc = _block_attn_update(q, kj, vj, m, l, acc, my * s_loc,
                                       j * s_loc, True, scale)
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _sp_prefix_attention(q, k, v, sp_axis, rep):
    """The same function on the card: the gathered K/V cut to the prefix
    ``[0, (r+1) s_loc)`` and one causal flash call over it (module
    docstring): kernels 2-4."""
    my = _axis_index(sp_axis)
    s_loc = q.shape[1]
    end = (my + 1) * s_loc
    kp = C.f_all_gather(k, sp_axis, concat_axis=1)[:, :end]
    vp = C.f_all_gather(v, sp_axis, concat_axis=1)[:, :end]
    if rep > 1:
        kp = kp.repeat_interleave(rep, dim=2)
        vp = vp.repeat_interleave(rep, dim=2)
    return flash_attention_bshd(q, kp, vp, causal=True)


def _attention_residual(x, lp, *, cfg, cos_t, sin_t, f_in, g_out, gather,
                        sp_axis=None, sp_size=1, use_flash=True):
    """x + attention(x): the residual attention sub-block SHARED by the
    dense (make_llama_block) and MoE (make_moe_block) stages: column qkv,
    rope at global positions, flash / plain-softmax / context-parallel
    allgather-KV attention on the local heads, row o-proj + tp sum."""
    b, s, h = x.shape
    dt = x.dtype
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    hn = f_in(_rms(x, lp["ln1"], cfg.rms_norm_eps))
    wq, wk, wv = gather(lp["wq"], 0), gather(lp["wk"], 0), gather(lp["wv"], 0)
    wo = gather(lp["wo"], 1)
    q = (hn @ wq).reshape(b, s, -1, hd)
    k = (hn @ wk).reshape(b, s, -1, hd)
    v = (hn @ wv).reshape(b, s, -1, hd)
    off = 0
    if sp_axis is not None:
        # rope needs GLOBAL positions: this block holds rows [r*s, r*s + s)
        # of the sequence; past the tables is an error, never a clamp
        if sp_size * s > cfg.max_seq_len:
            raise ValueError(
                f"global sequence {sp_size * s} exceeds max_seq_len "
                f"{cfg.max_seq_len} (s_local={s} x sp_size={sp_size})")
        off = _axis_index(sp_axis) * s
    cos = cos_t[off:off + s][None, :, None, :].to(dt)
    sin = sin_t[off:off + s][None, :, None, :].to(dt)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    rep = q.shape[2] // k.shape[2]
    if sp_axis is not None:
        if use_flash and q.is_cuda:
            out = _sp_prefix_attention(q, k, v, sp_axis, rep)
        else:
            out = _sp_blockwise_attention(q, k, v, sp_axis, sp_size, scale,
                                          rep)
        return x + g_out(out.to(dt).reshape(b, s, -1) @ wo)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if use_flash:
        out = flash_attention_bshd(q, k, v, causal=True)
    else:
        qt = q.transpose(1, 2).float() * scale
        kt = k.transpose(1, 2).float()
        lg = qt @ kt.transpose(-1, -2)
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        lg = lg.masked_fill(~keep, -1e30)
        pr = torch.softmax(lg, dim=-1).to(v.dtype)
        out = (pr @ v.transpose(1, 2)).transpose(1, 2)
    return x + g_out(out.to(dt).reshape(b, s, -1) @ wo)


def _import_checkpoint_deps(remat) -> None:
    """``torch.utils.checkpoint``'s first call imports ``torch._dynamo``
    (seconds in a fresh process). A remat block does it where each rank
    builds or receives it, so that no rank pays it inside the schedule
    walk while its neighbours wait on its transfer."""
    if remat:
        import torch._dynamo  # noqa: F401


class _Block:
    """A stage: ``layers_per_stage`` layers over leaves with a leading
    layer dim, each layer under ``torch.utils.checkpoint`` when ``remat``
    (and autograd is recording)."""

    def __init__(self, cfg, tp_axis, fsdp_axis, remat, use_flash,
                 sp_axis=None, sp_size=1):
        self.cfg = cfg
        self.tp_axis, self.fsdp_axis = tp_axis, fsdp_axis
        self.sp_axis, self.sp_size = sp_axis, int(sp_size)
        self.remat, self.use_flash = remat, use_flash
        self.f_in, self.g_out = _fg_pair(tp_axis)
        self.gather = _Gather(fsdp_axis)
        self._tables = {}
        _import_checkpoint_deps(remat)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_tables"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        _import_checkpoint_deps(self.remat)

    def tables(self, device):
        key = str(device)
        if key not in self._tables:
            c = self.cfg
            self._tables[key] = rope_tables(c.head_dim, c.max_seq_len,
                                            c.rope_theta, device=device)
        return self._tables[key]

    def attention(self, x, lp):
        cos_t, sin_t = self.tables(x.device)
        return _attention_residual(
            x, lp, cfg=self.cfg, cos_t=cos_t, sin_t=sin_t, f_in=self.f_in,
            g_out=self.g_out, gather=self.gather, sp_axis=self.sp_axis,
            sp_size=self.sp_size, use_flash=self.use_flash)

    def layer(self, x, lp):
        raise NotImplementedError

    def __call__(self, params, x):
        L = next(iter(params.values())).shape[0]
        for i in range(L):
            lp = {k: v[i] for k, v in params.items()}
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self.layer, x, lp, use_reentrant=False)
            else:
                x = self.layer(x, lp)
        return x


class _LlamaBlock(_Block):
    def layer(self, x, lp):
        x = self.attention(x, lp)
        # MLP: column gate/up, row down + tp sum
        hm = self.f_in(_rms(x, lp["ln2"], self.cfg.rms_norm_eps))
        wg, wu = self.gather(lp["wg"], 0), self.gather(lp["wu"], 0)
        wd = self.gather(lp["wd"], 1)
        return x + self.g_out((tF.silu(hm @ wg) * (hm @ wu)) @ wd)


def make_llama_block(cfg: HybridStageConfig, tp_axis="tp", fsdp_axis="fsdp",
                     sp_axis=None, sp_size=1, remat=True, use_flash=True):
    """(stage_params_local, acts) -> acts: one pipeline stage =
    ``layers_per_stage`` decoder layers with explicit tp / fsdp
    collectives over the local shards (``llama_stage_specs``); activations
    are replicated over tp and batch-sharded over the data axes by the
    executor. With ``sp_axis`` their sequence dim is sharded over that
    context-parallel axis as well (``seq_axis`` of the executor) and
    attention runs over the gathered K/V blocks (module docstring): the
    full 5-D dp x fsdp x tp x pp x sp composition. ``sp_size`` must be
    the mesh size of ``sp_axis``."""
    return _LlamaBlock(cfg, tp_axis, fsdp_axis, remat, use_flash, sp_axis,
                       sp_size)


class _VocabParallelHead:
    def __init__(self, cfg, tp_axis, sp_axis=None):
        self.eps = cfg.rms_norm_eps
        self.tp_axis = tp_axis
        self.sp_axis = sp_axis
        self.f_in, self.g_out = _fg_pair(tp_axis)
        self.g_sp = _G(sp_axis)

    def __call__(self, hp, x, labels):
        xn = self.f_in(_rms(x, hp["ln"], self.eps))
        logits = (xn @ hp["w"]).float()                  # [b, s, V_local]
        v_loc = logits.shape[-1]
        off = _axis_index(self.tp_axis) * v_loc
        lbl, pos, s_total = next_labels(labels, None if self.sp_axis is None
                                        else C._axis_pg(self.sp_axis))
        lbl = lbl.long()
        # the max shift is numerical stability only: no gradient
        with torch.no_grad():
            m = logits.max(dim=-1).values
            if self.tp_axis is not None:
                C._all_reduce_(m, "max", C._axis_pg(self.tp_axis))
        se = self.g_out(torch.exp(logits - m[..., None]).sum(-1))
        lse = m + torch.log(se)
        mine = (lbl >= off) & (lbl < off + v_loc)
        safe = (lbl - off).clamp(0, v_loc - 1)
        lab = logits.gather(-1, safe[..., None])[..., 0]
        lab = self.g_out(torch.where(mine, lab, torch.zeros_like(lab)))
        nll = lse - lab
        valid = ((lbl >= 0) & (pos < s_total - 1)).float()
        # g over sp (identity backward): each block's cotangent is whole
        num = self.g_sp((nll * valid).sum())
        den = self.g_sp(valid.sum())
        return num / den.clamp(min=1.0)


def make_vocab_parallel_head(cfg: HybridStageConfig, tp_axis="tp",
                             sp_axis=None):
    """(head_params_local, acts, labels) -> scalar mean next-token CE.

    ParallelCrossEntropy semantics (the reference's
    c_softmax_with_cross_entropy): logits stay vocab-sharded over tp; the
    softmax normalizer and the label logit are assembled with sums and a
    max over tp, so the full [b, s, V] tensor never exists. Same shift /
    mask as ``models.llama.loss_from_logits``. With ``sp_axis`` the
    sequence dim is context-sharded: the label shift crosses the blocks,
    positions and the valid mask are global, and numerator and denominator
    are summed over sp (reference :244-300)."""
    return _VocabParallelHead(cfg, tp_axis, sp_axis)


def reference_forward(cfg: HybridStageConfig, per_stage_params, head_params,
                      acts, labels):
    """Unsharded one-rank forward, the parity oracle: the same math as
    make_llama_block(tp=None, fsdp=None) chained over stages + the head
    loss with the full vocab."""
    block = make_llama_block(cfg, tp_axis=None, fsdp_axis=None, remat=False,
                             use_flash=False)
    head = make_vocab_parallel_head(cfg, tp_axis=None)
    x = acts
    for sp in per_stage_params:
        x = block(sp, x)
    return head(head_params, x, labels)


# ---------------------------------------------------------------------------
# MoE stage: expert parallelism composed with the pipeline (ep x tp x pp:
# the ERNIE/DeepSeek hybrid layout, fleet/base/topology.py + moe_layer.py)
# ---------------------------------------------------------------------------


def init_moe_stage(cfg: HybridStageConfig, key, num_experts: int,
                   expert_hidden: int, dtype=torch.float32) -> dict:
    """One pipeline stage whose MLP is an expert bank: llama attention
    params + gate [h, E] + stacked expert FFNs [L, E, ...]."""
    h = cfg.hidden_size
    L = cfg.layers_per_stage
    base = init_llama_stage(cfg, key, dtype)
    for k_ in ("wg", "wu", "wd"):
        del base[k_]

    def w(shape, fan_in):
        return (torch.randn((L,) + shape, generator=key, dtype=torch.float32,
                            device=key.device) / math.sqrt(fan_in)).to(dtype)

    base["gate"] = w((h, num_experts), h)
    base["eg"] = w((num_experts, h, expert_hidden), h)
    base["eu"] = w((num_experts, h, expert_hidden), h)
    base["ed"] = w((num_experts, expert_hidden, h), expert_hidden)
    return base


def moe_stage_specs(tp_axis="tp", fsdp_axis="fsdp", ep_axis="ep") -> dict:
    """Attention sharded like the dense stage; expert banks over ep; the
    router replicated (every ep member routes identically)."""
    specs = llama_stage_specs(tp_axis=tp_axis, fsdp_axis=fsdp_axis)
    for k_ in ("wg", "wu", "wd"):
        del specs[k_]
    specs["gate"] = ()
    specs["eg"] = (None, ep_axis)
    specs["eu"] = (None, ep_axis)
    specs["ed"] = (None, ep_axis)
    return specs


class _InjectAux(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, aux, weight):
        ctx.weight = weight
        ctx.aux_meta = (aux.shape, aux.dtype, aux.device)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        shape, dtype, dev = ctx.aux_meta
        return dy, torch.full(shape, ctx.weight, dtype=dtype, device=dev), \
            None


def _inject_aux_grad(y, aux, weight):
    """Identity on ``y`` whose backward ALSO seeds ``aux``'s cotangent with
    ``weight``: how a scalar auxiliary objective rides through a block
    whose contract only returns activations."""
    return _InjectAux.apply(y, aux, float(weight))


class _MoEBlock(_Block):
    def __init__(self, cfg, num_experts, topk, capacity_factor, tp_axis,
                 fsdp_axis, ep_axis, ep_size, aux_loss_weight, remat,
                 use_flash):
        super().__init__(cfg, tp_axis, fsdp_axis, remat, use_flash)
        self.E, self.topk = num_experts, topk
        self.capacity_factor = capacity_factor
        self.ep_axis, self.ep_size = ep_axis, ep_size
        self.aux_loss_weight = aux_loss_weight
        self.f_ep, self.g_ep = _fg_pair(ep_axis)

    def layer(self, x, lp):
        from .moe import _top1_routing, _topk_routing

        b, s, h = x.shape
        dt = x.dtype
        x = self.attention(x, lp)
        # MoE MLP (ep-parallel GShard einsum)
        hm = self.f_ep(_rms(x, lp["ln2"], self.cfg.rms_norm_eps))
        E = self.E
        el = E // max(self.ep_size, 1)
        T = b * s
        cap = max(4, int(math.ceil(T * self.topk / E * self.capacity_factor)))
        xf = hm.reshape(T, h)
        # each ep member backprops through its own experts only: the
        # f-operator's sum backward assembles the whole router gradient
        gate_w = self.f_ep(lp["gate"].float())
        logits = xf.float() @ gate_w
        if self.topk == 1:
            disp, comb, aux = _top1_routing(logits, cap)
        else:
            disp, comb, aux = _topk_routing(logits, cap, self.topk)
        my = _axis_index(self.ep_axis)
        d_loc = disp[:, my * el:(my + 1) * el]
        c_loc = comb[:, my * el:(my + 1) * el]
        xin = torch.einsum("tec,td->ecd", d_loc.to(dt), xf)
        hmid = tF.silu(torch.einsum("ecd,edh->ech", xin, lp["eg"]))
        hmid = hmid * torch.einsum("ecd,edh->ech", xin, lp["eu"])
        outp = torch.einsum("ech,ehd->ecd", hmid, lp["ed"])
        y = torch.einsum("tec,ecd->td", c_loc.to(dt), outp)
        y = self.g_ep(y).reshape(b, s, h)
        # the aux loss enters through its gradient, PER MICROBATCH: pass
        # aux_loss_weight = desired total weight / n_microbatches
        if self.aux_loss_weight:
            y = _inject_aux_grad(y, aux, self.aux_loss_weight)
        return x + y


def make_moe_block(cfg: HybridStageConfig, num_experts: int, topk: int = 2,
                   capacity_factor: float = 2.0, tp_axis="tp",
                   fsdp_axis="fsdp", ep_axis="ep", ep_size: int = 1,
                   aux_loss_weight: float = 0.0, remat=True, use_flash=True):
    """(stage_params_local, acts) -> acts: llama attention + an
    EXPERT-PARALLEL MoE MLP.

    GShard semantics with explicit collectives: tokens stay replicated
    over ep, every member routes identically (replicated gate,
    ``parallel.moe`` routing), each member einsum-dispatches only to its
    LOCAL expert slice, and the combined outputs meet in one g-style sum
    over ep. The token cotangent sums each member's partial path via the
    f-operator."""
    if ep_axis is not None and ep_size <= 1:
        raise ValueError(
            "ep_axis set but ep_size<=1: pass the mesh's ep axis size")
    if num_experts % max(ep_size, 1):
        raise ValueError(
            f"num_experts={num_experts} not divisible by ep_size={ep_size}")
    return _MoEBlock(cfg, num_experts, topk, capacity_factor, tp_axis,
                     fsdp_axis, ep_axis, ep_size, aux_loss_weight, remat,
                     use_flash)
