"""Tensor-parallel (Megatron) layers on local shards (counterpart of
``paddlepaddle_tpu/parallel/mpu.py`` :32-165).

The reference attaches a GSPMD placement to each parameter and lets XLA
insert the collectives. Here each rank holds its shard and the layer runs
the f/g pair of :mod:`..distributed.collective` itself:

* :class:`ColumnParallelLinear` (reference :68): ``W [in, out/n]``; input
  through ``c_identity`` (all-reduce in backward), output sharded on its
  last dim or gathered (``gather_output``);
* :class:`RowParallelLinear` (:99): ``W [in/n, out]``; input sharded on its
  last dim (``input_is_parallel``) or split here, output ``mp_allreduce``
  (all-reduce forward), the bias added once after it;
* :class:`VocabParallelEmbedding` (:127): rows ``[V/n, h]``; ids outside
  the rank's range read zeros, then the ranks' rows are summed;
* :class:`ParallelCrossEntropy` (:144): per-row cross entropy over
  class-sharded logits by a distributed log-sum-exp.

:func:`parallel_view` applies the same roles to a model's own projections
under a :class:`~..distributed.shard_plan.ShardingPlan` (what
``plan.shard(model)`` returns), in two halves: :func:`cut_view` (a rank's
blocks, marked with their roles, picklable) and :func:`wire_view` (the
collectives over the rank's group), which a single-process engine runs in
different processes. A parameter sharded over a parameter-sharding (ZeRO-3)
axis, ``fsdp`` the usual one, is gathered over it where its module uses it
(:func:`gather_scope`, :class:`_GatherOnUse`), whatever the module, and the
whole tensor goes on to the module's Megatron wiring. The
sequence-parallel half (reference :166-198): the activations between the
sequence-parallel layers are sequence blocks on the ranks of the model
axis (:func:`scatter_to_sequence_parallel`,
:func:`gather_from_sequence_parallel`, :class:`ColumnSequenceParallelLinear`,
:class:`RowSequenceParallelLinear`), and a parameter used on the blocks is
marked (:func:`mark_as_sequence_parallel_parameter`) so the sharded step
sums its gradient over that axis; ``SequenceParallelBegin`` / ``End``
reach the same wiring through a plan's view
(:func:`mark_sequence_parallel_region`).

The group of a layer built directly is ``mp_group`` (a
:class:`~..distributed.collective.Group` or a process group), else the
global mesh's ``mp_axis`` group, else the world; in a process without a
group it is a layer of one rank.
"""

from __future__ import annotations

import contextlib
import copy
import math
import functools
import re
import threading

import torch
import torch.distributed as dist
from torch import nn

from ..distributed.collective import (_all_gather, _all_reduce_, _CConcat,
                                      _CSplit, _grank, _reduce_scatter,
                                      _ReduceScatter, _resolve_pg, _size,
                                      c_concat, c_identity, c_split,
                                      mp_allreduce)
from ..device import resolve_device
from ..core.dtype import to_torch_dtype
from ..nn import functional as F
from ..nn.common import Linear  # noqa: F401  (the reference's path)


def mark_placement(param, spec):
    """Attach a placement (a mesh-axis name or None per dim) to a
    parameter; ``ShardedTrainStep`` reads it ahead of its rule table."""
    param.dist_spec = tuple(spec)
    return param


def _group(mp_group, mp_axis):
    if not dist.is_initialized():
        return None
    if mp_group is not None:
        return _resolve_pg(mp_group)
    from ..distributed.mesh import get_mesh

    mesh = get_mesh()
    if mesh is not None and mp_axis in mesh.dim_names:
        return mesh.group(mp_axis)
    return dist.group.WORLD


def _size_rank(pg):
    if pg is None:
        return 1, 0
    return pg.size(), pg.rank()


def _init_full(rows, cols, std, device, dtype):
    """The full matrix from the port's seeded generator, identical on every
    rank (each then keeps its block)."""
    from ..core import random

    w = torch.empty(rows, cols, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=random.torch_generator(device))
    return w


class ColumnParallelLinear(nn.Module):
    """``y = x W (+ b)``, ``W [in, out]`` sharded on OUT over the group."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, mp_axis="mp", *, device=None,
                 dtype="float32"):
        super().__init__()
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        self.pg = _group(mp_group, mp_axis)
        n, r = _size_rank(self.pg)
        if out_features % n:
            raise ValueError(f"out_features {out_features} does not split "
                             f"over {n} ranks")
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.mp_axis = mp_axis
        std = math.sqrt(2.0 / (in_features + out_features))
        full = _init_full(in_features, out_features, std, dev, dt)
        self.weight = mark_placement(
            nn.Parameter(full.chunk(n, dim=1)[r].contiguous()),
            (None, mp_axis))
        self.bias = (mark_placement(nn.Parameter(torch.zeros(
            out_features // n, device=dev, dtype=dt)), (mp_axis,))
            if has_bias else None)

    def forward(self, x):
        y = F.linear(c_identity(x, self.pg), self.weight, self.bias)
        return c_concat(y, self.pg, -1) if self.gather_output else y


class RowParallelLinear(nn.Module):
    """``y = x W (+ b)``, ``W [in, out]`` sharded on IN over the group; the
    partial products are all-reduced."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 mp_axis="mp", *, device=None, dtype="float32"):
        super().__init__()
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        self.pg = _group(mp_group, mp_axis)
        n, r = _size_rank(self.pg)
        if in_features % n:
            raise ValueError(f"in_features {in_features} does not split "
                             f"over {n} ranks")
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.mp_axis = mp_axis
        std = math.sqrt(2.0 / (in_features + out_features))
        full = _init_full(in_features, out_features, std, dev, dt)
        self.weight = mark_placement(
            nn.Parameter(full.chunk(n, dim=0)[r].contiguous()),
            (mp_axis, None))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=dev,
                                              dtype=dt))
                     if has_bias else None)

    def forward(self, x):
        if not self.input_is_parallel:
            x = c_split(x, self.pg, -1)
        y = mp_allreduce(F.linear(x, self.weight), self.pg)
        return y + self.bias if self.bias is not None else y


class VocabParallelEmbedding(nn.Module):
    """Embedding rows ``[V, h]`` sharded on the vocab over the group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, mp_axis="mp", *, device=None,
                 dtype="float32"):
        super().__init__()
        dev, dt = resolve_device(device), to_torch_dtype(dtype)
        self.pg = _group(mp_group, mp_axis)
        n, r = _size_rank(self.pg)
        if num_embeddings % n:
            raise ValueError(f"num_embeddings {num_embeddings} does not "
                             f"split over {n} ranks")
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = None
        full = _init_full(num_embeddings, embedding_dim, 1.0, dev, dt)
        self.weight = mark_placement(
            nn.Parameter(full.chunk(n, dim=0)[r].contiguous()),
            (mp_axis, None))
        self._start = r * (num_embeddings // n)

    @classmethod
    def from_local(cls, weight: nn.Parameter, num_embeddings: int, pg,
                   padding_idx=None) -> "VocabParallelEmbedding":
        """The layer over an existing local row block (a plan's view)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        n, r = _size_rank(pg)
        self.pg = pg
        self.num_embeddings = num_embeddings
        self.embedding_dim = weight.shape[1]
        self.padding_idx = padding_idx
        self.weight = weight
        self._start = r * (num_embeddings // n)
        return self

    def forward(self, x):
        rows = self.weight.shape[0]
        local = x.long() - self._start
        outside = (local < 0) | (local >= rows)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        if self.padding_idx is not None:
            out = out.masked_fill((x == self.padding_idx)[..., None], 0.0)
        return mp_allreduce(out, self.pg)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row ``lse(logits) - logits[label]`` over class-sharded logits:
    global max and sum of exponentials by all-reduce; the backward is this
    rank's block of ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, label, pg, ignore_index):
        n, r = _size_rank(pg)
        V = logits.shape[-1]
        start = r * V
        lf = logits if logits.dtype == torch.float64 else logits.float()
        gmax = _all_reduce_(lf.amax(-1, keepdim=True).clone(), "max", pg)
        ex = torch.exp(lf - gmax)
        sumex = _all_reduce_(ex.sum(-1, keepdim=True), "sum", pg)
        lab = label.long()
        local = lab - start
        inside = (local >= 0) & (local < V)
        picked = lf.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
        picked = _all_reduce_(torch.where(inside, picked, 0.0), "sum", pg)
        loss = torch.log(sumex[..., 0]) + gmax[..., 0] - picked
        keep = lab != ignore_index
        ctx.save_for_backward(ex, sumex, local, inside, keep)
        ctx.dtype = logits.dtype
        return torch.where(keep, loss, 0.0)

    @staticmethod
    def backward(ctx, g):
        ex, sumex, local, inside, keep = ctx.saved_tensors
        p = ex / sumex
        V = p.shape[-1]
        onehot = torch.nn.functional.one_hot(local.clamp(0, V - 1), V)
        p = p - onehot * inside[..., None]
        grad = p * (g * keep)[..., None]
        return grad.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-row softmax cross entropy (shape ``[..., 1]``, as the
    reference's ``softmax_with_cross_entropy``) over logits whose class dim
    is sharded over the group."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.pg = _group(mp_group, "mp")

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label[..., 0]
        loss = _VocabParallelCE.apply(input, label, self.pg,
                                      self.ignore_index)
        return loss[..., None]


# ---------------------------------------------------------------------------
# sequence parallel (Megatron SP over activations, reference :166-198)
# ---------------------------------------------------------------------------
#
# The reference constrains the activations' sequence dim to the mp axis and
# GSPMD computes the dense values. Here the ranks of the model-axis group
# each hold one block of the sequence ``[b, s/n, h]`` between the
# sequence-parallel layers, and the layers make the collectives themselves.
# A parameter used on those blocks (a norm's weight) gets a partial gradient
# on each rank: ``mark_as_sequence_parallel_parameter`` marks it, and
# ``ShardedTrainStep`` sums its gradient over the model axis.


def _sp_group(mp_axis):
    """The group of ``mp_axis``: the active plan's (``with plan:``), else
    the global mesh's or the world (None in a process without a group)."""
    from ..distributed import collective as C

    mesh = C._mesh_stack[-1] if C._mesh_stack else None
    if mesh is not None and mp_axis in getattr(mesh, "axes", {}):
        if getattr(mesh, "bound", False) or dist.is_initialized():
            return mesh.axis_group(mp_axis)
        return None
    return _group(None, mp_axis)


def scatter_to_sequence_parallel(x, mp_axis="mp", group=None):
    """``[b, s, h]`` -> this rank's block ``[b, s/n, h]`` of the sequence
    over ``mp_axis`` (reference ScatterOp, :166); backward, the blocks'
    gradients all-gathered. ``group`` overrides the axis's group."""
    pg = group if group is not None else _sp_group(mp_axis)
    return _CSplit.apply(x, pg, 1)


def gather_from_sequence_parallel(x, mp_axis="mp", group=None):
    """The sequence blocks all-gathered back to ``[b, s, h]`` (reference
    GatherOp, :171); backward, this rank's block of the cotangent."""
    pg = group if group is not None else _sp_group(mp_axis)
    return _CConcat.apply(x, pg, 1)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input arrives as sequence blocks: the
    blocks are gathered, then the column product (reference :176). Its
    input's gradient is the all-reduce of f, cut to this rank's block: a
    reduce-scatter."""

    def forward(self, x):
        return super().forward(gather_from_sequence_parallel(
            x, self.mp_axis, group=self.pg))


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output leaves as sequence blocks: the
    partial products are reduce-scattered over the sequence in place of
    the all-reduce (reference :186), then the bias is added on the block.
    The bias is a sequence-parallel parameter (its gradient is summed over
    the group by ``ShardedTrainStep``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 mp_axis="mp", *, device=None, dtype="float32"):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         input_is_parallel, fuse_matmul_bias, mp_group,
                         name, mp_axis, device=device, dtype=dtype)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if not self.input_is_parallel:
            x = c_split(x, self.pg, -1)
        y = _ReduceScatter.apply(F.linear(x, self.weight), self.pg, 1)
        return y + self.bias if self.bias is not None else y


def mark_as_sequence_parallel_parameter(param):
    """Mark a parameter used on sequence blocks (reference :194; a no-op
    there, since GSPMD sums its gradient): ``param.sequence_parallel`` is
    set, and ``ShardedTrainStep`` all-reduces its gradient over the model
    axis, as Paddle's ``register_sequence_parallel_allreduce_hooks`` does.
    Returns the parameter."""
    param.sequence_parallel = True
    return param


_MPU_LAYERS = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)


def mark_sequence_parallel_region(model: nn.Module) -> None:
    """What ``SequenceParallelBegin`` / ``End`` imply for the modules
    between them (in ``named_modules`` order: after the subtree of a module
    marked ``_sp_begin``, up to one marked ``_sp_end``), whose activations
    are sequence blocks on each rank of the model axis. A module whose
    weight carries a model-axis placement (``ColWiseParallel`` /
    ``RowWiseParallel``) is marked ``_sp_seq``: a plan's view gathers the
    sequence ahead of a column one and reduce-scatters it after a row one.
    Every parameter of the other modules (the norms) is marked with
    :func:`mark_as_sequence_parallel_parameter`."""
    inside, begin = False, None
    for name, mod in model.named_modules():
        if getattr(mod, "_sp_begin", None):
            inside, begin = True, name
            continue
        if begin is not None and name.startswith(begin + "."):
            continue
        if getattr(mod, "_sp_end", None):
            inside, begin = False, None
            continue
        if not inside:
            continue
        w = mod._parameters.get("weight")
        if w is not None and any(e is not None for e in
                                 getattr(w, "dist_spec", None) or ()):
            mod._sp_seq = True
            continue
        for p in mod._parameters.values():
            if p is not None:
                mark_as_sequence_parallel_parameter(p)


# ---------------------------------------------------------------------------
# a model's view under a plan
# ---------------------------------------------------------------------------

# the column-parallel projection whose output is consumed whole: the LM
# head's vocab-sharded logits are gathered before sampling and the loss
_GATHER_OUTPUT = re.compile(r"(^|\.)lm_head\.$")


def _copy_hooks(d: dict) -> None:
    for k, v in list(d.items()):
        if k.endswith("hooks") or "_hooks_" in k:
            d[k] = type(v)(v)


def _hooks_for(new: nn.Module, role: str, gather: bool, pg,
               seq: bool = False) -> None:
    """A column projection's input through f (after the sequence blocks
    are gathered, ``seq``), its output gathered when ``gather``; a row
    projection's output all-reduced, or reduce-scattered over the
    sequence (``seq``)."""
    if role == "column":
        if seq:
            new.register_forward_pre_hook(
                lambda m, args: (c_identity(_CConcat.apply(args[0], pg, 1),
                                            pg),) + tuple(args[1:]))
        else:
            new.register_forward_pre_hook(
                lambda m, args: (c_identity(args[0], pg),) + tuple(args[1:]))
        if gather:
            new.register_forward_hook(
                lambda m, args, out: c_concat(out, pg, -1))
    elif role == "row":
        if seq:
            new.register_forward_hook(
                lambda m, args, out: _ReduceScatter.apply(out, pg, 1))
        else:
            new.register_forward_hook(
                lambda m, args, out: mp_allreduce(out, pg))


def _wire_sequence(mod: nn.Module, pg) -> None:
    """``SequenceParallelBegin``'s scatter after the module's output (after
    its tensor-parallel hooks) and ``SequenceParallelEnd``'s gather ahead
    of its input (ahead of a column projection's f too: f must sum the
    whole sequence's partial gradients, which the gather's backward then
    cuts to this rank's block)."""
    if getattr(mod, "_sp_begin", None):
        mod.register_forward_hook(
            lambda m, args, out: _CSplit.apply(out, pg, 1))
    if getattr(mod, "_sp_end", None):
        mod.register_forward_pre_hook(
            lambda m, args: tuple(_CConcat.apply(a, pg, 1)
                                  if isinstance(a, torch.Tensor) else a
                                  for a in args), prepend=True)


@functools.lru_cache(maxsize=None)
def _row_int8_class():
    """A row-parallel per-channel int8 projection: the all-reduce sits
    between the int8 product and the scale multiply, where the reference's
    partitioner puts it (``wo_matmul`` scales the product, so XLA reduces
    the partial products first)."""
    from ..nn.quant.quantized_linear import WeightOnlyLinear

    class RowParallelWeightOnlyLinear(WeightOnlyLinear):
        def forward(self, x):
            cd = x.dtype if x.is_floating_point() \
                else to_torch_dtype(self.out_dtype)
            y = mp_allreduce(torch.matmul(x, self.quant_weight.to(cd)),
                             self._tp_pg) * self.weight_scale.to(cd)
            if self.bias is not None:
                y = y + self.bias
            return y.to(x.dtype) if x.is_floating_point() else y

    return RowParallelWeightOnlyLinear


def parallel_view(model: nn.Module, plan, pg, share: bool = True
                  ) -> nn.Module:
    """A shallow view of ``model`` whose parameters (and weight-only int8
    buffers) are this rank's shards under ``plan`` and whose sharded
    projections run column- or row-parallel over ``pg``: Linear and
    WeightOnlyLinear by hooks (a column one's input through
    ``c_identity``, the LM head's output gathered; a row one's output
    all-reduced), an embedding sharded on its hidden dim gathered after
    the lookup, one sharded on its vocabulary swapped for a
    :class:`VocabParallelEmbedding`; an MoE layer takes the plan's data-
    and expert-parallel groups. Names are the model's own. It is
    :func:`cut_view` (this rank's blocks) then :func:`wire_view` (the
    collectives)."""
    return wire_view(cut_view(model, plan, share=share), pg,
                     dp=plan.data_group, ep=plan.ep_group,
                     zero=plan.zero_groups())


def cut_view(model: nn.Module, plan, share: bool = True, rank=None
             ) -> nn.Module:
    """The first half of :func:`parallel_view`: a view of ``model`` holding
    rank ``rank``'s (default: this rank's) blocks under ``plan``, with no
    collective attached. A parameter's own placement (``dist_spec``, as the
    MoE banks carry) wins over the plan's rule table. Each module that
    takes one is marked with its tensor-parallel role (``_tp_wire``), and
    each that holds a parameter sharded over a parameter-sharding axis
    with its dims and axes (``_zero_gather``), which :func:`wire_view`
    reads. It holds no hook and no process group, so it
    pickles: a single-process engine or train step cuts every rank's view
    and hands each worker its own."""
    from ..nn.common import Embedding
    from ..nn.quant.quantized_linear import WeightOnlyLinear
    from ..nn.quant.qweight import QuantizedWeight
    from .moe import MoELayer
    from .sharded import _fit_spec

    def view(mod: nn.Module, prefix: str) -> nn.Module:
        new = copy.copy(mod)
        d = new.__dict__
        _copy_hooks(d)
        params = {}
        full_shapes = {}
        gathers = {}
        owns = {}
        # a Megatron layer built over a group of several ranks holds its
        # rank's block already; one built in one process holds the whole
        local = isinstance(mod, _MPU_LAYERS) and _size(mod.pg) > 1
        if isinstance(mod, _MPU_LAYERS):
            new.pg = None
        for pname, p in mod._parameters.items():
            if p is None:
                params[pname] = None
                continue
            name = prefix + pname
            full_shapes[pname] = tuple(p.shape)
            own = getattr(p, "dist_spec", None)
            owns[pname] = own
            if local:
                plan.specs[name] = _fit_spec(own or (), tuple(p.shape),
                                             plan.axes)
                params[pname] = p if share else nn.Parameter(
                    p.detach().clone(), requires_grad=p.requires_grad)
                continue
            spec = (_fit_spec(own, tuple(p.shape), plan.axes)
                    if own is not None else plan.spec_for(name, p.shape))
            plan.specs[name] = spec
            zero = plan.zero_dims(spec)
            if zero:
                gathers[pname] = zero
            if not spec and share:
                params[pname] = p
                continue
            t = plan.local(p.detach(), spec, rank).clone() if spec \
                else p.detach().clone()
            params[pname] = nn.Parameter(t, requires_grad=p.requires_grad)
        d["_parameters"] = params
        bufs = dict(mod._buffers)
        if isinstance(mod, WeightOnlyLinear):
            qw = plan._shard_quantized(
                prefix + "weight",
                QuantizedWeight(mod.quant_weight, mod.weight_scale,
                                group_size=mod.group_size), rank)
            bufs["quant_weight"], bufs["weight_scale"] = qw.q, qw.scale
            full_shapes["weight"] = tuple(mod.quant_weight.shape)
        d["_buffers"] = bufs
        d["_modules"] = {n: None if c is None else view(c, f"{prefix}{n}.")
                         for n, c in mod._modules.items()}
        if gathers:
            new._zero_gather = gathers
        if isinstance(mod, _MPU_LAYERS):
            new._tp_wire = ("mpu",)
        elif isinstance(mod, MoELayer):
            new._tp_wire = ("moe",)
        elif isinstance(mod, Embedding):
            spec = plan.specs[prefix + "weight"]
            raw = plan.raw_spec_for(prefix + "weight")
            probe = spec if plan.tp_degree > 1 else raw
            probe = tuple(probe) + (None,) * (2 - len(probe))
            if plan.model_axis in plan._shape and \
                    plan.model_axis in _flat(probe[0]):
                new._tp_wire = ("vocab", mod.num_embeddings)
            elif plan.model_axis in plan._shape and \
                    plan.model_axis in _flat(probe[1]):
                new._tp_wire = ("gather",)
        elif "weight" in full_shapes and len(full_shapes["weight"]) == 2:
            role = plan.role_for(prefix + "weight", full_shapes["weight"],
                                 own=owns.get("weight"))
            if (role == "row" and isinstance(mod, WeightOnlyLinear)
                    and mod.group_size == -1):
                new._tp_wire = ("row_int8",)
            elif role is not None:
                new._tp_wire = (role, bool(_GATHER_OUTPUT.search(prefix)))
        return new

    return view(model, "")


def wire_view(view: nn.Module, pg, dp=None, ep=None, zero=None
              ) -> nn.Module:
    """The second half of :func:`parallel_view`: attach each marked
    module's collectives over ``pg`` (the rank's model-axis group), an MoE
    layer's over ``dp`` and ``ep`` (its data and expert-parallel groups)
    and each parameter-sharded module's gathers over ``zero`` (``{axis:
    (group, is a data axis)}``, :meth:`~..distributed.shard_plan.
    ShardingPlan.zero_groups`), in place; returns the view (its root
    swapped when the root itself is a vocab-sharded embedding)."""

    def wire(mod: nn.Module) -> nn.Module:
        for n, c in list(mod._modules.items()):
            if c is not None:
                mod._modules[n] = wire(c)
        gathers = mod.__dict__.pop("_zero_gather", None)
        out = _wire_role(mod, mod.__dict__.pop("_tp_wire", None), pg, dp, ep)
        _wire_sequence(out, pg)
        if gathers:
            _wire_gathers(out, gathers, zero)
        return out

    return wire(view)


def _wire_role(mod: nn.Module, role, pg, dp, ep) -> nn.Module:
    if role is None:
        return mod
    kind = role[0]
    if kind == "vocab":
        return VocabParallelEmbedding.from_local(
            mod.weight, role[1], pg, mod.padding_idx)
    if kind == "moe":
        mod.wire(dp, ep)
    elif kind == "mpu":
        # a Megatron layer makes its own collectives: over this rank's group
        mod.pg = pg
        if isinstance(mod, VocabParallelEmbedding):
            mod._start = _grank(pg) * mod.weight.shape[0]
    elif kind == "gather":
        mod.register_forward_hook(
            lambda m, args, out: c_concat(out, pg, -1))
    elif kind == "row_int8":
        mod.__class__ = _row_int8_class()
        mod._tp_pg = pg
    else:
        _hooks_for(mod, kind, role[1], pg,
                   seq=bool(getattr(mod, "_sp_seq", False)))
    return mod


# -- parameters sharded for memory (ZeRO-3): gathered where they are used ------

_scope = threading.local()


@contextlib.contextmanager
def gather_scope():
    """Inside the block (in this thread) a parameter sharded over a
    parameter-sharding axis reads whole: the first read gathers it
    (:class:`_GatherOnUse`) and later reads, a recomputed forward's in the
    backward included, get the same tensor. Outside it the parameter reads
    as this rank's shard, so looking at a view's ``device`` or ``dtype``
    runs no collective. A sharded train step runs its forward and
    backward inside one."""
    old = getattr(_scope, "cache", None)
    _scope.cache = {}
    try:
        yield
    finally:
        _scope.cache = old


class _GatherOnUse(torch.autograd.Function):
    """A parameter's shard gathered whole over its parameter-sharding axes
    (``dims``: ``((dim, ((group, is_data), ...)), ...)``, each dim's axes
    majorest first). The backward gives the shard its gradient: over a
    data axis the ranks' gradients are partial sums (each saw its own
    rows), so they are summed and scattered (a reduce-scatter); over an
    axis that is no data axis the ranks hold the same batch and compute
    the same gradient, so the rank takes its own slice (a reduce-scatter
    there would count it once a rank)."""

    @staticmethod
    def forward(ctx, shard, dims):
        ctx.dims = dims
        t = shard
        for dim, groups in dims:
            t = _all_gather(t, [g for g, _ in groups], dim)
        return t

    @staticmethod
    def backward(ctx, g):
        for dim, groups in ctx.dims:
            for pg, is_data in groups:
                if is_data:
                    g = _reduce_scatter(g.contiguous(), pg, dim)
                else:
                    g = g.chunk(_size(pg), dim=dim)[_grank(pg)]
        return g.contiguous(), None


def _read_gathered(mod: nn.Module, name: str):
    shard = mod._parameters[name]
    cache = getattr(_scope, "cache", None)
    if cache is None:
        return shard
    whole = cache.get(id(shard))
    if whole is None:
        whole = cache[id(shard)] = _GatherOnUse.apply(
            shard, mod._zero_dims[name])
    return whole


@functools.lru_cache(maxsize=None)
def _gathering_class(cls, names):
    """``cls`` with each parameter of ``names`` read through
    :func:`_read_gathered` (a property ahead of ``nn.Module``'s lookup;
    the shard stays in ``_parameters`` under its own name)."""
    def reader(name):
        return property(lambda self: _read_gathered(self, name))

    body = {n: reader(n) for n in names}
    body["__module__"] = cls.__module__
    return type(cls.__name__, (cls,), body)


def _wire_gathers(mod: nn.Module, gathers, zero) -> None:
    mod._zero_dims = {
        name: tuple((dim, tuple(zero[a] for a in axes))
                    for dim, axes in dims)
        for name, dims in gathers.items()}
    mod.__class__ = _gathering_class(type(mod), tuple(sorted(gathers)))


def _flat(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
