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
sequence-parallel half of the reference (:166-198) waits for an ``sp`` axis
(a later A10 slice).

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

from ..distributed.collective import (_all_gather, _all_reduce_, _grank,
                                      _reduce_scatter, _resolve_pg, _size,
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
# a model's view under a plan
# ---------------------------------------------------------------------------

# the column-parallel projection whose output is consumed whole: the LM
# head's vocab-sharded logits are gathered before sampling and the loss
_GATHER_OUTPUT = re.compile(r"(^|\.)lm_head\.$")


def _copy_hooks(d: dict) -> None:
    for k, v in list(d.items()):
        if k.endswith("hooks") or "_hooks_" in k:
            d[k] = type(v)(v)


def _hooks_for(new: nn.Module, role: str, gather: bool, pg) -> None:
    if role == "column":
        new.register_forward_pre_hook(
            lambda m, args: (c_identity(args[0], pg),) + tuple(args[1:]))
        if gather:
            new.register_forward_hook(
                lambda m, args, out: c_concat(out, pg, -1))
    elif role == "row":
        new.register_forward_hook(lambda m, args, out: mp_allreduce(out, pg))


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
        for pname, p in mod._parameters.items():
            if p is None:
                params[pname] = None
                continue
            name = prefix + pname
            full_shapes[pname] = tuple(p.shape)
            own = getattr(p, "dist_spec", None)
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
        if isinstance(mod, MoELayer):
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
            role = plan.role_for(prefix + "weight", full_shapes["weight"])
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
    elif kind == "gather":
        mod.register_forward_hook(
            lambda m, args, out: c_concat(out, pg, -1))
    elif kind == "row_int8":
        mod.__class__ = _row_int8_class()
        mod._tp_pg = pg
    else:
        _hooks_for(mod, kind, role[1], pg)
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
