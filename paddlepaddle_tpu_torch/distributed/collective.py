"""Collectives over ``torch.distributed`` (counterpart of
``paddlepaddle_tpu/distributed/collective.py`` :28-368).

Three forms, as in the reference:

* **functional** ``f_*`` (reference :77-112): differentiable collectives
  over a mesh AXIS NAME, resolved to this rank's group along that axis
  through the active plan's mesh (``with plan:``) or the global mesh
  (:func:`.mesh.set_mesh`). ``f_all_reduce`` and ``f_all_gather`` carry the
  reference's gradients, psum's transpose: the gradient of the sum over
  ranks of each rank's own objective (all-reduce backward for all-reduce,
  reduce-scatter for all-gather);
* **Megatron's f/g pair** over a group, for layers whose every rank holds
  the same loss (:mod:`..parallel.mpu`): ``c_identity`` (identity forward,
  all-reduce backward), ``mp_allreduce`` (all-reduce forward, identity
  backward), ``c_concat`` (all-gather forward, this rank's slice backward)
  and ``c_split`` (its conjugate);
* **eager** paddle-signature wrappers (``all_reduce`` ... ``recv``) over the
  world group or a :class:`Group`. Without an initialized process group they
  keep the reference's single-process semantics (a world of one).

Transport rules. Every dtype goes to the backend as it is: gloo reduces,
gathers and broadcasts bf16 / fp16 natively. A CUDA tensor under gloo
crosses the host; P2P stages through a CPU copy. Ranks, sizes, backends and
broadcast roots are asked of the group object itself, never of the default
group's registry, so the transport primitives also run over groups that a
single-process engine built from its own store (which nobody registered
with ``torch.distributed``). Eager calls pass the chaos
seam (``collective.launch``) and the flight recorder, as the reference's
``_collective_op`` does (:135-175). :func:`timing` turns on per-call device
timing (a sync before and after each collective; never inside a CUDA-graph
capture), read by :func:`collective_stats`.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..observability import flight as _flight
from ..resilience.chaos import chaos_point
from .comm_task import comm_task


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
             "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
             "prod": dist.ReduceOp.PRODUCT}


class Group:
    """A communication group: its global ranks, the mesh axis it spans (if
    any) and its ``torch.distributed`` process group (None without one)."""

    def __init__(self, ranks: Optional[List[int]] = None,
                 axis_name: Optional[str] = None, gid: int = 0, pg=None):
        self.ranks = ranks
        self.axis_name = axis_name
        self.id = gid
        self.pg = pg

    @property
    def nranks(self):
        return len(self.ranks) if self.ranks else 1

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if self.ranks and rank in self.ranks else -1


_groups: Dict[int, Group] = {}
_next_gid = 1


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A group over ``ranks`` (default: every rank). Collective, as
    ``torch.distributed.new_group`` is: every rank calls it in one order."""
    import datetime

    global _next_gid
    pg = None
    if dist.is_initialized():
        from .env import pg_timeout_s

        td = datetime.timedelta(seconds=float(timeout or pg_timeout_s()))
        pg = dist.new_group(ranks, timeout=td, backend=backend)
        if ranks is None:
            ranks = list(range(dist.get_world_size()))
    g = Group(ranks, axis_name, _next_gid, pg)
    _groups[_next_gid] = g
    _next_gid += 1
    return g


def get_group(gid=0):
    return _groups.get(gid, Group(gid=0))


# ---------------------------------------------------------------------------
# transport primitives (no autograd)
# ---------------------------------------------------------------------------

_stats: Dict[str, List[float]] = {}
_timing = False


@contextlib.contextmanager
def timing(on: bool = True):
    """Time every collective on the device inside the block: a device sync
    before and after each call (so a call's time is its own, not the work
    queued ahead of it). Never use it around a CUDA-graph capture."""
    global _timing
    old, _timing = _timing, bool(on)
    try:
        yield
    finally:
        _timing = old


def collective_stats() -> Dict[str, Dict[str, float]]:
    """``{op: {"calls", "seconds", "bytes"}}`` since the last reset;
    seconds only accrue under :func:`timing`."""
    return {k: {"calls": int(v[0]), "seconds": v[1], "bytes": int(v[2])}
            for k, v in _stats.items()}


def reset_collective_stats() -> None:
    _stats.clear()


def _account(op: str, t: torch.Tensor, fn):
    """Count ``op``'s call and bytes, and run ``fn`` as a comm task (a
    watchdog timeout names a collective that never returns); timed when
    :func:`timing` is on."""
    rec = _stats.setdefault(op, [0, 0.0, 0])
    rec[0] += 1
    rec[2] += t.numel() * t.element_size()
    with comm_task(op, group="collective"):
        if not _timing:
            return fn()
        cuda = t.is_cuda
        if cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(t.device)
        rec[1] += time.perf_counter() - t0
        return out


def _resolve_pg(group):
    """``None`` -> the world group; a :class:`Group` -> its process group;
    a ``torch.distributed`` group passes through."""
    if group is None:
        return dist.group.WORLD
    return getattr(group, "pg", group)


def _size(pg) -> int:
    return pg.size() if pg is not None else 1


def _grank(pg) -> int:
    """This process's rank in ``pg`` (0 without one). The group object's
    own answer: ``torch.distributed.get_rank(pg)`` looks the group up in
    the default group's registry, which holds no group an engine built
    from its own store."""
    return pg.rank() if pg is not None else 0


def _gloo(pg) -> bool:
    return pg.name() == "gloo"


def _all_reduce_(t: torch.Tensor, op: str, pg) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``pg`` (identity without one)."""
    if pg is None:
        return t

    def run():
        dist.all_reduce(t, _TORCH_OP[op], group=pg)
        if op == "avg":
            t.div_(_size(pg))
        return t

    return _account("all_reduce", t, run)


def _all_gather(t: torch.Tensor, pg, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order. A
    sequence of groups (the axes of a tuple, majorest first) gathers over
    each in turn, the minorest first: the blocks of ``dim`` run row-major
    over the tuple."""
    if isinstance(pg, (list, tuple)):
        for g in reversed(pg):
            t = _all_gather(t, g, dim)
        return t
    if pg is None:
        return t
    t = t.contiguous()

    def run():
        parts = [torch.empty_like(t) for _ in range(_size(pg))]
        dist.all_gather(parts, t, group=pg)
        return torch.cat(parts, dim=dim)

    return _account("all_gather", t, run)


def _reduce_scatter(t: torch.Tensor, pg, dim: int = 0) -> torch.Tensor:
    """Sum over the group, then this rank's ``1/n`` slice along ``dim``. A
    sequence of groups (majorest first) reduce-scatters over each in turn,
    the majorest first: the conjugate of :func:`_all_gather`'s order."""
    if isinstance(pg, (list, tuple)):
        for g in pg:
            t = _reduce_scatter(t, g, dim)
        return t
    if pg is None:
        return t
    n = _size(pg)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {t.shape[dim]} "
                         f"does not split over {n} ranks")
    me = _grank(pg)

    def run():
        if not _gloo(pg):
            src = t.movedim(dim, 0).contiguous()
            out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                              dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, src, group=pg)
            return out.movedim(0, dim)
        full = t.clone()
        dist.all_reduce(full, dist.ReduceOp.SUM, group=pg)
        return full.chunk(n, dim=dim)[me].contiguous()

    return _account("reduce_scatter", t, run)


def _broadcast_(t: torch.Tensor, root: int, pg) -> torch.Tensor:
    """In place, from group rank ``root``."""
    if pg is None:
        return t

    def run():
        opts = dist.BroadcastOptions()
        opts.rootRank = root
        pg.broadcast([t], opts).wait()
        return t

    return _account("broadcast", t, run)


def _all_to_all(t: torch.Tensor, pg, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """Chunk ``split_axis`` over the ranks, send chunk ``j`` to rank ``j``,
    concatenate what arrives along ``concat_axis``."""
    if pg is None:
        return t
    n, me = _size(pg), _grank(pg)
    if _gloo(pg):
        # gloo: every rank gathers every rank's chunks and keeps its own
        everyone = _all_gather(t.unsqueeze(0), pg, dim=0)
        mine = [everyone[r].chunk(n, dim=split_axis)[me] for r in range(n)]
        return torch.cat(mine, dim=concat_axis)
    ins = [c.contiguous() for c in t.chunk(n, dim=split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    _account("all_to_all", t, lambda: dist.all_to_all(outs, ins, group=pg))
    return torch.cat(outs, dim=concat_axis)


# ---------------------------------------------------------------------------
# mesh-axis resolution for f_*
# ---------------------------------------------------------------------------

_mesh_stack: List[object] = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the one ``f_*`` axis names resolve against (what
    ``with plan:`` does)."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def _axis_pg(axis: str):
    """This rank's process group along mesh axis ``axis`` (None for an axis
    of size 1 in a process without a group)."""
    from .mesh import get_mesh

    mesh = _mesh_stack[-1] if _mesh_stack else get_mesh()
    axis_group = getattr(mesh, "axis_group", None)
    if axis_group is not None:
        return axis_group(axis)       # a plan's own groups (ShardingPlan)
    if mesh is None:
        raise ValueError(
            f"collective over axis {axis!r}: no mesh is active (enter a "
            "ShardingPlan with `with plan:` or call distributed.set_mesh)")
    if axis not in mesh.dim_names:
        raise ValueError(f"axis {axis!r} is not in {mesh!r}")
    if not dist.is_initialized():
        if mesh.get_dim_size(axis) == 1:
            return None
        from ..core.errors import not_ported

        raise not_ported(
            f"a collective over a {mesh.get_dim_size(axis)}-rank axis in a "
            "process with no initialized group (the single-process form); "
            "launch one process per rank with python -m "
            "paddlepaddle_tpu_torch.distributed.launch", "A10")
    return mesh.group(axis)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    """Sum forward; its transpose (the sum over ranks of the gradients)
    backward."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _all_reduce_(x.clone(), "sum", pg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), "sum", ctx.pg), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return _all_gather(x, pg, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.pg, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return _reduce_scatter(x, pg, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.pg, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, split_axis, concat_axis):
        ctx.pg, ctx.split, ctx.concat = pg, split_axis, concat_axis
        return _all_to_all(x, pg, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.pg, ctx.concat, ctx.split),
                None, None, None)


class _CIdentity(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), "sum", ctx.pg), None


class _MPAllReduce(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce_(x.clone(), "sum", pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CConcat(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return _all_gather(x, pg, dim)

    @staticmethod
    def backward(ctx, g):
        pg = ctx.pg
        if pg is None:
            return g, None, None
        part = g.chunk(_size(pg), dim=ctx.dim)[_grank(pg)]
        return part.contiguous(), None, None


class _CSplit(torch.autograd.Function):
    """This rank's slice along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        if pg is None:
            return x
        return x.chunk(_size(pg), dim=dim)[_grank(pg)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.pg, ctx.dim), None, None


def c_identity(x, group=None):
    return _CIdentity.apply(x, _resolve_pg(group))


def mp_allreduce(x, group=None):
    return _MPAllReduce.apply(x, _resolve_pg(group))


def c_concat(x, group=None, dim: int = -1):
    return _CConcat.apply(x, _resolve_pg(group), dim % x.dim())


def c_split(x, group=None, dim: int = -1):
    return _CSplit.apply(x, _resolve_pg(group), dim % x.dim())


def c_allgather(x, group=None, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim``; backward, the gradient
    summed over the ranks and this rank's slice taken (a reduce-scatter):
    for a tensor every rank goes on to use whole, where :func:`c_concat`'s
    backward (the slice alone) serves a tensor each rank uses only its own
    part of."""
    return _AllGather.apply(x, _resolve_pg(group), dim % x.dim())


# ---------------------------------------------------------------------------
# functional collectives over mesh axes (reference :77-112)
# ---------------------------------------------------------------------------


def f_all_reduce(x, axis: str, op: str = "sum"):
    pg = _axis_pg(axis)
    if op in ("sum", "avg"):
        out = _AllReduce.apply(x, pg)
        if op == "avg":
            out = out / _size(pg)
        return out
    if op in ("max", "min"):
        return _all_reduce_(x.detach().clone(), op, pg)
    raise ValueError(op)


def f_all_gather(x, axis: str, concat_axis: int = 0, tiled: bool = True):
    pg = _axis_pg(axis)
    if not tiled:
        x = x.unsqueeze(concat_axis)
    return _AllGather.apply(x, pg, concat_axis % x.dim())


def f_reduce_scatter(x, axis: str, scatter_axis: int = 0):
    return _ReduceScatter.apply(x, _axis_pg(axis), scatter_axis % x.dim())


def f_all_to_all(x, axis: str, split_axis: int = 0, concat_axis: int = 0):
    return _AllToAll.apply(x, _axis_pg(axis), split_axis % x.dim(),
                           concat_axis % x.dim())


def f_ppermute(x, axis: str, perm):
    """Rank ``dst`` of the axis receives rank ``src``'s ``x`` for every
    ``(src, dst)`` in ``perm``; a rank no pair sends to gets zeros."""
    pg = _axis_pg(axis)
    if pg is None:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    me = _grank(pg)
    src = [s for s, d in perm if d == me]
    everyone = _AllGather.apply(x.unsqueeze(0), pg, 0)
    return everyone[src[0]] if src else torch.zeros_like(x)


def f_broadcast(x, axis: str, root: int = 0):
    keep = 1.0 if f_axis_index(axis) == root else 0.0
    return f_all_reduce(x * keep, axis)


def f_axis_index(axis: str) -> int:
    pg = _axis_pg(axis)
    return _grank(pg)


# ---------------------------------------------------------------------------
# eager paddle-signature wrappers
# ---------------------------------------------------------------------------

# observability hook: _obs_coll(op_name, nbytes, dur_s) per eager
# collective call; None when observability is off
_obs_coll = None


def _nbytes(obj) -> int:
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return 0


def _collective_op(bytes_arg=None):
    """Wrap an eager collective: the chaos seam, a flight-recorder event,
    and with observability on the payload bytes and wall time."""

    def deco(fn):
        name = fn.__name__
        payload_kw = (list(inspect.signature(fn).parameters)[bytes_arg]
                      if bytes_arg is not None else None)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            chaos_point("collective.launch")
            _flight.record("collective", name)
            obs = _obs_coll
            if obs is None:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if bytes_arg is None:
                    nb = 0
                elif len(args) > bytes_arg:
                    nb = _nbytes(args[bytes_arg])
                else:
                    nb = _nbytes(kwargs.get(payload_kw))
                obs(name, nb, time.perf_counter() - t0)

        return wrapper

    return deco


def _eager_pg(group):
    """The process group of an eager call, or None in a process without
    one (single-process semantics)."""
    return _resolve_pg(group) if dist.is_initialized() else None


class _Task:
    """The reference's task handle: ``wait()`` blocks until the op's
    effects are visible, ``is_completed()``."""

    def __init__(self, work=None, then=None):
        self._work, self._then = work, then
        self._done = work is None and then is None

    def wait(self):
        if not self._done:
            if self._work is not None:
                self._work.wait()
            if self._then is not None:
                self._then()
            self._done = True
        return True

    def is_completed(self):
        return self._done


@_collective_op(bytes_arg=0)
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    _all_reduce_(tensor, op, _eager_pg(group))
    return tensor if sync_op else _Task()


@_collective_op(bytes_arg=1)
def all_gather(tensor_list, tensor, group=None, sync_op=True):
    pg = _eager_pg(group)
    if pg is None:
        tensor_list.append(tensor)
        return tensor_list
    tensor_list.extend(_all_gather(tensor.unsqueeze(0), pg, 0).unbind(0))
    return tensor_list


@_collective_op()
def all_gather_object(object_list, obj, group=None):
    pg = _eager_pg(group)
    if pg is None:
        object_list.append(obj)
        return object_list
    out = [None] * _size(pg)
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)
    return object_list


@_collective_op(bytes_arg=0)
def broadcast(tensor, src=0, group=None, sync_op=True):
    """From global rank ``src``, in place."""
    pg = _eager_pg(group)
    if pg is not None:
        _broadcast_(tensor, dist.get_group_rank(pg, src), pg)
    return tensor if sync_op else _Task()


@_collective_op(bytes_arg=0)
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on ``dst``; like the reference, every rank ends
    with it."""
    _all_reduce_(tensor, op, _eager_pg(group))
    return tensor if sync_op else _Task()


@_collective_op(bytes_arg=1)
def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    pg = _eager_pg(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    if op != ReduceOp.SUM:
        full = torch.stack(list(tensor_list))
        _all_reduce_(full, op, pg)
        tensor.copy_(full[_grank(pg)])
        return tensor
    tensor.copy_(_reduce_scatter(torch.cat(list(tensor_list)), pg, 0)
                 .reshape(tensor.shape))
    return tensor


@_collective_op(bytes_arg=1)
def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    pg = _eager_pg(group)
    if pg is None:
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    stacked = torch.stack(list(in_tensor_list))
    out = _all_to_all(stacked, pg, 0, 0)
    out_tensor_list.extend(out.unbind(0))
    return out_tensor_list


@_collective_op(bytes_arg=0)
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``src``'s ``tensor_list[r]`` lands in rank ``r``'s ``tensor``."""
    pg = _eager_pg(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    gsrc = dist.get_group_rank(pg, src)
    if _grank(pg) == gsrc:
        full = torch.stack(list(tensor_list))
    else:
        full = torch.empty((_size(pg),) + tuple(tensor.shape),
                           dtype=tensor.dtype, device=tensor.device)
    _broadcast_(full, gsrc, pg)
    tensor.copy_(full[_grank(pg)])
    return tensor


def _send_to(tensor: torch.Tensor, peer: int, pg, tag: int = 0) -> _Task:
    """A waitable send of ``tensor`` to GROUP rank ``peer`` of ``pg``,
    asked of the group object itself (so it runs over groups nobody
    registered with ``torch.distributed`` too); gloo sends a CUDA tensor
    from a CPU copy. The task holds the buffer until ``wait()``: leave
    ``tensor`` unchanged until then."""
    buf = _staged(tensor, pg).contiguous()

    def run():
        # the closure keeps the buffer alive until the task's wait()
        return _Task(pg.send([buf], peer, tag), then=lambda: buf)

    return _account("p2p_send", buf, run)


def _recv_from(tensor: torch.Tensor, peer: int, pg, tag: int = 0) -> _Task:
    """A task whose ``wait()`` completes the receive from GROUP rank
    ``peer`` of ``pg`` into ``tensor`` (the counterpart of
    :func:`_send_to`)."""
    buf = _staged(tensor, pg)

    def run():
        work = pg.recv([buf], peer, tag)
        if buf is tensor:
            return _Task(work)
        return _Task(work, then=lambda: tensor.copy_(buf))

    return _account("p2p_recv", buf, run)


def _p2p_pg(group):
    pg = _eager_pg(group)
    if pg is None:
        raise NotImplementedError(
            "point-to-point send/recv needs a multi-process job (start it "
            "with python -m paddlepaddle_tpu_torch.distributed.launch)")
    return pg


def _staged(tensor, pg) -> torch.Tensor:
    """gloo moves CPU tensors only point to point: a CPU copy."""
    if _gloo(pg) and tensor.is_cuda:
        return tensor.detach().cpu()
    return tensor


@_collective_op(bytes_arg=0)
def send(tensor, dst=0, group=None, sync_op=True):
    pg = _p2p_pg(group)
    dist.send(_staged(tensor, pg).contiguous(), dst, group=pg)
    return tensor


@_collective_op(bytes_arg=0)
def recv(tensor, src=0, group=None, sync_op=True):
    pg = _p2p_pg(group)
    buf = _staged(tensor, pg)
    dist.recv(buf, src, group=pg)
    if buf is not tensor:
        tensor.copy_(buf)
    return tensor


def isend(tensor, dst=0, group=None):
    """A waitable task for a send to global rank ``dst``."""
    pg = _p2p_pg(group)
    chaos_point("collective.launch")
    _flight.record("collective", "isend")
    buf = _staged(tensor, pg).contiguous()
    return _Task(dist.isend(buf, dst, group=pg))


def irecv(tensor, src=0, group=None):
    """A task whose ``wait()`` completes the receive into ``tensor``."""
    pg = _p2p_pg(group)
    chaos_point("collective.launch")
    _flight.record("collective", "irecv")
    buf = _staged(tensor, pg)
    work = dist.irecv(buf, src, group=pg)
    if buf is tensor:
        return _Task(work)
    return _Task(work, then=lambda: tensor.copy_(buf))


@_collective_op()
def barrier(group=None):
    pg = _eager_pg(group)
    if pg is not None:
        with comm_task("barrier",
                       group=getattr(group, "name", None) or "world"):
            dist.barrier(group=pg)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
