"""The reference-parity tail of the distributed namespace (counterpart of
``paddlepaddle_tpu/distributed/compat.py`` :1-346).

Small APIs reference scripts use, mapped onto the port's machinery: the
object and single-tensor collectives over the port's process groups (gloo
or NCCL, CPU or CUDA tensors; without a group they act as one process),
the environment view, the gloo shims over the host group, ``spawn`` (the
launcher's), and the parameter-server dataset classes, which raise as the
JAX package's do.
"""

from __future__ import annotations

import os
import pickle
from enum import IntEnum
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from . import collective as _c
from .env import get_rank, get_world_size
from .launch import spawn  # noqa: F401  (the launcher's, re-exported)


def _wire_device(pg) -> torch.device:
    """Where a helper tensor of a collective over ``pg`` lives: the card
    under NCCL, the host under gloo."""
    if pg is not None and not _c._gloo(pg):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _set(out: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``out`` takes ``value``'s shape and contents in place (the
    reference's ``set_value``)."""
    value = value.to(device=out.device, dtype=out.dtype)
    with torch.no_grad():
        if out.shape != value.shape:
            out.resize_(value.shape)
        out.copy_(value)
    return out


# -- aliases / simple variants ----------------------------------------------

def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Reference alias of all_to_all."""
    return _c.all_to_all(out_tensor_list, in_tensor_list, group=group,
                         sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Single-tensor all_to_all: rows split evenly (or by
    ``in_split_sizes``) across the ranks; rank ``r`` receives every rank's
    ``r``-th part, concatenated in rank order into ``out_tensor``
    (reference communication/all_to_all.py alltoall_single). Uneven parts
    travel padded to the largest and are cut back on arrival."""
    pg = _c._eager_pg(group)
    world = _c._size(pg)
    if world <= 1:
        return _set(out_tensor, in_tensor)
    n = in_tensor.shape[0]
    if in_split_sizes is None:
        if n % world:
            raise ValueError(
                f"alltoall_single: {n} rows not divisible by world size "
                f"{world}; pass in_split_sizes")
        in_split_sizes = [n // world] * world
    in_split_sizes = [int(s) for s in in_split_sizes]
    if sum(in_split_sizes) != n:
        raise ValueError(f"in_split_sizes {in_split_sizes} != {n} rows")
    # every rank's split sizes, so each knows what it receives
    sizes = torch.tensor(in_split_sizes, dtype=torch.int64,
                         device=_wire_device(pg))
    every = _c._all_gather(sizes.unsqueeze(0), pg, 0).cpu().tolist()
    me = _c._grank(pg)
    recv = [every[r][me] for r in range(world)]
    if out_split_sizes is not None and \
            [int(s) for s in out_split_sizes] != recv:
        raise ValueError(f"out_split_sizes {list(out_split_sizes)} != the "
                         f"sizes the ranks send: {recv}")
    width = max(max(row) for row in every)
    rest = tuple(in_tensor.shape[1:])
    padded = in_tensor.new_zeros((world, width) + rest)
    off = 0
    for r, sz in enumerate(in_split_sizes):
        padded[r, :sz] = in_tensor[off:off + sz]
        off += sz
    got = _c._all_to_all(padded, pg, 0, 0)
    return _set(out_tensor, torch.cat(
        [got[r, :recv[r]] for r in range(world)], dim=0))


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Collective gather to ``dst`` (reference communication/gather.py):
    an all_gather whose non-dst ranks discard."""
    outs: List = []
    _c.all_gather(outs, tensor, group=group)
    if get_rank() == dst and gather_list is not None:
        gather_list.clear()
        gather_list.extend(outs)
    return gather_list


def broadcast_object_list(object_list, src=0, group=None):
    """Reference communication/broadcast.py broadcast_object_list: rank
    ``src``'s list replaces every other rank's (pickled, then a length and
    a byte broadcast)."""
    pg = _c._eager_pg(group)
    if pg is None:
        return object_list
    dev = _wire_device(pg)
    payload = pickle.dumps(object_list) if get_rank() == src else b""
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    _c.broadcast(n, src=src, group=group)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if get_rank() == src:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    _c.broadcast(buf, src=src, group=group)
    if get_rank() != src:
        object_list[:] = pickle.loads(buf.cpu().numpy().tobytes())
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Reference communication/scatter.py scatter_object_list: ``src``
    sends one object per rank."""
    world = get_world_size()
    if world <= 1:
        out_object_list[:] = [in_object_list[0]] if in_object_list else []
        return out_object_list
    all_objs: List = [None]
    if get_rank() == src:
        all_objs = [list(in_object_list)]
    broadcast_object_list(all_objs, src=src, group=group)
    out_object_list[:] = [all_objs[0][get_rank()]]
    return out_object_list


def wait(tensor, group=None, use_calc_stream=True):
    """Reference communication/wait.py: block until the tensor's producing
    work is done (its card's stream drained)."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def is_available() -> bool:
    return dist.is_available()


def get_backend(group=None):
    """The live group's backend (``"nccl"`` / ``"gloo"``), None without a
    group (the JAX package answers ``"xla"``)."""
    pg = _c._eager_pg(group)
    return None if pg is None else pg.name()


def _drop_host_group():
    from . import host_collectives as hc

    hc._host_group = None
    hc._probed = False


def destroy_process_group(group=None):
    """Reference parallel.py destroy_process_group: drop the host group,
    and the process group, so a fresh init can rebuild them."""
    _drop_host_group()
    if dist.is_initialized():
        dist.destroy_process_group(None if group is None
                                   else _c._resolve_pg(group))


class ParallelMode(IntEnum):
    """Reference parallel.py ParallelMode."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class ParallelEnv:
    """Reference parallel.py ParallelEnv: the launcher-environment view."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", self.rank))

    @property
    def device_id(self) -> int:
        return self.local_rank

    nranks = world_size
    dev_id = device_id

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


# -- gloo shims (the host group over the store plays the gloo role) ---------

def gloo_init_parallel_env(rank_id=None, rank_num=None, server_endpoint=None):
    from .host_collectives import get_host_group

    if rank_id is not None:
        os.environ.setdefault("PADDLE_TRAINER_ID", str(rank_id))
    if rank_num is not None:
        os.environ.setdefault("PADDLE_TRAINERS_NUM", str(rank_num))
    get_host_group()


def gloo_barrier():
    from .host_collectives import get_host_group

    g = get_host_group()
    if g is not None:
        g.barrier()


def gloo_release():
    _drop_host_group()


# -- TP layer splitter (legacy static-graph API) -----------------------------

def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    raise NotImplementedError(
        "paddle.distributed.split is the legacy static-graph TP builder; "
        "use parallel.mpu.ColumnParallelLinear / RowParallelLinear / "
        "VocabParallelEmbedding (dist_spec sharding does the splitting)")


class DistAttr:
    """Legacy dist attr (reference auto_parallel/api.py DistAttr): carries
    (mesh, sharding_specs); shard_tensor consumes the placements form, so
    this is a thin record."""

    def __init__(self, mesh=None, sharding_specs=None):
        self.process_mesh = mesh
        self.sharding_specs = sharding_specs


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """Reference auto_parallel/api.py dtensor_from_fn: build locally, then
    shard onto the mesh."""
    from .sharding_api import shard_tensor

    return shard_tensor(fn(*args, **kwargs), mesh, placements)


# -- parameter-server dataset surface (out of scope, as in the JAX package) --

def _ps_stub(name):
    class _Stub:
        def __init__(self, *a, **k):
            raise NotImplementedError(
                f"{name} belongs to the parameter-server stack "
                "(paddle/fluid/distributed/ps/), documented out of scope "
                "in the JAX package and here (SURVEY.md §2.7 / PARITY.md)")

    _Stub.__name__ = name
    return _Stub


QueueDataset = _ps_stub("QueueDataset")
InMemoryDataset = _ps_stub("InMemoryDataset")
CountFilterEntry = _ps_stub("CountFilterEntry")
ShowClickEntry = _ps_stub("ShowClickEntry")
ProbabilityEntry = _ps_stub("ProbabilityEntry")


# -- auto-parallel API tail ---------------------------------------------------

class ReduceType:
    """Reference auto_parallel ReduceType (Partial placement reduce kinds)."""

    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


from .sharding_api import (  # noqa: F401,E402  (one hierarchy, re-exported)
    ShardingStage1,
    ShardingStage2,
    ShardingStage3,
)


class _StrategyBag:
    def __init__(self):
        self.enable = False


class Strategy:
    """Reference auto_parallel Strategy: config bag for to_static/engine
    flows (sharding/amp/recompute knobs)."""

    def __init__(self, config=None):
        self.sharding = _StrategyBag()
        self.amp = _StrategyBag()
        self.recompute = _StrategyBag()
        self.pipeline = _StrategyBag()
        self.gradient_merge = _StrategyBag()
        if config:
            for k, v in dict(config).items():
                setattr(self, k, v)


def shard_scaler(scaler):
    """Reference auto_parallel shard_scaler: the GradScaler's found-inf is
    already MAX-reduced over the host group, so this is the identity."""
    return scaler


def unshard_dtensor(dist_tensor):
    """Reference auto_parallel unshard_dtensor: a sharded tensor gathered
    to a replicated, plain local value."""
    t = dist_tensor
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    elif not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    return t.detach().clone()
