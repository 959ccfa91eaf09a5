"""``shard_tensor`` / ``reshard`` / ``shard_layer`` / ``shard_optimizer``,
the auto-parallel API (counterpart of
``paddlepaddle_tpu/distributed/sharding_api.py`` :24-136).

The reference's "DistTensor" is an array whose value is GLOBAL, placed on
a device mesh by a (mesh, placements) pair. PyTorch's own
``torch.distributed.tensor.DTensor`` is the same idea over ranks: here a
dist tensor is a DTensor over :meth:`~.mesh.ProcessMesh.device_mesh`, and
the port's placements map one to one (``Shard(d)``, ``Replicate()``,
``Partial(reduce_type)``). ``shard_tensor`` cuts this rank's block of the
global value with no communication (every rank passes the same value, as
the reference's one process does); ``reshard`` is ``redistribute``, which
runs the collectives and carries gradients (a CUDA tensor under gloo,
ranks sharing a card, is redistributed through a host copy).

Deviations (ROADMAP, recorded deviations):
* a mesh of more than one rank needs a process group (the launcher, or
  ``spawn``), as ``plan.shard`` does; without one it raises with the launch
  command. A one-rank mesh in a process without a group gives the tensor
  itself (its local value is its global value);
* the argument tensor is not rebound in place (reference :53-57): use the
  returned tensor (``layer.weight = shard_tensor(layer.weight, ...)``);
  :func:`shard_layer`'s default does so for every parameter;
* a ``Partial`` placement of ``shard_tensor`` keeps the global value: a
  ``"sum"`` rank block holds it at coordinate 0 of that mesh axis and
  zeros elsewhere (``"prod"``: ones), ``"avg"`` / ``"max"`` / ``"min"``
  everywhere, so reading it back, or resharding it to ``Replicate``, gives
  the value that was passed, as the reference (which ignores a Partial
  placement there) does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import ProcessMesh
from .placement import Partial, Placement, Replicate, Shard

_EMPTY = {"sum": 0.0, "prod": 1.0}


def placements_to_spec(mesh: ProcessMesh, placements: Sequence[Placement],
                       ndim: int) -> tuple:
    """dims_mapping: for each tensor dim, the mesh axis (or tuple of axes,
    majorest first) it is sharded over, or None. A ``Partial`` axis does
    not appear (reference :24)."""
    entries = [None] * ndim
    for axis_idx, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.get_dim()
            name = mesh.dim_names[axis_idx]
            if entries[d] is None:
                entries[d] = name
            elif isinstance(entries[d], tuple):
                entries[d] = entries[d] + (name,)
            else:
                entries[d] = (entries[d], name)
    return tuple(entries)


def _device_mesh(mesh: ProcessMesh, t: torch.Tensor):
    """The DeviceMesh of ``mesh`` on ``t``'s device type, or None for a
    one-rank mesh in a process without a group."""
    if not dist.is_initialized():
        if len(mesh.process_ids) == 1:
            return None
        from .shard_plan import LAUNCH_HINT

        raise RuntimeError(f"a dist tensor over {mesh!r} needs a process "
                           f"group of its ranks: {LAUNCH_HINT}")
    return mesh.device_mesh("cuda" if t.is_cuda else "cpu")


def _torch_placements(placements, ndim_mesh: int) -> list:
    from torch.distributed import tensor as dt

    out = []
    for p in list(placements) + [Replicate()] * (ndim_mesh
                                                  - len(placements)):
        if isinstance(p, Shard):
            out.append(dt.Shard(p.get_dim()))
        elif isinstance(p, Partial):
            out.append(dt.Partial(p.reduce_type))
        else:
            out.append(dt.Replicate())
    return out


def _mark(t: torch.Tensor, mesh: ProcessMesh, placements) -> torch.Tensor:
    t._dist_attr = (mesh, list(placements))
    return t


def shard_tensor(data, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, place=None, stop_gradient=None):
    """A dist tensor over ``mesh`` whose global value is ``data`` (a tensor
    or an array, the same on every rank), placed by ``placements`` (one per
    mesh axis; missing ones replicate). Differentiable as a leaf:
    ``stop_gradient`` (default: ``data``'s own) decides
    ``requires_grad``."""
    from ..core.dtype import to_torch_dtype

    t = data if isinstance(data, torch.Tensor) else torch.as_tensor(
        np.asarray(data))
    if dtype is not None:
        t = t.to(to_torch_dtype(dtype))
    t = t.detach()
    grad = (not stop_gradient) if stop_gradient is not None \
        else data.requires_grad if isinstance(data, torch.Tensor) else False
    dm = _device_mesh(mesh, t)
    if dm is None:
        out = t.clone()
    else:
        from torch.distributed.tensor import DTensor

        coords = mesh.coords(dist.get_rank())
        local = t
        for axis, p in enumerate(placements):
            c, n = coords[mesh.dim_names[axis]], mesh.shape[axis]
            if isinstance(p, Shard):
                d = p.get_dim()
                if local.shape[d] % n:
                    raise ValueError(
                        f"dim {d} of size {t.shape[d]} does not split over "
                        f"mesh axis {mesh.dim_names[axis]!r} of {n}")
                local = local.chunk(n, dim=d)[c]
            elif isinstance(p, Partial) and c and \
                    p.reduce_type in _EMPTY:
                local = torch.full_like(local, _EMPTY[p.reduce_type])
        out = DTensor.from_local(local.contiguous(), dm,
                                 _torch_placements(placements, mesh.ndim),
                                 run_check=False, shape=t.shape,
                                 stride=t.stride())
    if grad and out.is_floating_point():
        out.requires_grad_(True)
    return _mark(out, mesh, placements)


def dist_attr(t):
    """``(mesh, placements)`` of a tensor made by :func:`shard_tensor` or
    :func:`reshard`, else None."""
    return getattr(t, "_dist_attr", None)


def reshard(x, mesh: ProcessMesh, placements: Sequence[Placement]):
    """``x`` with new placements (DTensor's ``redistribute``: the
    collectives run here, and the gradient flows back through them). A
    plain tensor is taken as a global value (:func:`shard_tensor`)."""
    if any(isinstance(p, Partial) for p in placements):
        raise NotImplementedError(
            "resharding TO a Partial placement is not meaningful at the API "
            "level; Partial arises inside computations and is reduced on "
            "read")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return shard_tensor(x, mesh, placements,
                            stop_gradient=not x.requires_grad)
    to = _torch_placements(placements, mesh.ndim)
    if not (x.is_cuda and dist.get_backend() == "gloo"):
        return _mark(x.redistribute(_device_mesh(mesh, x), to), mesh,
                     placements)
    # gloo moves host tensors: the collectives run on a host copy (as the
    # port's point-to-point calls stage theirs), every step differentiable
    host = mesh.device_mesh("cpu")
    moved = DTensor.from_local(
        x.to_local().cpu(), host, x.placements, run_check=False,
        shape=x.shape, stride=x.stride()).redistribute(host, to)
    out = DTensor.from_local(moved.to_local().to(x.device),
                             mesh.device_mesh("cuda"), to, run_check=False,
                             shape=x.shape, stride=x.stride())
    return _mark(out, mesh, placements)


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Call ``shard_fn(name, sublayer, mesh)`` on every sublayer (reference
    :733), the layer itself first; the default replaces each parameter by a
    replicated dist tensor. ``input_fn(inputs, mesh)`` and
    ``output_fn(outputs, mesh)`` become forward hooks."""

    def default_shard_fn(name, sublayer, mesh):
        for pname, p in sublayer._parameters.items():
            if p is not None:
                d = shard_tensor(p, mesh, [Replicate() for _ in mesh.shape])
                sublayer._parameters[pname] = _mark(
                    torch.nn.Parameter(d, requires_grad=p.requires_grad),
                    mesh, dist_attr(d)[1])

    fn = shard_fn or default_shard_fn
    for name, sub in layer.named_modules():
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda m, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda m, inp, out: output_fn(out, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """Record ``shard_fn`` on the optimizer (stage 1/2 semantics, reference
    :1648): a sharded train step keeps the optimizer's state on each
    rank's local shards already."""
    optimizer._shard_fn = shard_fn
    return optimizer


class ShardingStage1:
    """Placement rule: optimizer states sharded over the data axis."""

    def __init__(self, axis="dp"):
        self.axis = axis


class ShardingStage2(ShardingStage1):
    pass


class ShardingStage3(ShardingStage1):
    """Parameters sharded too, gathered where they are used (FSDP)."""
