"""``group_sharded_parallel``, the ZeRO stage 1/2/3 API (counterpart of
``paddlepaddle_tpu/distributed/sharding/__init__.py`` :30-71).

As in the reference, the levels need no machinery of their own here.
Stages 1 and 2 (optimizer state and gradients sharded) are how
:class:`~...parallel.sharded.ShardedTrainStep` already keeps its state: the
optimizer updates each rank's local shards. Stage 3 (``"p_g_os"``) shards
the parameters themselves: this marks each parameter's largest dim with the
``sharding_axis`` placement (``dist_spec``), and the step gathers such a
parameter where its module uses it (:func:`...parallel.mpu.gather_scope`),
its gradient reduce-scattered (over a data axis) or sliced (over an axis
the batch is not sharded over).

:func:`save_group_sharded_model` writes what the reference writes, the
model's whole ``state_dict`` (parameters gathered by the model's sharded
step, if it has one, and buffers) and the optimizer's whole ``state_dict``
(``LR_Scheduler`` included), with the port's own pickle of numpy arrays
(the reference writes them through ``paddle.save``; writing
:mod:`...framework`'s payloads here is left open in ROADMAP A10):
``model.pdmodel`` and ``model.pdopt``
under ``output``, each a pickled dict of numpy arrays (bf16 and fp16
stored as float32; the scheduler's state a dict of numbers); rank 0
writes.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch.utils import _pytree as pytree

_LEVELS = ("os", "os_g", "p_g_os")


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None, sharding_axis: str = "fsdp"):
    """Returns ``(model, optimizer, scaler)`` with the level recorded and,
    for ``"p_g_os"``, every parameter without a placement of its own (a
    tensor- or expert-parallel one wins) marked ``sharding_axis`` on its
    largest dim (a mesh whose axis does not divide it fits it away)."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    model._group_sharded_level = level
    model._group_sharded_axis = sharding_axis
    if level == "p_g_os":
        for _, p in model.named_parameters():
            if getattr(p, "dist_spec", None) is not None or not p.shape:
                continue
            dim = int(np.argmax(p.shape))
            spec = [None] * p.dim()
            spec[dim] = sharding_axis
            p.dist_spec = tuple(spec)
    if optimizer is not None:
        optimizer._group_sharded_level = level
    return model, optimizer, scaler


def _numpy(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return v.numpy()
    return v


def _host(v):
    """``v`` with every tensor as numpy, through dicts, lists and tuples."""
    return pytree.tree_map(_numpy, v)


def save_group_sharded_model(model, output: str, optimizer=None) -> None:
    """Write ``model``'s whole ``state_dict`` (parameters and buffers, as
    the reference's ``model.state_dict()``) to ``output/model.pdmodel``
    and, with ``optimizer``, its whole ``state_dict`` (slots, masters,
    ``LR_Scheduler``, ``@step``) to ``output/model.pdopt``. When a
    :class:`~...parallel.sharded.ShardedTrainStep` trains ``model`` the
    step's shards are gathered (every rank of an SPMD job calls this; rank
    0 writes) and the state is the step's, whole."""
    import torch.distributed as dist

    from ...parallel.sharded import step_of

    step = step_of(model)
    if step is not None:
        params = step.full_state_dict()
        state = step.full_optimizer_state() if optimizer is not None \
            else None
    else:
        params = model.state_dict()
        state = optimizer.state_dict() if optimizer is not None else None
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    with open(os.path.join(output, "model.pdmodel"), "wb") as f:
        pickle.dump(_host(dict(params)), f)
    if state is not None:
        with open(os.path.join(output, "model.pdopt"), "wb") as f:
            pickle.dump(_host(dict(state)), f)
