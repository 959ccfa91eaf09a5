"""The semi-automatic parallel API (counterpart of
``paddlepaddle_tpu/distributed/auto_parallel/__init__.py`` :34-258): the
per-layer plans and ``parallelize``, ``DistModel`` / ``to_static`` and
``shard_dataloader``, with :mod:`..sharding_api`'s dist tensors.

* ``parallelize`` applies plans (``ColWiseParallel``, ``RowWiseParallel``,
  ...) by attaching ``dist_spec`` placements to parameters, as the
  reference does; a sharded train step reads them ahead of its rules.
* ``DistModel`` (``to_static``) trains through the port's
  :class:`~...parallel.sharded.ShardedTrainStep` over its mesh, data axes
  ``("dp", "fsdp")``: in a process with no group it is the step's
  single-process form (this process rank 0, the step starting the other
  ranks), under the launcher its SPMD form. ``eval()`` and ``predict()``
  gather the trained parameters into the model and run it here.
* ``shard_dataloader`` yields each batch whole: the port's sharded step
  takes the global batch on every rank and keeps its own rows
  (``ShardingPlan.shard_batch``), where the reference yields arrays placed
  over the data axes; the values are the same.
* ``SequenceParallelBegin`` / ``End`` mark where the activations become
  sequence blocks over the model axis and where they are gathered again.
  The reference registers ``scatter_to_sequence_parallel`` on the Begin
  layer's output and ``gather_from_sequence_parallel`` on the End layer's
  inputs, and GSPMD computes the dense values. Here a plan's view attaches
  the same two collectives over its model-axis group (after the layer's
  tensor-parallel hooks), and ``parallelize`` marks the modules between
  them (:func:`~...parallel.mpu.mark_sequence_parallel_region`): the
  column- and row-parallel projections there gather the sequence before
  and reduce-scatter it after, and every other parameter there (the
  norms) is a sequence-parallel parameter whose gradient
  ``ShardedTrainStep`` sums over the model axis. In a process with no
  group the marks change nothing. The reference's ``completion``
  (``complete_program`` over a static ``Program``) waits for A11's static
  graph.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from ..mesh import ProcessMesh, get_mesh
from ..placement import Partial, Placement, Replicate, Shard  # noqa: F401
from ..sharding_api import (dist_attr, reshard, shard_layer,  # noqa: F401
                            shard_optimizer, shard_tensor)


# -- parallelize plans (reference :34-102) ------------------------------------


class _Plan:
    def apply(self, layer, mp_axis: str) -> None:
        raise NotImplementedError


class ColWiseParallel(_Plan):
    """Shard the layer weight's OUTPUT dim over mp (Linear ``[in, out]``
    -> ``(None, mp)``; Embedding ``[vocab, h]`` -> ``(None, mp)``)."""

    def __init__(self, gather_output: bool = False):
        self.gather_output = gather_output

    def apply(self, layer, mp_axis):
        w = getattr(layer, "weight", None)
        if w is not None:
            w.dist_spec = (None, mp_axis)
        b = getattr(layer, "bias", None)
        if b is not None:
            b.dist_spec = (mp_axis,)


class RowWiseParallel(_Plan):
    """Shard the layer weight's INPUT dim over mp (Linear -> ``(mp,
    None)``; Embedding ``[vocab, h]`` -> ``(mp, None)``)."""

    def apply(self, layer, mp_axis):
        w = getattr(layer, "weight", None)
        if w is not None:
            w.dist_spec = (mp_axis, None)


class PrepareLayerInput(_Plan):
    def __init__(self, fn=None):
        self.fn = fn

    def apply(self, layer, mp_axis):
        if self.fn is not None:
            layer.register_forward_pre_hook(lambda m, inp: self.fn(inp))


class PrepareLayerOutput(_Plan):
    def __init__(self, fn=None):
        self.fn = fn

    def apply(self, layer, mp_axis):
        if self.fn is not None:
            layer.register_forward_hook(lambda m, inp, out: self.fn(out))


class SequenceParallelBegin(_Plan):
    """The layer's output is scattered into sequence blocks over the model
    axis (module docstring)."""

    def apply(self, layer, mp_axis):
        layer._sp_begin = mp_axis


class SequenceParallelEnd(_Plan):
    """The layer's inputs are gathered from sequence blocks (module
    docstring)."""

    def apply(self, layer, mp_axis):
        layer._sp_end = mp_axis


def parallelize(model, optimizer=None, mesh: Optional[ProcessMesh] = None,
                config: Optional[Dict] = None):
    """Apply per-layer plans to an undistributed model (reference :105):
    ``config = {"mp_config": {"parallelize_plan": {"name regex": plan},
    "mp_axis": "mp"}}``; a pattern that matches no sublayer raises."""
    config = config or {}
    mp_cfg = config.get("mp_config") or {}
    plan_table = mp_cfg.get("parallelize_plan", {})
    mp_axis = mp_cfg.get("mp_axis", "mp")
    named = dict(model.named_modules())
    for pattern, plan in plan_table.items():
        plans = plan if isinstance(plan, (list, tuple)) else [plan]
        matched = False
        for name, sub in named.items():
            if re.fullmatch(pattern, name) or name == pattern \
                    or name.endswith("." + pattern):
                for p in plans:
                    p.apply(sub, mp_axis)
                matched = True
        if not matched:
            raise ValueError(f"parallelize plan pattern {pattern!r} "
                             "matched no sublayer")
    from ...parallel.mpu import mark_sequence_parallel_region

    mark_sequence_parallel_region(model)
    if optimizer is not None:
        return model, optimizer
    return model


# -- to_static / DistModel (reference :137-226) -------------------------------


class _InputsThenLabel:
    """``loss(net(*inputs), label)`` over a batch ``(*inputs, label)``: the
    train step's loss function (sent by value to the worker ranks)."""

    def __init__(self, loss):
        self.loss = loss

    def __call__(self, net, *batch):
        *inputs, label = batch
        return self.loss(net(*inputs), label)


class DistModel:
    """A distributed model: ``__call__`` runs one step. With a loss and an
    optimizer it starts in ``train()`` mode (a sharded train step, the
    loss back); ``eval()`` runs forward and loss without an update,
    ``predict()`` forward alone, both on the trained parameters."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, metrics=None,
                 mesh: Optional[ProcessMesh] = None, rules=None,
                 data_axes=("dp", "fsdp")):
        self.network = layer
        self._loss = loss
        self._optimizer = optimizer
        self._mode = "train" if (loss is not None
                                 and optimizer is not None) else "predict"
        pm = mesh or get_mesh()
        if pm is None:
            raise ValueError("to_static needs a mesh: dist.set_mesh(...) or "
                             "fleet.init first")
        self._mesh = pm
        self._rules = rules if rules is not None else [(r".*", ())]
        self._data_axes = data_axes
        self._step = None
        if self._mode == "train":
            self._step = self._build_step()

    def _build_step(self):
        from ...parallel import ShardedTrainStep

        return ShardedTrainStep(self.network, self._optimizer,
                                _InputsThenLabel(self._loss),
                                mesh=self._mesh, rules=self._rules,
                                data_axes=self._data_axes)

    def train(self):
        self._mode = "train"

    def eval(self):
        if self._loss is None:
            raise ValueError("DistModel.eval() requires a loss; this model "
                             "was built for predict only (construct with "
                             "loss=...)")
        self._mode = "eval"

    def predict(self):
        self._mode = "predict"

    def __call__(self, *batch):
        if self._mode == "train":
            return self._step(*batch)
        if self._step is not None:
            self._step.sync_to_model()
        batch = tuple(torch.from_numpy(np.asarray(b))
                      if not isinstance(b, torch.Tensor) else b
                      for b in batch)
        with torch.no_grad():
            if self._mode == "eval":
                *inputs, label = batch
                return self._loss(self.network(*inputs), label)
            return self.network(*batch)

    def state_dict(self, mode="all"):
        if self._step is not None:
            self._step.sync_to_model()
        return self.network.state_dict()

    def set_state_dict(self, state_dict):
        self.network.load_state_dict(
            {k: torch.as_tensor(np.asarray(v)) for k, v in
             state_dict.items()}, strict=False)
        if self._step is not None:
            # the placed parameters rebuilt from the updated weights, with
            # the rules and data axes this model was built with
            self._step.close()
            self._step = self._build_step()

    def close(self):
        """End the train step's worker ranks (single-process form)."""
        if self._step is not None:
            self._step.close()


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              mesh=None, rules=None) -> DistModel:
    return DistModel(layer, loader, loss, optimizer, strategy, mesh=mesh,
                     rules=rules)


# -- shard_dataloader ----------------------------------------------------------


class _ShardedLoader:
    def __init__(self, loader, mesh: ProcessMesh, shard_dims="dp"):
        self._loader = loader
        self._mesh = mesh
        self._dims = shard_dims

    def __iter__(self):
        def whole(x):
            if isinstance(x, torch.Tensor) or np.ndim(x) == 0:
                return x
            return torch.from_numpy(np.ascontiguousarray(x))

        for batch in self._loader:
            yield ([whole(b) for b in batch]
                   if isinstance(batch, (list, tuple)) else whole(batch))

    def __len__(self):
        return len(self._loader)


def shard_dataloader(dataloader, meshes, shard_dims="dp",
                     is_dataset_splitted=False):
    mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
    return _ShardedLoader(dataloader, mesh, shard_dims)
