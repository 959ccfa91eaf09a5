"""Pipeline parallelism: the fleet ``PipelineLayer`` API and microbatch
accumulation (counterpart of ``paddlepaddle_tpu/parallel/pipeline.py``).

Reference surface: python/paddle/distributed/fleet/meta_parallel/
parallel_layers/pp_layers.py (LayerDesc:57, PipelineLayer:258 with segment
partitioning and shared embeddings) and pipeline_parallel.py
(forward_backward_pipeline:575 — 1F1B, interleave:1179, FthenB:2261).

Two layers, as in the JAX package:

* this module: the fleet-facing API (LayerDesc / PipelineLayer /
  segmenting) and a one-process ``train_batch`` whose RESULT equals every
  reference schedule (microbatched gradient accumulation); it makes no
  claim about bubble or peak memory;
* :mod:`.pipeline_spmd` + :mod:`.schedules`: the multi-rank path that does
  reproduce the schedule zoo's bubble and memory behaviour, each rank of a
  ``pp`` mesh axis walking its column of a static 1F1B / interleaved /
  FThenB / zero-bubble table, activations moving point to point.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn


class LayerDesc:
    """Deferred layer construction (reference pp_layers.py:57)."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("The input of LayerDesc must be Layer subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """Layer shared between stages, e.g. tied embeddings
    (reference pp_layers.py SharedLayerDesc)."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Partition N layer descs into num_parts stages (reference
    pp_layers.py SegmentLayers: 'uniform' or 'layer:<ClassName>' method)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.descs)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            cls_name = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.descs)
                     if getattr(getattr(d, "layer_func", None), "__name__",
                                "") == cls_name]
            if len(marks) < self.num_parts:
                raise ValueError(
                    f"only {len(marks)} '{cls_name}' layers for "
                    f"{self.num_parts} stages")
            per = len(marks) / self.num_parts
            bounds = [0]
            for p in range(1, self.num_parts):
                bounds.append(marks[math.floor(p * per)])
            bounds.append(n)
            return bounds
        raise ValueError(self.method)

    @staticmethod
    def uniform(num_items, num_parts):
        base, extra = divmod(num_items, num_parts)
        bounds = [0]
        for i in range(num_parts):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
        return bounds


class PipelineLayer(nn.Module):
    """Reference pp_layers.py:258. Owns ALL stages in one process;
    ``segment_parts`` says which stage each sublayer belongs to. ``topology``
    is anything with ``get_dim("pipe")``."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        self._layers_desc = list(layers)
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._loss_fn = loss_fn
        self._seg_method = seg_method
        self.segment_parts = SegmentLayers(
            self._layers_desc, self._num_stages, seg_method).do_segment()

        self.shared_layers = {}
        built = []
        for i, d in enumerate(self._layers_desc):
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self.shared_layers:
                    self.shared_layers[d.layer_name] = d.build_layer()
                layer = self.shared_layers[d.layer_name]
                built.append((layer, d.forward_func))
                self.add_module(str(i), layer)
            elif isinstance(d, LayerDesc):
                layer = d.build_layer()
                built.append((layer, None))
                self.add_module(str(i), layer)
            elif isinstance(d, nn.Module):
                built.append((d, None))
                self.add_module(str(i), d)
            elif callable(d):
                built.append((d, "func"))
            else:
                raise TypeError(f"unsupported desc {d!r}")
        self._built = built

    # -- reference accessors -------------------------------------------------
    def get_num_stages(self):
        return self._num_stages

    def stage_of_layer(self, idx: int) -> int:
        for s in range(self._num_stages):
            if self.segment_parts[s] <= idx < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def get_stage_layers(self, stage: int):
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return [self._built[i][0] for i in range(lo, hi)]

    def forward(self, x):
        for layer, fwd in self._built:
            if fwd is None or fwd == "func":
                x = layer(x)
            else:
                x = fwd(layer, x)
        return x


class PipelineParallel:
    """``train_batch`` with microbatch gradient accumulation: the result
    every reference schedule (FThenB / 1F1B / interleave / ZB) computes
    (pipeline_parallel.py:575,820)."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None,
                 accumulate_steps: Optional[int] = None):
        self._layers = layers
        self._loss_fn = layers._loss_fn
        if accumulate_steps is None:
            accumulate_steps = 1
            if strategy is not None:
                accumulate_steps = strategy.pipeline_configs.get(
                    "accumulate_steps", 1)
        self.accumulate_steps = max(1, int(accumulate_steps))

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        inputs, labels = data
        micro = self._split(inputs), self._split(labels)
        total = None
        for mb_in, mb_lb in zip(*micro):
            out = self._layers(mb_in)
            loss = self._loss_fn(out, mb_lb) / self.accumulate_steps
            if scaler is not None:
                scaler.scale(loss).backward()
            else:
                loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total

    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        with torch.no_grad():
            out = self._layers(inputs)
            return self._loss_fn(out, labels) if compute_loss else out

    def _split(self, x):
        if self.accumulate_steps == 1:
            return [x]
        n = x.shape[0] if isinstance(x, torch.Tensor) else len(x)
        if n % self.accumulate_steps:
            raise ValueError(
                f"batch size {n} must be divisible by accumulate_steps "
                f"{self.accumulate_steps} (reference asserts the same)")
        mb = n // self.accumulate_steps
        return [x[i * mb:(i + 1) * mb] for i in range(self.accumulate_steps)]
