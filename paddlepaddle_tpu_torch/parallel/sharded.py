"""The sharded training step (counterpart of
``paddlepaddle_tpu/parallel/sharded.py`` :29-216): ``_fit_spec``,
``match_sharding_rules``, ``param_shardings`` and ``ShardedTrainStep``.

The reference compiles one ``jax.jit`` over the mesh and lets XLA insert
the collectives. Here every rank runs the port's eager step on its LOCAL
shards (``plan.shard_module``: column- and row-parallel projections over
the ``mp`` group, :mod:`.mpu`) and makes the data-parallel collectives
itself:

* each rank is given the same global batch, as the reference's one call
  is, and takes its ``dp`` rows (:meth:`ShardingPlan.shard_batch`);
* the loss is the GLOBAL token mean: inside the step the Llama loss
  (``models.llama.loss_from_logits``) divides its local sum of token
  losses by the count of valid tokens all-reduced over ``dp``, so label
  masking that leaves the ranks different counts still gives the
  one-device mean; the reported loss is the all-reduced sum of the ranks'
  parts. Under ``dp > 1`` a loss function that never reaches that loss
  (so never reports its count) raises: averaging per-rank means is wrong
  whenever masking leaves the ranks different counts;
* gradients are summed over ``dp`` (each rank's loss already carries the
  global denominator), so replicated parameters (the norms, and the
  embedding under the decode rules) get the one-device gradient;
* a global-norm clip sums the squared norms of the ``mp``-sharded
  gradients over ``mp`` and counts replicated ones once; a per-tensor norm
  clip takes a sharded tensor's norm over its shards;
* the optimizer (``AdamW`` with ``apply_decay_param_fun`` honoured, by the
  parameters' own names) updates the local shards;
* :meth:`ShardedTrainStep.sync_to_model` gathers the full parameters back
  into the model.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.errors import not_ported
from ..distributed.collective import _all_gather, _all_reduce_
from ..optimizer.optimizer import Optimizer  # noqa: F401  (reference path)


def _axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, dict):
        return mesh
    if hasattr(mesh, "axes"):
        return dict(mesh.axes)
    return dict(zip(mesh.dim_names, mesh.shape))


def _fit_spec(spec: Sequence, shape, mesh) -> tuple:
    """Drop axes the mesh lacks or that do not divide the dim evenly (the
    reference's dims_mapping rule), so one rule table serves any mesh and
    model size; trailing Nones are stripped."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, ax in enumerate(spec):
        if i >= len(shape):
            break
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, (tuple, list)) else (ax,)
        axes = tuple(a for a in axes if a in sizes)
        size = 1
        for a in axes:
            size *= sizes[a]
        if axes and size > 1 and shape[i] % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def match_sharding_rules(name: str, shape, rules, mesh) -> tuple:
    for pattern, spec in rules:
        if re.match(pattern, name):
            return _fit_spec(spec, shape, mesh)
    return ()


def param_shardings(params: Dict[str, torch.Tensor], rules, mesh,
                    handles: Optional[dict] = None) -> Dict[str, tuple]:
    """Per-parameter fitted spec: an explicit ``dist_spec`` (set by the mpu
    layers) wins over the rule table."""
    out = {}
    for n, p in params.items():
        h = handles.get(n) if handles else None
        if h is not None and getattr(h, "dist_spec", None) is not None:
            out[n] = _fit_spec(h.dist_spec, tuple(p.shape), mesh)
        else:
            out[n] = match_sharding_rules(n, tuple(p.shape), rules, mesh)
    return out


class _TokenMean:
    """Reduces a loss's valid-token count over the dp group (no
    gradient), and records that it did."""

    def __init__(self, pg):
        self.pg = pg
        self.used = False

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        self.used = True
        return _all_reduce_(count.detach().clone(), "sum", self.pg)


def _sharded_on(spec, axis: str) -> bool:
    for e in spec:
        axes = e if isinstance(e, (tuple, list)) else (e,)
        if axis in axes:
            return True
    return False


class _PlanClip:
    """The optimizer's clip over local shards: global and per-tensor norms
    taken over the whole parameters."""

    def __init__(self, clip, sharded, pg):
        from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue)

        self.clip, self.sharded, self.pg = clip, sharded, pg
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)):
            raise not_ported(f"{type(clip).__name__} under a tensor-parallel "
                             "plan", "A10")
        self.kind = type(clip).__name__

    @torch.no_grad()
    def clip_grads(self, grads):
        if self.kind == "ClipGradByValue":
            return self.clip.clip_grads(grads)
        present = [(g, s) for g, s in zip(grads, self.sharded)
                   if g is not None]
        if not present:
            return list(grads)
        cn = float(self.clip.clip_norm)
        if self.kind == "ClipGradByGlobalNorm":
            dev = present[0][0].device
            sh = torch.zeros((), dtype=torch.float32, device=dev)
            rep = torch.zeros((), dtype=torch.float32, device=dev)
            for g, s in present:
                sq = g.float().square().sum()
                if s:
                    sh = sh + sq
                else:
                    rep = rep + sq
            norm = (_all_reduce_(sh, "sum", self.pg) + rep).sqrt()
            scale = torch.clamp(cn / torch.clamp(norm, min=1e-12), max=1.0)
            for g, _ in present:
                g.mul_(scale)
            return list(grads)
        for g, s in present:
            sq = g.float().square().sum()
            if s:
                sq = _all_reduce_(sq, "sum", self.pg)
            g.mul_(torch.clamp(cn / torch.clamp(sq.sqrt(), min=1e-12),
                               max=1.0))
        return list(grads)


class ShardedTrainStep:
    """``step(*batch) -> loss`` on this rank's shards (reference :87).

    Args:
        model / optimizer / loss_fn: as :class:`~..jit.train.TrainStep`;
            the optimizer is rebound to the step's local parameters.
        mesh / rules / data_axes: the plan's pieces, or ``plan=`` (a
            :class:`~..distributed.shard_plan.ShardingPlan`) for all three.
        seq_axis: a sequence-parallel axis of size > 1 is a later A10
            slice (raises).
        donate: accepted and recorded (an eager step donates nothing).
    """

    def __init__(self, model, optimizer, loss_fn: Callable,
                 mesh=None, rules=None, data_axes=("dp", "fsdp"),
                 seq_axis: Optional[str] = None, donate: bool = True,
                 plan=None):
        from ..distributed.shard_plan import ShardingPlan

        if plan is None:
            if mesh is None or rules is None:
                raise ValueError("ShardedTrainStep needs mesh+rules or plan=")
            plan = ShardingPlan(mesh, rules=rules, data_axes=data_axes)
        elif rules is not None or mesh is not None:
            plan = ShardingPlan(mesh if mesh is not None
                                else plan.process_mesh,
                                rules=rules if rules is not None
                                else plan.rules,
                                data_axes=plan.data_axes or data_axes,
                                model_axis=plan.model_axis)
        if seq_axis is not None and plan.axes.get(seq_axis, 1) > 1:
            raise not_ported(f"seq_axis={seq_axis!r}",
                             "A10 slice 5: sequence parallel")
        if len(plan.data_axes) > 1:
            raise not_ported(f"data axes {plan.data_axes}",
                             "A10 slice 3: the fsdp axis")
        plan.require_group()
        self.plan = plan
        self.model = model
        self.loss_fn = loss_fn
        self.donate = bool(donate)
        self.rules = plan.rules
        self.net = plan.shard_module(model, share=False)
        self.params: Dict[str, torch.nn.Parameter] = dict(
            self.net.named_parameters())
        self.specs = {n: plan.specs.get(n, ()) for n in self.params}
        self._mp = plan.mp_group
        self._dp = plan.dp_group
        self._dp_size = plan.dp_degree
        sharded = [_sharded_on(self.specs[n], plan.model_axis)
                   for n in self.params]
        optimizer._rebind(self.params)
        if optimizer._grad_clip is not None and plan.tp_degree > 1:
            optimizer._grad_clip = _PlanClip(optimizer._grad_clip, sharded,
                                             self._mp)
        optimizer.init_state()
        self.optimizer = optimizer
        self.device = next(iter(self.params.values())).device
        self._step_count = 0

    def _local_batch(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device)
        if self._dp_size > 1:
            if x.shape[0] % self._dp_size:
                raise ValueError(
                    f"batch dimension {x.shape[0]} does not split over "
                    f"dp={self._dp_size}")
            x = self.plan.shard_batch(x)
        return x

    def __call__(self, *batch) -> torch.Tensor:
        from ..models import llama as _llama

        batch = tuple(self._local_batch(b) for b in batch)
        lr = self.optimizer.get_lr()
        params = self.optimizer.parameters
        for p in params:
            p.grad = None
        mean = _TokenMean(self._dp)
        with self.plan, _llama.global_token_mean(
                mean if self._dp_size > 1 else None):
            loss = self.loss_fn(self.net, *batch)
        if self._dp_size > 1 and not mean.used:
            # every rank ran the same loss_fn, so every rank raises here
            raise not_ported(
                "a loss_fn under dp > 1 that does not report its valid-token "
                "count (the global token mean needs it; the Llama, GPT and "
                "MoE losses, LlamaForCausalLM.loss_from_logits, report it)",
                "A10")
        loss.backward()
        loss = loss.detach().float()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self._dp_size > 1:
            # each rank's part carries the global denominator: sum them
            for g in grads:
                _all_reduce_(g, "sum", self._dp)
            loss = _all_reduce_(loss.clone(), "sum", self._dp)
        self.optimizer.apply(grads, lr=lr)
        self._step_count += 1
        return loss

    @torch.no_grad()
    def full_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole: each sharded one gathered along its
        sharded dims over the matching mesh axis."""
        out = {}
        for name, p in self.params.items():
            t = p.detach()
            for dim, entry in enumerate(self.specs[name]):
                if entry is None:
                    continue
                if isinstance(entry, (tuple, list)):
                    raise not_ported("a dim sharded over two axes",
                                     "A10 slice 3: the fsdp axis")
                t = _all_gather(t, self.plan.group(entry), dim)
            out[name] = t
        return out

    @torch.no_grad()
    def sync_to_model(self):
        """Copy the trained parameters, gathered whole, into the model."""
        own = dict(self.model.named_parameters())
        for name, t in self.full_params().items():
            if name in own:
                own[name].copy_(t)
