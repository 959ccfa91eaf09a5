"""The sharded training step (counterpart of
``paddlepaddle_tpu/parallel/sharded.py`` :29-216): ``_fit_spec``,
``match_sharding_rules``, ``param_shardings`` and ``ShardedTrainStep``.

The reference compiles one ``jax.jit`` over the mesh and lets XLA insert
the collectives. Here every rank runs the port's eager step on its LOCAL
shards (``plan.shard_module``: column- and row-parallel projections over
the model axis, :mod:`.mpu`; parameters sharded over a parameter-sharding
axis such as ``fsdp`` gathered where they are used, :func:`.mpu.
gather_scope`; an MoE layer's experts over ``ep`` and its routing over the
global batch, :mod:`.moe`) and makes the data-parallel collectives itself:

* each rank is given the same global batch, as the reference's one call
  is, and takes its rows over the data axes
  (:meth:`ShardingPlan.shard_batch`);
* the loss is the GLOBAL token mean: inside the step the Llama loss
  (``models.llama.loss_from_logits``) divides its local sum of token
  losses by the count of valid tokens all-reduced over the data group, so
  label masking that leaves the ranks different counts still gives the
  one-device mean; the reported loss is the all-reduced sum of the ranks'
  parts. With more than one data rank a loss function that never reaches
  that loss (so never reports its count) raises: averaging per-rank means
  is wrong whenever masking leaves the ranks different counts;
* gradients are summed over the data group (each rank's loss already
  carries the global denominator), so replicated parameters (the norms,
  and the embedding under the decode rules) get the one-device gradient.
  A parameter gathered over a data axis had its gradient reduce-scattered
  over that axis by the gather's backward, and is summed over the other
  data axes only; over an axis that is no data axis the gather's backward
  took the rank's slice. The ranks of one ``ep`` group compute the same
  loss, and their expert gradients are their own experts' whole ones;
* with ``seq_axis`` (context parallelism) each rank also takes its block
  of the columns of every batch array with more than one dim (the
  reference's ``_batch_sharding``, :171-175); the model's attention runs
  ring attention over that axis (``LlamaConfig.context_parallel_axis``,
  :mod:`..ops.kernels.ring_attention`), the loss takes the next block's
  first label for its last position and counts validity at global
  positions (``models.llama.sequence_sharded``), the token count and the
  loss are summed over the data group and the sequence group, and every
  gradient is summed over the sequence group (each rank's is a partial
  sum over its tokens). The reference's GSPMD computes any model globally
  under ``seq_axis``; a model with no context-parallel path over it
  (``config.context_parallel_axis != seq_axis``) would give a per-block
  answer here, so it gets its whole sequence on every rank instead (the
  ranks of the axis compute the same step, and nothing is summed over
  it);
* a global-norm clip sums the squared norms of the gradients sharded over
  axes (``mp``, ``ep``, ``fsdp``) over those axes and counts replicated
  ones once; a per-tensor norm clip takes a sharded tensor's norm over its
  shards;
* the optimizer (``AdamW`` with ``apply_decay_param_fun`` honoured, by the
  parameters' own names) updates the local shards, so its state lives on
  them (ZeRO-1/2/3 all follow, as the reference's
  ``_opt_state_shardings``, :152-169, says);
* :meth:`ShardedTrainStep.full_params` and
  :meth:`ShardedTrainStep.sync_to_model` gather the full parameters back;
  :meth:`ShardedTrainStep.full_state_dict` adds the buffers, and
  :meth:`ShardedTrainStep.full_optimizer_state` is the optimizer's whole
  state with its scheduler's;
* ``step.params``, ``step.opt_state`` and ``step.state_dict()`` are this
  rank's local tensors by name (the optimizer's under the reference's
  flat ``{param}_{slot}`` / ``{param}_master`` / ``@step`` names), and
  :mod:`..distributed.checkpoint` saves and loads them through the step:
  every rank writes and reads the boxes of its own blocks (from the
  plan's spec and its coordinate), so a checkpoint is never gathered
  whole and loads under any other mesh (reshard-on-load).

Two forms, by what the process has. Under the launcher (a default group
spanning the mesh) every rank builds the step (SPMD). In a process with no
group (the reference's one-controller form) the caller is rank 0: the
step cuts every rank's view (:meth:`ShardingPlan.cut_module`), starts ranks
1..n-1 as worker processes on groups it builds itself
(:mod:`..distributed.worker_ranks`) and hands each its view, the optimizer's
class and settings (:meth:`Optimizer._worker_copy`) and the loss function
(shipped by value, :mod:`..distributed.ship`: a lambda works; one that
cannot be sent raises at construction). Every step, :meth:`full_params`
and :meth:`sync_to_model` is then a led step: rank 0 sends the global
batch and its learning rate (a scheduler stepped on rank 0 holds on every
rank), and every rank runs the same per-rank body. :meth:`close`, garbage
collection and rank 0's exit end the workers; a worker's death fails rank
0's next step, naming the rank.
"""

from __future__ import annotations

import functools
import logging
import re
import weakref
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.errors import not_ported
from ..distributed.collective import _all_gather, _all_reduce_
from . import mpu
from ..distributed.worker_ranks import STOP, Control
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


_log = logging.getLogger(__name__)

# each model's sharded step (for ``save_group_sharded_model``)
_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def step_of(model) -> Optional["ShardedTrainStep"]:
    """The live :class:`ShardedTrainStep` last built over ``model`` on this
    rank, or None."""
    ref = _STEPS.get(model)
    return ref() if ref is not None else None


class _TokenMean:
    """Reduces a loss's valid-token count over the data group and the
    sequence group (no gradient), and records that it did."""

    def __init__(self, groups):
        self.groups = [g for g in groups if g is not None]
        self.used = False

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        self.used = True
        count = count.detach().clone()
        for pg in self.groups:
            _all_reduce_(count, "sum", pg)
        return count


def _axes_of_spec(spec) -> tuple:
    """The mesh axes a fitted spec shards over."""
    out = []
    for e in spec:
        out.extend(e if isinstance(e, (tuple, list)) else
                   (() if e is None else (e,)))
    return tuple(out)


class _PlanClip:
    """The optimizer's clip over local shards: global and per-tensor norms
    taken over the whole parameters. ``axes[i]`` is the tuple of mesh axes
    the i-th gradient is sharded over (empty: replicated); ``groups`` maps
    each axis to this rank's group along it."""

    def __init__(self, clip, axes, groups):
        from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue)

        self.clip, self.axes, self.groups = clip, list(axes), dict(groups)
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)):
            raise not_ported(f"{type(clip).__name__} under a sharding plan",
                             "A10")
        self.kind = type(clip).__name__

    def _over(self, sq, axes):
        """``sq`` summed over the shards: over each axis in turn."""
        for a in axes:
            sq = _all_reduce_(sq, "sum", self.groups[a])
        return sq

    @torch.no_grad()
    def clip_grads(self, grads):
        if self.kind == "ClipGradByValue":
            return self.clip.clip_grads(grads)
        present = [(g, a) for g, a in zip(grads, self.axes)
                   if g is not None]
        if not present:
            return list(grads)
        cn = float(self.clip.clip_norm)
        if self.kind == "ClipGradByGlobalNorm":
            dev = present[0][0].device
            by_axes: Dict[tuple, torch.Tensor] = {}
            for g, a in present:
                by_axes[a] = by_axes.get(a, torch.zeros(
                    (), dtype=torch.float32, device=dev)) \
                    + g.float().square().sum()
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for a, v in by_axes.items():
                total = self._over(v, a) + total
            norm = total.sqrt()
            scale = torch.clamp(cn / torch.clamp(norm, min=1e-12), max=1.0)
            for g, _ in present:
                g.mul_(scale)
            return list(grads)
        for g, a in present:
            sq = self._over(g.float().square().sum(), a)
            g.mul_(torch.clamp(cn / torch.clamp(sq.sqrt(), min=1e-12),
                               max=1.0))
        return list(grads)


def _led(fn):
    """A step every rank runs: on rank 0 of a single-process step it is
    sent to the workers before it runs here (not when one led step calls
    another); a worker runs it only from :meth:`ShardedTrainStep.follow`.
    A worker found dead, or a collective that fails because one died,
    raises naming the rank."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        ctl = self._ctl
        if ctl is None or ctl.depth:
            return fn(self, *args, **kwargs)
        if not ctl.driver:
            raise RuntimeError(f"{name}: this rank follows rank 0; rank 0 "
                               "drives the step")
        if ctl.stopped:
            raise RuntimeError(f"{name}: the step was closed; build a new "
                               "one")
        with ctl.lock:
            ranks = self._ranks
            ranks.check()                    # a dead worker fails at once
            try:
                ctl.send(name, _to_host(args), kwargs)
            except Exception as e:
                ctl.failed = e
                ranks.raise_lost(e)
            ctl.depth += 1
            try:
                return fn(self, *args, **kwargs)
            except Exception as e:
                if not all(p.is_alive() for p in ranks.procs):
                    ctl.failed = e
                    ranks.raise_lost(e)
                raise
            finally:
                ctl.depth -= 1

    return wrapper


def _to_host(args):
    """A led step's arguments as the workers get them: each tensor a CPU
    copy (pickled in any dtype, bf16 too); rank 0 keeps its own."""
    return tuple(_to_host(a) if isinstance(a, tuple)
                 else a.detach().cpu() if isinstance(a, torch.Tensor) else a
                 for a in args)


class _RefusedOnEveryRank(NotImplementedError):
    """A refusal that every rank raises from the same check at the same
    point of a led step, before any collective that could part them: a
    worker's :meth:`ShardedTrainStep.follow` logs it and follows on."""


def _own(net: torch.nn.Module, device: torch.device) -> None:
    """Give every parameter and buffer of ``net`` a copy on ``device`` of
    its own (a worker's view arrives mapped from rank 0's memory), a
    tensor shared by two modules staying shared."""
    done: Dict[int, torch.Tensor] = {}
    for mod in net.modules():
        for table in (mod._parameters, mod._buffers):
            for k, t in table.items():
                if t is None:
                    continue
                if id(t) not in done:
                    c = t.detach().to(device, copy=True)
                    done[id(t)] = (torch.nn.Parameter(
                        c, requires_grad=t.requires_grad)
                        if isinstance(t, torch.nn.Parameter) else c)
                table[k] = done[id(t)]


def resident_bytes(params, optimizer) -> int:
    """Bytes a rank holds of ``params`` (its parameters or their shards)
    and of ``optimizer``'s state over them (slots and f32 masters): what
    parameter sharding (ZeRO-3) divides."""
    n = sum(p.numel() * p.element_size() for p in params)
    for slots in optimizer._slots.values():
        n += sum(t.numel() * t.element_size() for t in slots.values())
    for m in optimizer._masters.values():
        if m is not None:
            n += m.numel() * m.element_size()
    return int(n)


def host_rss_gb() -> Dict[str, float]:
    """This process's host RSS now (``VmRSS``) and at its peak, GB. The
    peak is ``VmHWM`` where the kernel reports it, else ``ru_maxrss``,
    which a process started by another carries over from it: then it is
    at least the starter's RSS when it started this one."""
    import resource

    kb = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                name, _, rest = line.partition(":")
                if name in ("VmRSS", "VmHWM"):
                    kb[name] = int(rest.split()[0])
    except OSError:
        pass
    peak = kb.get("VmHWM") or resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    return {"now": kb.get("VmRSS", 0) / 1e6, "peak": peak / 1e6}


def _own_stats(device: torch.device, reset: bool) -> Dict[str, object]:
    """This process's kernel launch counts (the MoE and flash wrappers),
    ``nvcc`` runs, collective counts, peak device memory, and its host RSS
    now and at its peak (:func:`host_rss_gb`)."""
    import os

    from ..distributed.collective import (collective_stats,
                                          reset_collective_stats)
    from ..ops.kernels import _build
    from ..ops.kernels import flash_attention as fa
    from ..ops.kernels import gather_gemm as gg

    wrappers = {"gather_gemm_ffn": gg.gather_gemm_ffn,
                "gather_gateup": gg.gather_gateup,
                "expert_down": gg.expert_down, "flash_fwd": fa.flash_fwd,
                "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv}
    cuda = device.type == "cuda"
    out = {"pid": os.getpid(), "nvcc": _build.nvcc_runs,
           "host_rss_gb": host_rss_gb(),
           "launches": {k: w.launches for k, w in wrappers.items()},
           "collectives": collective_stats(),
           "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                       if cuda else None)}
    if reset:
        for w in wrappers.values():
            w.launches = 0
        reset_collective_stats()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
    return out


def _sequence_parallel_names(model) -> tuple:
    """The parameters marked ``mark_as_sequence_parallel_parameter``."""
    if model is None:
        return ()
    return tuple(n for n, p in model.named_parameters()
                 if getattr(p, "sequence_parallel", False))


def _build_worker_step(held, plan, device, optimizer, loss_fn, donate,
                       seq_axis, sp_params):
    """Rank r's step over its view (``held["net"]``, copied here) under
    the bound ``plan``: what :func:`~..distributed.worker_ranks.
    start_workers` runs on each worker rank."""
    net = held.pop("net")
    _own(net, device)
    step = ShardedTrainStep.__new__(ShardedTrainStep)
    step._init(plan, None, loss_fn, donate, seq_axis, sp_params)
    step._bind(plan.wire_module(net), optimizer)
    step._ctl = Control(plan)
    return step


class _StepState(dict):
    """A flat state of a :class:`ShardedTrainStep`: this rank's local
    tensors by name. :func:`~..distributed.checkpoint.save_state_dict` and
    ``load_state_dict`` hand it to the step (``sharded_step``), which has
    every rank of its plan write or read its own blocks."""

    def __init__(self, step: "ShardedTrainStep", kind: str, items=()):
        super().__init__(items)
        self._step = weakref.ref(step)
        self.kind = kind

    @property
    def sharded_step(self) -> Optional["ShardedTrainStep"]:
        return self._step()


def _digest(t: torch.Tensor) -> tuple:
    """Two position-weighted sums of ``t``'s raw words (int64, wrapping):
    equal for equal bits, and moved by any change of one word."""
    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[t.element_size()]
    flat = t.detach().contiguous().reshape(-1).view(words)
    plain = weighted = 0
    step = 1 << 24
    for lo in range(0, flat.numel(), step):
        w = flat[lo:lo + step].to(torch.int64)
        pos = torch.arange(lo, lo + w.numel(), device=w.device,
                           dtype=torch.int64) % 1000003 + 1
        plain += int(w.sum())
        weighted += int((w * pos).sum())
    return plain, weighted


class ShardedTrainStep:
    """``step(*batch) -> loss`` on this rank's shards (reference :87).

    Args:
        model / optimizer / loss_fn: as :class:`~..jit.train.TrainStep`;
            the optimizer is rebound to the step's local parameters.
        mesh / rules / data_axes: the plan's pieces, or ``plan=`` (a
            :class:`~..distributed.shard_plan.ShardingPlan`) for all three.
        seq_axis: the mesh axis the batch's sequence dim shards over
            (context parallelism, reference :97-98, :171-175), when the
            model has a context-parallel path over it
            (``config.context_parallel_axis == seq_axis``, read here); a
            model without one gets its whole sequence on every rank
            (module docstring).
        donate: accepted and recorded (an eager step donates nothing).

    In a process with no process group a plan of several ranks runs in the
    single-process form (module docstring): call :meth:`close` (or let the
    step be collected) to end its worker ranks.
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
        cfg = getattr(model, "config", None)
        if (seq_axis is None or plan.axes.get(seq_axis, 1) == 1
                or getattr(cfg, "context_parallel_axis", None) != seq_axis):
            seq_axis = None
        self._init(plan, model, loss_fn, donate, seq_axis,
                   _sequence_parallel_names(model))
        if model is not None:
            _STEPS[model] = weakref.ref(self)
        if plan.single_process:
            self._start(model, optimizer, loss_fn)
        else:
            plan.require_group()
            self._bind(plan.shard_module(model, share=False), optimizer)

    def _init(self, plan, model, loss_fn, donate, seq_axis=None,
              sp_params=()) -> None:
        self.plan = plan
        self.model = model
        self.loss_fn = loss_fn
        self.donate = bool(donate)
        self.seq_axis = seq_axis
        self._sp_params = frozenset(sp_params)
        self.rules = plan.rules
        self._ctl: Optional[Control] = None
        self._ranks = None
        self._finalizer = None
        self._step_count = 0

    def _bind(self, net, optimizer) -> None:
        """This rank's view ``net`` and the optimizer over its shards."""
        plan = self.plan
        self.net = net
        self.params: Dict[str, torch.nn.Parameter] = _StepState(
            self, "params", net.named_parameters())
        self.specs = {n: plan.specs.get(n, ()) for n in self.params}
        self._data = plan.data_group
        self._dp_size = plan.dp_degree
        self._sp = plan.group(self.seq_axis) if self.seq_axis else None
        self._sp_size = plan.axes[self.seq_axis] if self.seq_axis else 1
        axes, self._reduce = [], []
        for n in self.params:
            on = tuple(a for a in _axes_of_spec(self.specs[n])
                       if plan.axes.get(a, 1) > 1)
            axes.append(on)
            # the data axes the gather's backward has not summed over
            rest = tuple(a for a in plan.data_axes
                         if not (a in on and plan.is_zero_axis(a)))
            # every parameter is replicated over the sequence axis, whose
            # ranks saw other tokens: their partial gradients are summed; a
            # sequence-parallel parameter (Megatron SP) saw this rank's
            # sequence block of the model axis: summed over that axis
            self._reduce.append(
                ([self._data] if rest == plan.data_axes and rest
                 else [plan.group(a) for a in rest])
                + ([self._sp] if self._sp is not None else [])
                + ([plan.mp_group] if n in self._sp_params
                   and plan.tp_degree > 1 else []))
        optimizer._rebind(self.params)
        if optimizer._grad_clip is not None and any(axes):
            optimizer._grad_clip = _PlanClip(
                optimizer._grad_clip, axes,
                {a: plan.group(a) for on in axes for a in on})
        optimizer.init_state()
        self.optimizer = optimizer
        self.device = next(iter(self.params.values())).device

    def _start(self, model, optimizer, loss_fn) -> None:
        """Rank 0 of the single-process form: cut every rank's view, start
        the workers on them, bind this rank's own."""
        from ..distributed.ship import ship
        from ..distributed.worker_ranks import release, start_workers

        plan = self.plan
        kw = {"optimizer": optimizer._worker_copy(),
              "loss_fn": ship(loss_fn, "loss_fn"), "donate": self.donate,
              "seq_axis": self.seq_axis, "sp_params": self._sp_params}
        cuts = [plan.cut_module(model, r, share=False)
                for r in range(plan.n_devices)]
        held = [{"net": c} for c in cuts[1:]]
        del cuts[1:]
        device = next(model.parameters()).device
        bound, ranks = start_workers(plan, held, _build_worker_step, kw,
                                     device, what="train-step worker",
                                     owned=True)
        self.plan = bound
        self._ranks = ranks
        # collected without close(): the workers go with the step
        self._finalizer = weakref.finalize(self, release, ranks)
        self._bind(bound.wire_module(cuts[0]), optimizer)
        self._ctl = Control(bound)

    @property
    def workers(self):
        """The worker ranks this step started (None in the SPMD form)."""
        return self._ranks

    def _local_batch(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device)
        if self._dp_size > 1:
            x = self.plan.shard_batch(x)
        if self._sp is not None and x.dim() > 1:
            x = x.chunk(self._sp_size, dim=1)[self.plan.coords()[
                self.seq_axis]].contiguous()
        return x

    def _check_batch(self, batch) -> None:
        for x in batch:
            if self._dp_size > 1 and x.shape[0] % self._dp_size:
                raise ValueError(
                    f"batch dimension {x.shape[0]} does not split over "
                    f"dp={self._dp_size}")
            if self._sp is not None and x.ndim > 1 \
                    and x.shape[1] % self._sp_size:
                # what the reference's ring attention raises
                raise ValueError(f"seq {x.shape[1]} not divisible by "
                                 f"{self.seq_axis}={self._sp_size}")

    def __call__(self, *batch) -> torch.Tensor:
        self._check_batch(batch)
        return self._step(batch, self.optimizer.get_lr())

    @_led
    def _step(self, batch, lr: float) -> torch.Tensor:
        from ..models import llama as _llama

        batch = tuple(self._local_batch(b) for b in batch)
        params = self.optimizer.parameters
        for p in params:
            p.grad = None
        mean = _TokenMean([self._data, self._sp])
        shared = self._dp_size > 1 or self._sp is not None
        with self.plan, mpu.gather_scope(), _llama.global_token_mean(
                mean if shared else None), _llama.sequence_sharded(self._sp):
            loss = self.loss_fn(self.net, *batch)
            if shared and not mean.used:
                # every rank ran the same loss_fn, so every rank raises here
                raise _RefusedOnEveryRank(str(not_ported(
                    "a loss_fn over more than one data or sequence rank "
                    "that does not report its valid-token count (the "
                    "global token mean "
                    "needs it; the Llama, GPT and MoE losses, "
                    "LlamaForCausalLM.loss_from_logits, report it)",
                    "A10")))
            # inside the scope: a recomputed forward reads the same
            # gathered parameters
            loss.backward()
        loss = loss.detach().float()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        # each rank's part carries the global denominator: sum them
        for g, groups in zip(grads, self._reduce):
            for pg in groups:
                _all_reduce_(g, "sum", pg)
        if shared:
            loss = loss.clone()
            for pg in mean.groups:
                _all_reduce_(loss, "sum", pg)
        self.optimizer.apply(grads, lr=lr)
        self._step_count += 1
        return loss

    @_led
    @torch.no_grad()
    def full_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole: each sharded one gathered along its
        sharded dims over the matching mesh axis, or tuple of axes."""
        return {name: self._whole(p.detach(), self.specs[name])
                for name, p in self.params.items()}

    def _whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        for dim, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, (tuple, list)) \
                    else (entry,)
                t = _all_gather(t, [self.plan.group(a) for a in axes], dim)
        return t

    @_led
    @torch.no_grad()
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` as the step holds it: every parameter
        whole (:meth:`full_params`) and every buffer (a batch norm's
        running statistics) as this rank's view holds it, under the
        model's names and in its order."""
        full = self.full_params()
        # a tied parameter appears under each of its names
        param_of = {id(p): n for n, p in self.params.items()}
        return {name: (full[param_of[id(t)]] if id(t) in param_of
                       else t.detach().clone())
                for name, t in self.net.state_dict(keep_vars=True).items()}

    @_led
    @torch.no_grad()
    def full_optimizer_state(self) -> Dict[str, object]:
        """The optimizer's flat ``state_dict`` with every slot and master
        copy whole (each of a parameter's local shape gathered as the
        parameter is), its ``LR_Scheduler`` state (rank 0's optimizer
        holds the scheduler) and ``@step``."""
        from ..optimizer.lr import LRScheduler

        out = {}
        for name, p in self.params.items():
            state = dict(self.optimizer._slots.get(name, {}))
            if self.optimizer._masters.get(name) is not None:
                state["master"] = self.optimizer._masters[name]
            for k, v in state.items():
                out[f"{name}_{k}"] = (self._whole(v, self.specs[name])
                                      if v.shape == p.shape else v.clone())
        if isinstance(self.optimizer._lr, LRScheduler):
            out["LR_Scheduler"] = self.optimizer._lr.state_dict()
        out["@step"] = self.optimizer._step_count
        return out

    @_led
    @torch.no_grad()
    def sync_to_model(self):
        """Copy the trained parameters, gathered whole, into the model (on
        rank 0; a worker rank only takes part in the gather)."""
        full = self.full_params()
        if self.model is None:
            return
        own = dict(self.model.named_parameters())
        for name, t in full.items():
            if name in own:
                own[name].copy_(t)

    @_led
    def _rank_stats(self, reset: bool = False) -> list:
        """Every rank's kernel launch counts, ``nvcc`` runs, collective
        counts, peak device memory and resident bytes (its parameter
        shards and optimizer state, :func:`resident_bytes`), in rank
        order: gathered from the workers of a single-process step (a led
        step), this rank's alone under the launcher. ``reset`` zeroes the
        counts and the peak after reading them."""
        own = _own_stats(self.device, reset)
        own["resident_bytes"] = resident_bytes(self.params.values(),
                                               self.optimizer)
        return [own] if self._ctl is None else self._ctl.gather(own)

    # -- checkpoint (distributed.checkpoint) ---------------------------------
    @property
    def opt_state(self) -> Dict[str, torch.Tensor]:
        """The optimizer's state on this rank's shards under the
        reference's flat names (``{param}_{slot}``, ``{param}_master``,
        ``@step`` and the scheduler's numbers as ``LR_Scheduler.{field}``):
        what ``save_state_dict(step.opt_state, path)`` writes."""
        return _StepState(self, "opt",
                          {k: t for k, (t, _) in self._ckpt_entries(
                              "opt").items()})

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The parameters, persistent buffers and optimizer state of this
        rank, by name: one checkpoint of the whole step."""
        return _StepState(self, "all",
                          {k: t for k, (t, _) in self._ckpt_entries(
                              "all").items()})

    def _ckpt_entries(self, kind: str) -> Dict[str, tuple]:
        """``{name: (local tensor, fitted spec)}`` of ``kind`` (``params``,
        ``opt`` or ``all``). ``@step`` and the scheduler's numbers are 0-d
        tensors made here (the optimizer's ``_checkpoint_items``)."""
        out: Dict[str, tuple] = {}
        if kind in ("params", "all"):
            out.update((n, (p, self.specs[n])) for n, p in
                       self.params.items())
        if kind == "all":
            own = {id(p) for p in self.params.values()}
            out.update((n, (b, ())) for n, b in
                       self.net.state_dict(keep_vars=True).items()
                       if id(b) not in own and n not in out)
        if kind in ("opt", "all"):
            for key, name, t in self.optimizer._checkpoint_items():
                out[key] = (t, self.specs[name] if name is not None
                            and t.shape == self.params[name].shape else ())
        return out

    def _box(self, t: torch.Tensor, spec, coords) -> tuple:
        """``(box, global shape, writer)`` of this rank's block ``t`` under
        a fitted ``spec`` (:meth:`ShardingPlan.local`'s cut: each sharded
        dim's block at the rank's coordinate, row-major over a tuple of
        axes); ``writer`` is True where the rank's coordinate is 0 on
        every axis the block is replicated over."""
        sizes = self.plan.axes
        box, shape, on = [], [], set()
        for dim, d in enumerate(t.shape):
            entry = spec[dim] if dim < len(spec) else None
            axes = _axes_of_spec((entry,))
            n, idx = 1, 0
            for a in axes:
                idx = idx * sizes[a] + coords.get(a, 0)
                n *= sizes[a]
            on.update(axes)
            box.append([idx * int(d), (idx + 1) * int(d)])
            shape.append(n * int(d))
        writer = all(c == 0 for a, c in coords.items() if a not in on)
        return box, tuple(shape), writer

    def _ckpt_record(self, spec) -> dict:
        mesh = self.plan.process_mesh
        return {"mesh_shape": list(mesh.shape),
                "mesh_axes": list(mesh.dim_names),
                "spec": [list(e) if isinstance(e, (tuple, list)) else e
                         for e in spec]}

    @_led
    @torch.no_grad()
    def _ckpt_save(self, path: str, kind: str, async_save: bool = False,
                   coordinator_rank: int = 0,
                   merge_timeout: float = 300.0) -> None:
        """Every rank writes its blocks of ``kind`` as rank ``plan.rank``
        of ``plan.n_devices``; the coordinator merges the records."""
        from ..distributed.checkpoint import LocalShards, _dtype_name, _save

        world = self.plan.n_devices
        rank = self.plan.rank if world > 1 else 0
        coords = self.plan.coords(rank)
        sd = {}
        for key, (t, spec) in self._ckpt_entries(kind).items():
            box, shape, writer = self._box(t, spec, coords)
            sd[key] = LocalShards(shape, _dtype_name(t.dtype),
                                  [(box, t)] if writer else [],
                                  self._ckpt_record(spec))
        _save(sd, path, rank, world, coordinator_rank, async_save,
              merge_timeout)

    @_led
    @torch.no_grad()
    def _ckpt_load(self, path: str, kind: str) -> None:
        """Every rank fills its blocks of ``kind`` in place from the files
        that overlap them, whatever mesh wrote them."""
        from ..distributed.checkpoint import (_read_into, wait_all_saves,
                                              get_checkpoint_metadata)

        wait_all_saves()
        meta = get_checkpoint_metadata(path)
        entries = self._ckpt_entries(kind)
        missing = [k for k in entries if k not in meta["tensors"]]
        if missing:
            raise KeyError(f"checkpoint at {path} lacks keys: "
                           f"{missing[:5]}...")
        world = self.plan.n_devices
        coords = self.plan.coords(self.plan.rank if world > 1 else 0)
        targets = []
        for key, (t, spec) in entries.items():
            box, shape, _ = self._box(t, spec, coords)
            if tuple(meta["tensors"][key]["shape"]) != shape:
                raise ValueError(
                    f"shape mismatch for {key}: ckpt "
                    f"{tuple(meta['tensors'][key]['shape'])} vs {shape}")
            targets.append((key, t, tuple(map(tuple, box))))
        _read_into(targets, path, meta)
        self.optimizer._load_checkpoint_scalars(
            {k: t for k, (t, _) in entries.items()})

    @_led
    @torch.no_grad()
    def _rank_digests(self, kind: str = "all") -> list:
        """Every rank's ``{name: digest}`` of its tensors of ``kind``
        (:func:`_digest`), in rank order: equal digests say a rank holds
        the same bits."""
        own = {k: _digest(t) for k, t in (
            (k, t) for k, (t, _) in self._ckpt_entries(kind).items())}
        return [own] if self._ctl is None else self._ctl.gather(own)

    def follow(self) -> int:
        """A worker rank's loop: run each step rank 0 sends, in its order,
        until rank 0's :meth:`close`. A refusal that every rank raises
        at the same point (``_RefusedOnEveryRank``: a loss function that
        reports no token count) is logged and the loop goes on. Anything
        else may be this rank's alone and propagates: this rank dies, and
        its closed connections fail rank 0's next collective at once.
        Returns the number of steps run."""
        ctl = self._ctl
        if ctl is None or ctl.driver:
            raise RuntimeError("follow() is for the worker ranks of a "
                               "single-process step")
        n = 0
        while True:
            name, args, kwargs = ctl.receive()
            if name == STOP:
                return n
            ctl.depth += 1
            try:
                getattr(self, name)(*args, **kwargs)
            except _RefusedOnEveryRank as e:
                _log.warning("worker step %s raised %s: %s", name,
                             type(e).__name__, e)
            finally:
                ctl.depth -= 1
            n += 1

    def close(self) -> None:
        """End the worker ranks of a single-process step (their
        :meth:`follow` returns and they exit; one that has not within 15 s
        is killed). Idempotent; nothing to do in the SPMD form."""
        ctl = self._ctl
        if ctl is not None and ctl.driver and not ctl.stopped:
            got = ctl.lock.acquire(timeout=10.0)
            try:
                if got and ctl.failed is None:
                    try:
                        ctl.send(STOP, (), {})
                    except Exception as e:  # noqa: BLE001 — a rank lost
                        ctl.failed = e
            finally:
                ctl.stopped = True
                if got:
                    ctl.lock.release()
        if self._ranks is not None:
            self._ranks.close()
            self._finalizer.detach()

    stop = close
