"""Optimizer base (counterpart of ``paddlepaddle_tpu/optimizer/optimizer.py``
:28).

The reference has two forms of one update rule: the eager ``step()`` and
the functional ``init_state`` / ``apply`` pair (:158, :172) that a jitted
train step threads through. The port keeps one form: per-parameter f32
``master`` tensors and slot tensors, created by :meth:`Optimizer.init_state`
and updated IN PLACE under ``torch.no_grad()`` by :meth:`Optimizer.apply`
(where the reference returned new arrays). :meth:`Optimizer.step` is
``apply`` on each parameter's ``.grad``.

Multi-precision follows the reference (:105-124): with
``multi_precision=True`` a bf16/fp16 parameter keeps an f32 master copy;
the rule updates the master in f32 and the parameter receives its cast each
step. Without it, the parameter itself is the f32 state (an f32 parameter
is updated in place; a bf16 one is widened, updated and cast back).

Parameters are named: ``parameters`` may be ``model.named_parameters()``,
a ``{name: tensor}`` mapping, or plain tensors (named ``param_<i>``). The
names key the state dicts and are what ``apply_decay_param_fun`` receives.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..regularizer import L1Decay
from .lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _named(parameters) -> Tuple[List[str], List[torch.Tensor]]:
    if parameters is None:
        return [], []
    items = (list(parameters.items()) if isinstance(parameters, Mapping)
             else list(parameters))
    if items and not isinstance(items[0], tuple):
        items = [(f"param_{i}", p) for i, p in enumerate(items)]
    names = [n for n, _ in items]
    if len(set(names)) != len(names):
        raise ValueError("parameter names must be unique")
    return names, [p for _, p in items]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        # ``name`` is accepted and never read, as in the reference
        self._lr = learning_rate
        self._names, self._params = _named(parameters)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self._masters: Dict[str, Optional[torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler; "
                               "call scheduler.step()")
        self._lr = value

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # -- update rule (override) ---------------------------------------------
    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        """Update the f32 parameter ``p`` and ``slots`` in place from the
        f32 gradient ``g``."""
        raise NotImplementedError

    def _decoupled_weight_decay(self) -> bool:
        return False

    def _decay_term(self, pf: torch.Tensor) -> torch.Tensor:
        """The coupled decay folded into the f32 gradient (reference
        :66-75): ``coeff * sign(w)`` for ``L1Decay``, ``coeff * w`` for
        ``L2Decay`` or a plain float."""
        coeff = float(self._weight_decay)
        if isinstance(self._weight_decay, L1Decay):
            return torch.sign(pf).mul_(coeff)
        return pf * coeff

    def _wd_scale_for(self, name: str) -> float:
        """Per-parameter weight-decay scale (1.0 = full decay)."""
        return 1.0

    # -- state ---------------------------------------------------------------
    @property
    def parameters(self) -> List[torch.Tensor]:
        return list(self._params)

    def set_parameters(self, parameters) -> None:
        """Bind parameters to an optimizer built without them."""
        if self._params:
            raise ValueError("optimizer already has parameters")
        self._names, self._params = _named(parameters)

    def _rebind(self, parameters) -> None:
        """Bind ``parameters`` (name -> tensor) in place of the current
        ones, with fresh state: a sharded step trains its own local
        shards."""
        self._names, self._params = _named(parameters)
        self._slots.clear()
        self._masters.clear()

    def _worker_copy(self) -> "Optimizer":
        """This optimizer's class and settings with no parameters, no state
        and the current learning rate as a number: what each worker rank of
        a single-process sharded train step rebinds to its own shards
        (:meth:`_rebind`). Rank 0 sends every step's learning rate, so a
        scheduler stays on rank 0. A function-valued setting (AdamW's
        ``apply_decay_param_fun``, Lamb's ``exclude_from_weight_decay_fn``)
        is shipped by value (:func:`~..distributed.ship.ship`); one that
        cannot be sent raises here."""
        import copy
        import types

        from ..distributed.ship import ship

        out = copy.copy(self)
        out._names, out._params = [], []
        out._slots, out._masters = {}, {}
        out._lr = self.get_lr()
        for k, v in vars(self).items():
            if isinstance(v, types.FunctionType):
                setattr(out, k, ship(v, f"the optimizer's {k.lstrip('_')}"))
        return out

    def _use_master(self, p: torch.Tensor) -> bool:
        return self._multi_precision and p.dtype in _LOW_PRECISION

    @torch.no_grad()
    def init_state(self) -> None:
        """Create the slots and masters of every parameter that has none."""
        for name, p in zip(self._names, self._params):
            if name not in self._slots:
                self._slots[name] = self._init_slots(p)
                self._masters[name] = (p.detach().float().clone()
                                       if self._use_master(p) else None)

    @torch.no_grad()
    def apply(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None,
              lr: Optional[float] = None) -> None:
        """One update of every parameter whose gradient is not None, in
        place. ``grads`` defaults to each parameter's ``.grad``; the
        gradient clip, when set, scales them in place first."""
        if not self._params:
            raise ValueError("optimizer created without parameters")
        grads = (list(grads) if grads is not None
                 else [p.grad for p in self._params])
        if len(grads) != len(self._params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self._params)} parameters")
        lr = self.get_lr() if lr is None else float(lr)
        self.init_state()
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_grads(grads)
        for name, p, g in zip(self._names, self._params, grads):
            if g is None:
                continue
            master = self._masters[name]
            # an f32 parameter is its own state: .float() returns it
            pf = master if master is not None else p.detach().float()
            gf = g.float()
            if self._weight_decay and not self._decoupled_weight_decay():
                gf = gf + self._decay_term(pf)
            self._rule(pf, gf, self._slots[name], lr, self._wd_scale_for(name))
            if p.dtype != torch.float32:
                p.copy_(pf)
        self._step_count += 1

    def step(self) -> None:
        self.apply()

    def clear_grad(self) -> None:
        for p in self._params:
            p.grad = None

    # -- state dicts ---------------------------------------------------------
    def functional_state(self) -> Dict[str, object]:
        """``{"slots": {name: {slot: tensor}}, "master": {name: tensor or
        None}, "step": int}``: the layout of the reference's functional
        state (:158), copied."""
        self.init_state()
        return {
            "slots": {n: {k: v.detach().clone() for k, v in s.items()}
                      for n, s in self._slots.items()},
            "master": {n: None if m is None else m.detach().clone()
                       for n, m in self._masters.items()},
            "step": self._step_count,
        }

    @torch.no_grad()
    def set_functional_state(self, state: Mapping[str, object]) -> None:
        """Load :meth:`functional_state`'s layout (any device, numpy or
        torch leaves); every parameter's slots must be present."""
        slots, masters = state["slots"], state["master"]
        for name, p in zip(self._names, self._params):
            if name not in slots:
                raise KeyError(f"no optimizer slots for parameter {name!r}")
            fresh = self._init_slots(p)
            for k, t in fresh.items():
                t.copy_(torch.as_tensor(slots[name][k]))
            self._slots[name] = fresh
            m = masters.get(name)
            if m is not None:
                self._masters[name] = torch.as_tensor(m).to(
                    p.device, torch.float32).clone()
            else:
                self._masters[name] = (p.detach().float().clone()
                                       if self._use_master(p) else None)
        self._step_count = int(state["step"])

    def state_dict(self) -> Dict[str, object]:
        """Flat ``{f"{name}_{slot}": tensor, f"{name}_master": tensor,
        "LR_Scheduler": ..., "@step": int}``, as the reference (:218)."""
        sd: Dict[str, object] = {}
        for name in self._names:
            for k, v in self._slots.get(name, {}).items():
                sd[f"{name}_{k}"] = v.detach().clone()
            m = self._masters.get(name)
            if m is not None:
                sd[f"{name}_master"] = m.detach().clone()
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        sd["@step"] = self._step_count
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict: Mapping[str, object]) -> None:
        for name, p in zip(self._names, self._params):
            slots = self._init_slots(p)
            for k, t in slots.items():
                key = f"{name}_{k}"
                if key in state_dict:
                    t.copy_(torch.as_tensor(state_dict[key]))
            self._slots[name] = slots
            mkey = f"{name}_master"
            if mkey in state_dict:
                self._masters[name] = torch.as_tensor(state_dict[mkey]).to(
                    p.device, torch.float32).clone()
            else:
                self._masters[name] = (p.detach().float().clone()
                                       if self._use_master(p) else None)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(dict(state_dict["LR_Scheduler"]))
        self._step_count = int(state_dict.get("@step", 0))
