"""The training step (counterpart of ``paddlepaddle_tpu/jit/train.py`` :27).

The reference compiles forward, backward and the optimizer update into one
jitted XLA program over donated buffers. PyTorch runs eagerly, so here one
call is: ``loss_fn(model, *batch)``, ``backward()`` (the flash attention
kernels run inside it on the card), then the optimizer's clip and update in
place. There is no ``jax.jit`` counterpart to add; the model's parameters
are the step's parameters, so there is nothing to sync back either.

With the perf plane armed (``observability.perf``), the first call after
arming is counted as the ``train.step`` program's cost (reference
:107-130): its FLOPs and bytes, over every microbatch, the flash kernels'
own reports included (:func:`..observability.perf.counting`). Wall time is
not observed here; bracket steps with ``obs.perf.step()``, which closes in
a device sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..observability import perf as _perf
from ..optimizer.optimizer import Optimizer


class TrainStep:
    """``step(*batch) -> loss``: one optimizer step of ``model`` on a batch.

    ``loss_fn(model, *batch)`` returns a scalar loss. With
    ``grad_accum_steps = a > 1`` the leading batch dimension is split into
    ``a`` microbatches whose gradients are summed and divided by ``a``; the
    loss returned is their mean (reference :69-87). Every call reads
    ``optimizer.get_lr()``. A parameter the loss does not reach gets a zero
    gradient, as the reference's whole-tree ``jax.grad`` gives it.

    The parameters keep the reference's positional order (:34-35).
    ``donate`` is accepted and recorded as ``self.donate``: an eager step has
    no jitted buffers to donate, as ``lazy_mode`` is accepted unread by the
    optimizers. ``device`` is keyword-only; ``None`` means the card
    (:func:`..device.resolve_device`); the model must already be on the
    step's device. Batch elements may be tensors or numpy arrays; they are
    moved to that device.
    """

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, grad_accum_steps: int = 1,
                 donate: bool = True, *, device: DeviceLike = None):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps {grad_accum_steps} < 1")
        self.donate = bool(donate)
        self.device = resolve_device(device)
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        for name, p in self.params.items():
            if p.device != self.device:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"step runs on {self.device}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_accum = int(grad_accum_steps)
        if not optimizer.parameters:
            optimizer.set_parameters(self.params)
        optimizer.init_state()
        self._cost_captured = False

    def __call__(self, *batch) -> torch.Tensor:
        if self._cost_captured or not _perf.enabled():
            return self._step(*batch)
        self._cost_captured = True
        with _perf.counting("train.step", bucket=f"accum{self.grad_accum}",
                            model=type(self.model).__name__):
            return self._step(*batch)

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _step(self, *batch) -> torch.Tensor:
        batch = tuple(self._to_device(b) for b in batch)
        lr = self.optimizer.get_lr()
        params = self.optimizer.parameters
        for p in params:
            p.grad = None
        a = self.grad_accum
        if a == 1:
            loss = self.loss_fn(self.model, *batch)
            loss.backward()
            loss = loss.detach()
        else:
            for x in batch:
                if x.shape[0] % a:
                    raise ValueError(f"batch dimension {x.shape[0]} is not "
                                     f"divisible by grad_accum_steps {a}")
            micro = [x.reshape(a, x.shape[0] // a, *x.shape[1:])
                     for x in batch]
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(a):
                part = self.loss_fn(self.model, *(m[i] for m in micro))
                part.backward()
                loss = loss + part.detach().float()
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(a)
            loss = loss / a
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        self.optimizer.apply(grads, lr=lr)
        return loss

    def state_dict(self) -> Dict[str, object]:
        """``{"params": {name: tensor}, "opt_state": {"slots", "master",
        "step"}}``, the layout of the reference's (:142)."""
        return {"params": {n: p.detach().clone()
                           for n, p in self.params.items()},
                "opt_state": self.optimizer.functional_state()}

    @torch.no_grad()
    def set_state_dict(self, sd: Mapping[str, object]) -> None:
        params = sd["params"]
        if set(params) != set(self.params):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(self.params) - set(params))}, "
                           f"unexpected {sorted(set(params) - set(self.params))}")
        for name, p in self.params.items():
            src = torch.as_tensor(params[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
        self.optimizer.set_functional_state(sd["opt_state"])
