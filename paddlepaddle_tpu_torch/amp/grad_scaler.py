"""``GradScaler``, dynamic loss scaling (counterpart of
``paddlepaddle_tpu/amp/grad_scaler.py`` :16-124).

The reference's semantics: ``scale(loss)`` multiplies by the scale;
``unscale_(opt)`` multiplies every gradient by ``1 / scale`` in f32, casts
it back to its dtype and records whether any is inf or nan; ``step(opt)``
unscales if that has not happened, runs ``opt.step()`` only when every
gradient is finite (so a skipped step leaves parameters, masters and slots
untouched), and then updates the scale: ``decr_ratio`` after
``decr_every_n_nan_or_inf`` bad steps (never below 1), ``incr_ratio`` after
``incr_every_n_steps`` good ones. ``update()`` does nothing, since
``step()`` has updated the scale, as in the reference.

``unscale_`` reads found-inf with one host synchronisation a step: the
per-gradient checks reduce on the device into one flag. In a job of
several processes (``PADDLE_TRAINERS_NUM`` > 1) the flag is then MAXed
over the host group (``distributed.host_collectives.get_host_group``), so
every rank skips or steps together, as in the reference.
"""

from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self) -> torch.Tensor:
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer.parameters:
            g = p.grad
            if g is None:
                continue
            gf = g.float() * inv
            flag = ~torch.isfinite(gf).all()
            bad = flag if bad is None else bad | flag
            g.copy_(gf)
        found = bool(bad) if bad is not None else False
        # multi-process jobs must agree on skip-vs-step (reference :59-68):
        # a MAX of the flag over the host group settles it
        from ..distributed.host_collectives import get_host_group

        hg = get_host_group()
        if hg is not None:
            import numpy as np

            found = bool(hg.all_reduce(np.asarray(found, np.float32),
                                       op="max") > 0)
        self._found_inf = found
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()
        self._unscaled = False

    def minimize(self, optimizer, loss):
        self.step(optimizer)

    def update(self):
        """Kept for API parity: ``step()`` has updated the scale."""

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)

    set_state_dict = load_state_dict
