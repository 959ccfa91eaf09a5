"""LR schedulers: the port's own copy of the subset the Llama training recipe
uses (counterpart of ``paddlepaddle_tpu/optimizer/lr.py``: ``LRScheduler``
:9, ``LinearWarmup`` :105, ``CosineAnnealingDecay`` :192). Plain Python, the
same arithmetic and the same ``state_dict`` as the reference; the other
schedulers are not ported (ROADMAP A5)."""

from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {
            k: v
            for k, v in self.__dict__.items()
            if isinstance(v, (int, float, bool, str, list))
        }

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = (learning_rate if isinstance(learning_rate, LRScheduler)
                         else None)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (learning_rate if not isinstance(learning_rate, LRScheduler)
                else learning_rate.base_lr)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return ((self.end_lr - self.start_lr) * self.last_epoch
                    / max(self.warmup_steps, 1) + self.start_lr)
        if self.lr_sched is not None:
            self.lr_sched.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_sched.get_lr()
        return self.base_lr

    def state_dict(self):
        sd = super().state_dict()
        if self.lr_sched is not None:
            sd["LinearWarmup_LR"] = self.lr_sched.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        inner = state_dict.pop("LinearWarmup_LR", None)
        super().set_state_dict(state_dict)
        if inner and self.lr_sched is not None:
            self.lr_sched.set_state_dict(inner)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
