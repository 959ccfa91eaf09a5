"""``Adam`` and ``AdamW`` (counterparts of
``paddlepaddle_tpu/optimizer/optimizers.py`` :43-106): the reference's
arithmetic in f32, applied in place. The other optimizers are not ported
(ROADMAP A5)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .optimizer import Optimizer


class Adam(Optimizer):
    """Bias-corrected moments in f32 through per-parameter ``beta1_pow`` /
    ``beta2_pow``; ``amsgrad`` keeps the running maximum of the second
    moment in ``moment2_max``. ``weight_decay`` is a coupled L2
    coefficient folded into the gradient. The parameters keep the
    reference's positional order; ``lazy_mode``, ``use_multi_tensor`` and
    ``name`` are accepted and, as in the reference, never read."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        def zeros():
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        s = {"moment1": zeros(), "moment2": zeros(),
             "beta1_pow": torch.ones((), dtype=torch.float32, device=p.device),
             "beta2_pow": torch.ones((), dtype=torch.float32, device=p.device)}
        if self._amsgrad:
            s["moment2_max"] = zeros()
        return s

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        b1, b2 = self._beta1, self._beta2
        b1p = slots["beta1_pow"].mul_(b1)
        b2p = slots["beta2_pow"].mul_(b2)
        m1 = slots["moment1"].mul_(b1).add_(g, alpha=1 - b1)
        m2 = slots["moment2"].mul_(b2).addcmul_(g, g, value=1 - b2)
        if self._amsgrad:
            m2 = torch.maximum(slots["moment2_max"], m2,
                               out=slots["moment2_max"])
        upd = (m1 / (1 - b1p)).mul_(lr)
        denom = (m2 / (1 - b2p)).sqrt_().add_(self._eps)
        p.sub_(upd.div_(denom))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p *= 1 - lr * weight_decay``
    before the Adam rule, skipped for every parameter whose name
    ``apply_decay_param_fun`` rejects. The parameters keep the reference's
    positional order; ``lr_ratio``, ``lazy_mode`` and ``name`` are accepted
    and, as in the reference, never read."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad)
        self._wd = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_weight_decay(self) -> bool:
        return True

    def _wd_scale_for(self, name: str) -> float:
        fun = self._apply_decay_param_fun
        return 0.0 if fun is not None and not fun(name) else 1.0

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        if self._wd * wd_scale:
            p.mul_(1.0 - lr * self._wd * wd_scale)
        super()._rule(p, g, slots, lr)
