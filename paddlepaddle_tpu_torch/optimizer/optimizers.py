"""The optimizers (counterparts of ``paddlepaddle_tpu/optimizer/optimizers.py``
:14-275 and :430-500): ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adagrad``, ``RMSProp``, ``Adadelta``, ``Adamax``, ``Lamb``, ``Lars`` (alias
``LarsMomentumOptimizer``), ``NAdam`` and ``RAdam``. Each is one ``_rule``
on the base's f32 master / slot machinery: the reference's arithmetic in
f32, its slots under its names, updated in place. Every constructor keeps
the reference's positional order; ``name`` (and the other arguments the
reference accepts and never reads) are accepted unread. ``LBFGS``, ``ASGD``,
``Rprop`` and ``DGCMomentumOptimizer`` are not ported (ROADMAP A5)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .optimizer import Optimizer


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _ones0(p: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    """``p -= lr * g``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        p.sub_(g * lr)


class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = mu v + g``, then ``p -= lr v``, or with
    ``use_nesterov`` ``p -= lr (g + mu v)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"velocity": _zeros(p)}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        v = slots["velocity"].mul_(self._momentum).add_(g)
        if self._nesterov:
            p.sub_((g + self._momentum * v) * lr)
        else:
            p.sub_(v * lr)


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


class Adagrad(Optimizer):
    """``moment += g^2``; ``p -= lr g / (sqrt(moment) + eps)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._eps = epsilon
        self._init_val = initial_accumulator_value

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"moment": torch.full(p.shape, float(self._init_val),
                                     dtype=torch.float32, device=p.device)}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        mom = slots["moment"].add_(g * g)
        p.sub_((lr * g).div_(mom.sqrt().add_(self._eps)))


class RMSProp(Optimizer):
    """Mean square ``ms = rho ms + (1 - rho) g^2`` (with ``centered``, the
    mean gradient ``mg`` too, and ``ms - mg^2`` under the root); momentum
    ``mom = momentum mom + lr g / sqrt(ms + eps)``; ``p -= mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = {"mean_square": _zeros(p), "momentum_acc": _zeros(p)}
        if self._centered:
            s["mean_grad"] = _zeros(p)
        return s

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        rho = self._rho
        ms = slots["mean_square"].mul_(rho).add_((1 - rho) * g * g)
        if self._centered:
            mg = slots["mean_grad"].mul_(rho).add_((1 - rho) * g)
            denom = (ms - mg * mg + self._eps).sqrt_()
        else:
            denom = (ms + self._eps).sqrt_()
        mom = slots["momentum_acc"].mul_(self._momentum).add_(
            (lr * g).div_(denom))
        p.sub_(mom)


class Adadelta(Optimizer):
    """``asg = rho asg + (1 - rho) g^2``; ``update = -sqrt(asu + eps) /
    sqrt(asg + eps) g``; ``asu = rho asu + (1 - rho) update^2``; ``p += lr
    update``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._eps, self._rho = epsilon, rho

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        rho, eps = self._rho, self._eps
        asg = slots["avg_squared_grad"].mul_(rho).add_((1 - rho) * g * g)
        asu = slots["avg_squared_update"]
        update = (-(asu + eps).sqrt_()).div_((asg + eps).sqrt_()).mul_(g)
        asu.mul_(rho).add_((1 - rho) * update * update)
        p.add_(lr * update)


class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(beta2 u, |g|)``; ``p -= (lr /
    (1 - beta1^t)) m / (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"moment": _zeros(p), "inf_norm": _zeros(p),
                "beta1_pow": _ones0(p)}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        b1 = self._beta1
        b1p = slots["beta1_pow"].mul_(b1)
        m = slots["moment"].mul_(b1).add_((1 - b1) * g)
        u = torch.maximum(slots["inf_norm"].mul_(self._beta2), g.abs(),
                          out=slots["inf_norm"])
        p.sub_((lr / (1 - b1p)) * m / (u + self._eps))


class Lamb(Optimizer):
    """Layer-wise adaptive moments: the Adam direction ``r = m_hat /
    (sqrt(v_hat) + eps) + lamb_weight_decay p`` scaled by the trust ratio
    ``||p|| / ||r||`` (1 where either norm is 0). As in the reference,
    ``exclude_from_weight_decay_fn`` is stored and never read (its
    ``_rule`` decays every parameter): a quirk of the reference, mirrored."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "beta1_pow": _ones0(p), "beta2_pow": _ones0(p)}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        b1, b2 = self._beta1, self._beta2
        b1p = slots["beta1_pow"].mul_(b1)
        b2p = slots["beta2_pow"].mul_(b2)
        m1 = slots["moment1"].mul_(b1).add_((1 - b1) * g)
        m2 = slots["moment2"].mul_(b2).add_((1 - b2) * g * g)
        r = (m1 / (1 - b1p)) / ((m2 / (1 - b2p)).sqrt_().add_(self._eps))
        r.add_(self._wd * p)
        w_norm = p.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.sub_(lr * trust * r)


class Lars(Optimizer):
    """LARS momentum (reference ``Lars`` :473): ``local_lr = lr lars_coeff
    ||p|| / (||g|| + wd ||p|| + eps)`` (``lr`` where either norm is 0),
    ``v = mu v + local_lr (g + wd p)``, ``p -= v``. A parameter whose name
    contains one of ``exclude_from_weight_decay`` gets no decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._mu = float(momentum)
        self._coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._eps = float(epsilon)
        self._exclude = list(exclude_from_weight_decay or [])

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"velocity": _zeros(p)}

    def _wd_scale_for(self, name: str) -> float:
        return 0.0 if any(t in name for t in self._exclude) else 1.0

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        wd = self._lars_wd * wd_scale
        p_norm = p.square().sum().sqrt()
        g_norm = g.square().sum().sqrt()
        local = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._coeff * p_norm / (g_norm + wd * p_norm + self._eps
                                         + 1e-30),
            torch.full_like(p_norm, lr))
        v = slots["velocity"].mul_(self._mu).add_(local * (g + wd * p))
        p.sub_(v)


LarsMomentumOptimizer = Lars        # the reference's incubate alias


class NAdam(Adam):
    """Nesterov Adam with the momentum schedule ``mu_t = beta1 (1 - 0.5
    0.96^(t momentum_decay))``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._psi = momentum_decay

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "mu_prod": _ones0(p), "beta2_pow": _ones0(p),
                "t": torch.zeros((), dtype=torch.float32, device=p.device)}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        b1, b2 = self._beta1, self._beta2
        t = slots["t"].add_(1.0)
        mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1.0) * self._psi))
        mu_prod = slots["mu_prod"].mul_(mu_t)
        b2p = slots["beta2_pow"].mul_(b2)
        m1 = slots["moment1"].mul_(b1).add_((1 - b1) * g)
        m2 = slots["moment2"].mul_(b2).add_((1 - b2) * g * g)
        m1_hat = (mu_t1 * m1 / (1 - mu_prod * mu_t1)
                  + (1 - mu_t) * g / (1 - mu_prod))
        m2_hat = m2 / (1 - b2p)
        p.sub_(lr * m1_hat / (m2_hat.sqrt() + self._eps))


class RAdam(Adam):
    """Rectified Adam: the Adam step times the variance rectification
    ``r_t`` once ``rho_t > 4``, the bias-corrected momentum step before."""

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "beta1_pow": _ones0(p), "beta2_pow": _ones0(p),
                "t": torch.zeros((), dtype=torch.float32, device=p.device)}

    def _rule(self, p, g, slots, lr: float, wd_scale: float = 1.0) -> None:
        b1, b2 = self._beta1, self._beta2
        t = slots["t"].add_(1.0)
        b1p = slots["beta1_pow"].mul_(b1)
        b2p = slots["beta2_pow"].mul_(b2)
        m1 = slots["moment1"].mul_(b1).add_((1 - b1) * g)
        m2 = slots["moment2"].mul_(b2).add_((1 - b2) * g * g)
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * b2p / (1 - b2p)
        m1_hat = m1 / (1 - b1p)
        r = (((rho_t - 4) * (rho_t - 2) * rho_inf)
             / torch.clamp((rho_inf - 4) * (rho_inf - 2) * rho_t,
                           min=1e-12)).sqrt()
        adam_step = r * m1_hat / ((m2 / (1 - b2p)).sqrt() + self._eps)
        p.sub_(lr * torch.where(rho_t > 4.0, adam_step, m1_hat))
