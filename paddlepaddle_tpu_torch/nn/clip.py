"""Gradient clipping (counterpart of ``paddlepaddle_tpu/nn/clip.py``
:15-110): ``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``
(the ``Gradient*`` aliases) and ``clip_grad_norm_``.

An optimizer's ``grad_clip=`` takes any of the three classes and calls
``clip_grads(grads)``, which clips a list of gradients (``None`` entries
pass through) in place and returns it; ``clip(params_grads)`` is the
reference's ``(param, grad)`` pair form over the same arithmetic. A bf16
gradient is scaled in f32 and rounded back, as the reference's
``(g.astype(f32) * scale).astype(g.dtype)`` (an in-place ``mul_`` by the
f32 scale computes in f32 and rounds once)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class ClipGradBase:
    @torch.no_grad()
    def clip_grads(self, grads: Sequence[Optional[torch.Tensor]]
                   ) -> List[Optional[torch.Tensor]]:
        raise NotImplementedError

    def __call__(self, params_grads):
        """The reference's pair form: ``[(param, grad)]`` in, clipped pairs
        out; a parameter with ``need_clip = False`` keeps its gradient."""
        pairs = list(params_grads)
        keep = [g is None or not getattr(p, "need_clip", True)
                for p, g in pairs]
        clipped = self.clip_grads([None if k else g
                                   for k, (_, g) in zip(keep, pairs)])
        return [(p, g if k else c)
                for k, (p, g), c in zip(keep, pairs, clipped)]


class ClipGradByValue(ClipGradBase):
    """Each element clipped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    @torch.no_grad()
    def clip_grads(self, grads):
        for g in grads:
            if g is not None:
                g.clamp_(self.min, self.max)
        return list(grads)


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``
    with its own f32 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def clip_grads(self, grads):
        for g in grads:
            if g is not None:
                norm = g.float().square().sum().sqrt()
                g.mul_(torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                  max=1.0))
        return list(grads)


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(clip_norm / max(norm, 1e-12), 1)``,
    where ``norm`` is the f32 global norm over all of them. The reference's
    ``group_name`` is recorded and ``auto_skip_clip`` accepted unread, as
    there."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack([g.float().square().sum() for g in grads]).sum() \
            .sqrt()

    @torch.no_grad()
    def clip_grads(self, grads):
        present = [g for g in grads if g is not None]
        if present:
            norm = self.global_norm(present)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            for g in present:
                g.mul_(scale)
        return list(grads)


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by ``min(max_norm /
    max(total, 1e-12), 1)``, ``total`` the ``norm_type`` norm over all of
    them (the largest magnitude for ``inf``); returns ``total``.
    ``error_if_nonfinite`` is accepted unread, as in the reference."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum().pow(1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return total
