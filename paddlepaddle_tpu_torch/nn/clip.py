"""``ClipGradByGlobalNorm`` (counterpart of ``paddlepaddle_tpu/nn/clip.py``
:52-84, the ``clip_tree`` form a train step uses)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(clip_norm / max(norm, 1e-12), 1)``,
    where ``norm`` is the f32 global norm over all of them. The scaling is
    in place; a bf16 gradient is scaled in f32 and rounded back, as the
    reference's ``(g.astype(f32) * scale).astype(g.dtype)``."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack([g.float().square().sum() for g in grads]).sum() \
            .sqrt()

    @torch.no_grad()
    def clip_grads(self, grads: Sequence[Optional[torch.Tensor]]
                   ) -> List[Optional[torch.Tensor]]:
        present = [g for g in grads if g is not None]
        if present:
            norm = self.global_norm(present)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            for g in present:
                g.mul_(scale)
        return list(grads)
