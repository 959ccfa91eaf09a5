"""``DataParallel`` (counterpart of ``paddlepaddle_tpu/distributed/parallel.py``
:19).

The reference shards the batch over a ``dp`` mesh axis and lets XLA average
the gradients. Here each rank holds a whole replica and its own batch, and
every parameter's gradient is averaged over the data-parallel group as soon
as it is accumulated (a ``post_accumulate_grad`` hook per parameter, one
all-reduce each, no buckets: simple before fast; the buffer sizes are
accepted and recorded). ``no_sync()`` suspends the averaging for gradient
accumulation; the first backward after it averages the accumulated sum.
In a process without a group, or a world of one, it is the plain layer.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch import nn

from .collective import _all_reduce_, _resolve_pg


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self._grad_sync_enabled = True
        self._pg = (_resolve_pg(group) if dist.is_initialized()
                    and dist.get_world_size(_resolve_pg(group)) > 1 else None)
        self._hooks = []
        if self._pg is not None:
            for p in layers.parameters():
                if p.requires_grad:
                    self._hooks.append(
                        p.register_post_accumulate_grad_hook(self._average))

    @torch.no_grad()
    def _average(self, p: torch.Tensor) -> None:
        if self._grad_sync_enabled and p.grad is not None:
            _all_reduce_(p.grad, "avg", self._pg)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextmanager
    def no_sync(self):
        """Suspend the gradient averaging (gradient accumulation)."""
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = True

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    def scale_loss(self, loss):
        return loss
