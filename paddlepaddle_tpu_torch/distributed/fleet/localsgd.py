"""LocalSGD meta-optimizer — periodic cross-process parameter averaging
(counterpart of ``paddlepaddle_tpu/distributed/fleet/localsgd.py``;
reference: fleet/meta_optimizers/localsgd_optimizer.py: run k local steps,
then average the parameters across the data-parallel workers).

The wrapper runs the inner optimizer locally and averages the parameters
over the host process group (``distributed.host_collectives``) every
``k_steps``: one collective for the whole model (the store transport pays
a round trip per op), in f32, written back in place in each parameter's
dtype. In a single-process job it is the inner optimizer, so the same
script runs anywhere.
"""

from __future__ import annotations

import numpy as np
import torch


class LocalSGD:
    """Wrap an optimizer: k local steps, then parameter averaging over the
    host group. Averaging fires once the step count reaches ``begin_step``
    (before it, steps are purely local, as in the reference)."""

    def __init__(self, optimizer, k_steps: int = 1, begin_step: int = 1):
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._optimizer = optimizer
        self._k = int(k_steps)
        self._begin = int(begin_step)
        self._step_count = 0

    def __getattr__(self, name):
        if name == "_optimizer":   # bare instance (copy/pickle probes)
            raise AttributeError(name)
        return getattr(self._optimizer, name)

    @torch.no_grad()
    def _average(self):
        from ..host_collectives import get_host_group

        g = get_host_group()
        if g is None:
            return  # single process: local IS global
        params = list(self._optimizer.parameters)
        if not params:
            return
        flats = [p.detach().float().cpu().numpy().ravel() for p in params]
        avg = g.all_reduce(np.concatenate(flats), op="avg")
        off = 0
        for p, f in zip(params, flats):
            chunk = avg[off:off + f.size].reshape(tuple(p.shape))
            off += f.size
            p.copy_(torch.from_numpy(np.ascontiguousarray(chunk)))
        # an f32 master of a low-precision parameter follows it
        masters = getattr(self._optimizer, "_masters", {})
        for name, p in zip(getattr(self._optimizer, "_names", ()), params):
            m = masters.get(name)
            if m is not None:
                m.copy_(p)

    def step(self):
        self._optimizer.step()
        self._step_count += 1
        if self._step_count >= self._begin and \
                self._step_count % self._k == 0:
            self._average()
