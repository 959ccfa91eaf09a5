"""Activation recompute (counterpart of
``paddlepaddle_tpu/distributed/fleet/recompute.py`` :24-110: ``recompute``,
``recompute_sequential``).

The reference wraps a layer in ``jax.checkpoint``; here a layer runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its forward
keeps only the layer's inputs, and ``backward()`` runs the layer again to
rebuild what its gradients need. The flash kernels' autograd Function is
re-run with it (kernel 2 launches twice a layer a step; kernels 3 and 4
once).

A ``policy`` selects what the region saves instead of recomputing, as the
reference's ``jax.checkpoint`` policies do:

* ``None``: nothing (full remat);
* ``"dots"``: the outputs of every matrix product (aten ``mm``, ``addmm``,
  ``bmm``), as ``jax.checkpoint_policies.checkpoint_dots``;
* ``"dots_no_batch"``: those without a batch dimension (``mm``,
  ``addmm``), as ``dots_with_no_batch_dims_saveable``.

Either selective policy runs through
``torch.utils.checkpoint.create_selective_checkpoint_contexts``. The flash
kernels launch through ctypes, which the dispatcher does not see, so no
policy caches their outputs: the JAX policies recompute the Pallas forward
too, a ``pallas_call`` not being a dot.

Two states the recomputation must see as the forward saw them, and which
``torch.utils.checkpoint`` does not restore by itself:

* the port's random streams (:mod:`...core.random`, which the attention
  dropouts draw from, with any active ``generator_scope``): captured at
  forward and replayed around the recompute, so a recomputed dropout
  draws the same mask;
* the AMP state (:mod:`...amp`): the recompute runs inside ``backward()``,
  outside any ``auto_cast`` block, so the forward's state is re-entered.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ...amp import amp_cast, amp_state, amp_state_scope
from ...core import random as prandom

_SAVED_OPS = {
    "dots": ("mm", "addmm", "bmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def remat_policy(policy: Union[None, str, Callable]) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for a
    policy name (``None``, ``"dots"``, ``"dots_no_batch"``), or a
    selective-checkpoint policy function given as it is; None for full
    remat. Another name raises ``ValueError``."""
    if policy is None:
        return None
    if isinstance(policy, str):
        if policy not in _SAVED_OPS:
            raise ValueError(f"remat_policy={policy!r} — valid: "
                             f"{sorted(_SAVED_OPS)} or None")
        saved = {getattr(torch.ops.aten, op).default
                 for op in _SAVED_OPS[policy]}

        def policy_fn(ctx, op, *args, **kwargs):
            return (_ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                    else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    else:
        policy_fn = policy
    return lambda: _ckpt.create_selective_checkpoint_contexts(policy_fn)


def recompute(function, *args, **kwargs) -> Any:
    """Run ``function(*args, **kwargs)`` without keeping its interior
    activations; ``backward()`` recomputes them.

    * ``function`` a module (a decoder layer, the common case): it runs
      under non-reentrant checkpointing, its parameters getting gradients
      as usual, with ``policy`` (see :func:`remat_policy`).
    * A plain callable runs as it is, un-rematted, as the reference runs one
      on its eager tape; so does anything under ``torch.no_grad()``.

    ``use_reentrant`` and ``preserve_rng_state`` are accepted for API
    parity: there is one path, and the streams are always replayed. Under
    AMP the inputs pass through the cast hook as the reference's
    ``recompute`` op (O2 casts them to the low dtype)."""
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    policy = kwargs.pop("policy", None)
    context_fn = remat_policy(policy)
    if not isinstance(function, nn.Module) or not torch.is_grad_enabled():
        return function(*args, **kwargs)
    args = amp_cast("recompute", *args)
    amp = amp_state()
    saved = {}

    def body(*a):
        if "rng" not in saved:                  # the forward
            saved["rng"] = prandom.capture()
            with amp_state_scope(amp):
                return function(*a, **kwargs)
        with prandom.replay(saved["rng"]), amp_state_scope(amp):
            return function(*a, **kwargs)

    extra = {} if context_fn is None else {"context_fn": context_fn}
    return _ckpt.checkpoint(body, *args, use_reentrant=False,
                            preserve_rng_state=True, **extra)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a sequence in ``segments`` chunks (reference :626):
    ``functions`` is a module whose children are chained, or a list of
    modules and callables; ``args`` feed the first chunk, later chunks take
    the one output of the chunk before."""
    segments = (ctx.get("segments", 1) if isinstance(ctx, dict)
                else int(ctx or 1))
    links = (list(functions.children()) if isinstance(functions, nn.Module)
             else list(functions))
    if not links:
        return functions(*args, **kwargs)
    per = max(1, len(links) // max(1, segments))
    out = args
    for i in range(0, len(links), per):
        out = (recompute(_Chain(links[i:i + per]), *out, **kwargs),)
    return out[0]


class _Chain(nn.Module):
    """Modules and callables in a row; the first takes every input."""

    def __init__(self, links):
        super().__init__()
        self._mods = nn.ModuleList([m for m in links
                                    if isinstance(m, nn.Module)])
        self._chain = links

    def forward(self, *args, **kwargs):
        x = self._chain[0](*args, **kwargs)
        for link in self._chain[1:]:
            x = link(x)
        return x
