"""Carry weights from the JAX package into the port.

The JAX model's ``functional_state()`` (``paddlepaddle_tpu/nn/layer.py:328``),
handed over as ``{name: np.ndarray}``, maps onto the port's ``state_dict``
name for name: both packages use the same module tree
(``model.layers.<i>.self_attn.q_proj.weight`` ...), and the port's ``Linear``
keeps the paddle layout ``W: [in, out]``, so matrices copy across without a
transpose. This function is the one place that owns that layout decision.

The rope tables (``model.rope_cos`` / ``model.rope_sin``) are SKIPPED: the
port recomputes them from the config (``models/llama.py`` ``rope_tables``)
and keeps them out of its state; the parity tests hold the two tables
against each other instead.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

SKIPPED = ("model.rope_cos", "model.rope_sin")


def _to_tensor(a) -> torch.Tensor:
    """numpy -> torch, including ml_dtypes bfloat16 arrays (reinterpreted
    bit for bit through int16, since numpy has no native bfloat16)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def convert_state(jax_state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``functional_state()`` of a JAX ``LlamaForCausalLM`` (as numpy) ->
    the port model's ``state_dict`` (CPU tensors, dtypes kept)."""
    return {name: _to_tensor(arr) for name, arr in jax_state.items()
            if name not in SKIPPED}


def load_jax_state(model: torch.nn.Module,
                   jax_state: Mapping[str, np.ndarray]) -> None:
    """Copy converted weights into ``model`` (any device); every parameter
    must be covered and every shape must match (``strict=True``)."""
    model.load_state_dict(convert_state(jax_state), strict=True)
