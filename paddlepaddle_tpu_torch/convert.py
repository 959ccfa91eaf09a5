"""Carry weights from the JAX package into the port.

The JAX model's ``functional_state()`` (``paddlepaddle_tpu/nn/layer.py:328``),
handed over as ``{name: np.ndarray}``, maps onto the port's ``state_dict``
name for name: both packages use the same module tree
(``model.layers.<i>.self_attn.q_proj.weight`` ...), and the port's ``Linear``
keeps the paddle layout ``W: [in, out]``, so matrices copy across without a
transpose. This function is the one place that owns that layout decision.

The rope tables are SKIPPED: ``model.rope_cos`` / ``model.rope_sin`` of a
Llama, and ``rope_cos`` / ``rope_sin`` at the root of an ``MoEForCausalLM``
(``paddlepaddle_tpu/models/moe.py:114``). The port recomputes them from the
config (``models/llama.py`` ``rope_tables``) and keeps them out of its
state; the parity tests hold the two tables against each other instead.

:func:`load_jax_train_state` carries a JAX ``TrainStep``'s state
(``paddlepaddle_tpu/jit/train.py:142``: params, the optimizer's ``slots``,
``master`` and ``step``) into the port's ``TrainStep``, so that training
resumed in either package computes the same thing.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

SKIPPED = ("model.rope_cos", "model.rope_sin", "rope_cos", "rope_sin")


def _to_tensor(a) -> torch.Tensor:
    """numpy -> torch, including ml_dtypes bfloat16 arrays (reinterpreted
    bit for bit through int16, since numpy has no native bfloat16)."""
    a = np.asarray(a)
    a = np.ascontiguousarray(a).reshape(a.shape)   # keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def convert_state(jax_state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``functional_state()`` of a JAX ``LlamaForCausalLM`` or
    ``MoEForCausalLM`` (as numpy) ->
    the port model's ``state_dict`` (CPU tensors, dtypes kept)."""
    return {name: _to_tensor(arr) for name, arr in jax_state.items()
            if name not in SKIPPED}


def load_jax_state(model: torch.nn.Module,
                   jax_state: Mapping[str, np.ndarray]) -> None:
    """Copy converted weights into ``model`` (any device); every parameter
    must be covered and every shape must match (``strict=True``)."""
    model.load_state_dict(convert_state(jax_state), strict=True)


def load_jax_train_state(step, jax_state: Mapping[str, object]) -> None:
    """Load a JAX ``TrainStep.state_dict()`` into the port's
    :class:`~paddlepaddle_tpu_torch.jit.train.TrainStep` ``step``: params
    by name, the optimizer's per-parameter slots (``moment1``,
    ``moment2``, ``beta1_pow``, ``beta2_pow``[, ``moment2_max``]), the f32
    masters (None for parameters without one) and the step count."""
    opt = jax_state["opt_state"]

    def master(m) -> Optional[torch.Tensor]:
        return None if m is None else _to_tensor(m)

    step.set_state_dict({
        "params": convert_state(jax_state["params"]),
        "opt_state": {
            "slots": {name: {k: _to_tensor(v) for k, v in slots.items()}
                      for name, slots in opt["slots"].items()},
            "master": {name: master(m) for name, m in opt["master"].items()},
            "step": int(np.asarray(opt["step"])),
        },
    })
