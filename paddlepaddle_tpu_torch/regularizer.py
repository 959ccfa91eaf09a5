"""``paddle.regularizer``: the weight-decay objects an optimizer takes as
``weight_decay=`` (counterpart of ``paddlepaddle_tpu/regularizer.py``). A
coupled optimizer folds the decay into the gradient: ``L2Decay`` (or a plain
float) adds ``coeff * w``, ``L1Decay`` adds ``coeff * sign(w)``
(:meth:`..optimizer.optimizer.Optimizer._decay_term`)."""

from __future__ import annotations


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    def __float__(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """|w| penalty: grad += coeff * sign(w)."""


class L2Decay(WeightDecayRegularizer):
    """0.5*coeff*||w||^2 penalty: grad += coeff * w (the optimizer default)."""
