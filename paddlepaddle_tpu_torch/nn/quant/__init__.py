"""nn.quant subset of the port: the weight-only int8 serving surface
(counterpart of ``paddlepaddle_tpu/nn/quant/__init__.py``).

``quantize_param_tree`` + :class:`~.qweight.QuantizedWeight` are what
``BatchDecodeEngine(quant="weight_only_int8")`` uses, through
:func:`~.quantized_linear.quantized_view`, to read int8 weights in prefill
and decode. ``llm_int8_linear``, the stubs, the functional layers and the
quanter factories are not ported (ROADMAP A11).
"""

from .quantized_linear import (  # noqa: F401
    WeightOnlyLinear,
    quantize_param_tree,
    quantized_view,
    weight_dequantize,
    weight_only_linear,
    weight_quantize,
)
from .qweight import QuantizedWeight  # noqa: F401

__all__ = [
    "weight_only_linear",
    "weight_quantize",
    "weight_dequantize",
]
