"""The training step of the port (counterpart of ``paddlepaddle_tpu/jit``)."""

from .train import TrainStep  # noqa: F401
