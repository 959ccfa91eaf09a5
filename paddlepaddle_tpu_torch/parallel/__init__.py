"""Parallel layers of the port (counterpart of ``paddlepaddle_tpu/parallel``):
the MoE layer. Expert-parallel placement is not ported yet."""
