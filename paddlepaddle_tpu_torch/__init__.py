"""paddlepaddle_tpu_torch — the PyTorch/CUDA port of ``paddlepaddle_tpu``.

A second package beside the JAX one, written for one NVIDIA Hopper card
(H100, ``sm_90a``). It mirrors the JAX package's layout so each module has
an obvious counterpart, and it is held against that package by parity tests
on the CPU (``tests/test_torch_*.py``). The JAX package stays the reference;
this package imports neither ``jax`` nor anything of ``paddlepaddle_tpu``.

Three slices are ported, two of the flagship Llama decoder and one of the
MoE decoder:

* serving: ``LlamaForCausalLM`` behind ``ServingEngine`` ->
  ``BatchDecodeEngine`` with a paged KV pool, every decode-step attention
  going through a hand-written CUDA kernel
  (``ops/kernels/csrc/paged_attention.cu``);
* training: ``TrainStep`` (forward, next-token loss, backward,
  ``ClipGradByGlobalNorm`` and an ``AdamW`` update with f32 masters), the
  attention forward and backward going through hand-written CUDA kernels
  (``ops/kernels/csrc/flash_attention.cu``);
* the MoE decoder: ``MoEForCausalLM`` over ``MoELayer`` (dispatch modes
  sorted, fused, dropless, einsum) trained by the same ``TrainStep``; in
  the fused mode every expert FFN forward goes through a hand-written CUDA
  gather-GEMM kernel (``ops/kernels/csrc/gather_gemm.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA and no device given they raise (:mod:`.device`).
"""

from __future__ import annotations

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
from .inference.decode_engine import BatchDecodeEngine  # noqa: F401
from .inference.serving import (  # noqa: F401
    GenerationRequest,
    GenerationResult,
    ServingEngine,
    slo_summary,
)
from .jit.train import TrainStep  # noqa: F401
from .models.llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .models.moe import MoEConfig, MoEForCausalLM  # noqa: F401
from .nn.clip import ClipGradByGlobalNorm  # noqa: F401
from .optimizer import Adam, AdamW, lr  # noqa: F401
from .parallel.moe import MoELayer  # noqa: F401
