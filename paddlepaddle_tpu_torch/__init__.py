"""paddlepaddle_tpu_torch — the PyTorch/CUDA port of ``paddlepaddle_tpu``.

A second package beside the JAX one, written for one NVIDIA Hopper card
(H100, ``sm_90a``). It mirrors the JAX package's layout so each module has
an obvious counterpart, and it is held against that package by parity tests
on the CPU (``tests/test_torch_*.py``). The JAX package stays the reference;
this package imports neither ``jax`` nor anything of ``paddlepaddle_tpu``.

These slices are ported: three of the flagship Llama decoder, one of the
MoE decoder and one of the rest of the model zoo:

* serving: ``LlamaForCausalLM`` behind ``ServingEngine`` ->
  ``BatchDecodeEngine`` with a paged KV pool, every decode-step attention
  going through a hand-written CUDA kernel
  (``ops/kernels/csrc/paged_attention.cu``); the engine also takes
  weight-only int8 weights (``quant=``, ``nn.quant``), the contiguous KV
  layout, speculative decoding, and the static scheduler over the model's
  ``generate_cached``, behind deadlines, cancellation, drain and a hang
  watchdog;
* serving's KV memory: shared-prefix hits (``submit(prefix_len=)``), int8
  KV pages (``kv_quant="int8"``, attended by the same kernel's int8
  variant) and a bounded host-RAM tier that spills and restores evicted
  prefixes (``kv_host_bytes``);
* training: ``TrainStep`` (forward, next-token loss, backward, a clip and
  an optimizer update with f32 masters), the attention forward and
  backward going through hand-written CUDA kernels
  (``ops/kernels/csrc/flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu`` in bf16
  and fp16, ``flash_attention.cu`` in f32); activation recompute
  (``LlamaConfig.recompute`` / ``remat_policy``,
  ``distributed.fleet.recompute``), AMP O1 / O2 (``amp.auto_cast``,
  ``amp.decorate``, ``amp.GradScaler``), the masked attention path
  (``attn_mask=``), ``F.cross_entropy`` and the loss layers, the
  reference's optimizers, LR schedulers, clips and regularizers;
* the MoE decoder: ``MoEForCausalLM`` over ``MoELayer`` (dispatch modes
  sorted, fused, dropless, einsum) trained by the same ``TrainStep``; in
  the fused mode every expert FFN forward goes through the hand-written CUDA
  gather-GEMM kernels (``ops/kernels/csrc/gather_gemm_sm90.cu`` in bf16,
  ``gather_gemm.cu`` in f32).

* the rest of the model zoo: ``ResNet`` (``models.resnet50`` & co., with
  ``Conv2D``, the pools and ``BatchNorm2D``, whose training backward is the
  reference's hand-written formula), ``BertForSequenceClassification``
  over ``nn.TransformerEncoder`` and ``GPTForCausalLM``, the last two on the
  flash kernels at head dim 64, all trained by the same ``TrainStep``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA and no device given they raise (:mod:`.device`).
"""

from __future__ import annotations

__version__ = "0.1.0"

from .core.flags import get_flags, set_flags  # noqa: F401
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
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
from .models.bert import (BertConfig,  # noqa: F401
                          BertForSequenceClassification)
from .models.gpt import GPTConfig, GPTForCausalLM  # noqa: F401
from .models.resnet import ResNet, resnet50  # noqa: F401
from . import models, nn  # noqa: F401
from . import amp, distributed, regularizer  # noqa: F401
from .nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                      ClipGradByValue)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, Lamb, Lars, Momentum, NAdam, RAdam, RMSProp,
                        lr)
from .parallel.moe import MoELayer  # noqa: F401
