"""AMP, mixed precision (counterpart of ``paddlepaddle_tpu/amp/``:
``auto_cast`` / ``amp_guard``, ``decorate``, ``is_*_supported``,
``GradScaler``).

The reference casts per op, by name: its dispatcher hands every op's inputs
and the op's name to one hook (``amp/__init__.py`` ``_hook``, run from
``core/dispatch.py``'s ``apply_op``). The port does the same, with its own
copy of the lists (:mod:`.amp_lists`) and thread-local state: each of the
port's entry points that carries a reference op name calls
:func:`amp_cast` with that name on its tensor inputs (``linear``,
``embedding``, ``rms_norm``, ``fused_rope``, ``flash_attention``,
``cross_entropy``, ``matmul``, ``moe_gate``, ``moe_ffn_*``, ``recompute``),
and the reference's unnamed ops on the train path (the tied LM head,
``swiglu``, the K/V head repeat) call it with ``None``:

* O1: a white-list op casts its floating inputs to the low dtype; a
  black-list op promotes bf16 / fp16 inputs to f32; every other op (an
  unnamed one too) is untouched.
* O2: a black-list op casts its floating inputs to f32, every other op to
  the low dtype.

``torch.autocast`` is not used: its op lists are not the reference's, they
differ between CPU and CUDA, and they take no custom lists by the
reference's names. Float64 inputs are never cast, as in the reference.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterable, Optional, Tuple

import torch

from ..core.dtype import to_torch_dtype
from .amp_lists import BLACK_LIST, WHITE_LIST
from .grad_scaler import GradScaler  # noqa: F401

_LOW = (torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = torch.bfloat16
        self.white = WHITE_LIST
        self.black = BLACK_LIST


_state = _AmpState()


def _cast(x, dtype: torch.dtype):
    if (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.dtype not in (dtype, torch.float64)):
        return x.to(dtype)
    return x


def amp_cast(op_name: Optional[str], *args) -> Tuple:
    """``args`` as the op ``op_name`` takes them under the current AMP state
    (the reference's ``_hook``): unchanged when AMP is off; non-tensors and
    non-floating tensors always unchanged. ``None`` is an unnamed op."""
    st = _state
    if not st.enabled:
        return args
    if st.level == "O1":
        if op_name in st.white:
            to = st.dtype
        elif op_name in st.black:
            return tuple(x.float() if isinstance(x, torch.Tensor)
                         and x.dtype in _LOW else x for x in args)
        else:
            return args
    else:
        to = torch.float32 if op_name in st.black else st.dtype
    return tuple(_cast(x, to) for x in args)


def amp_state() -> Tuple:
    """The calling thread's AMP state, to re-enter later with
    :func:`amp_state_scope` (activation recompute runs the forward again
    during ``backward()``, outside the ``auto_cast`` block)."""
    st = _state
    return (st.enabled, st.level, st.dtype, st.white, st.black)


@contextmanager
def amp_state_scope(state: Tuple):
    st = _state
    prev = amp_state()
    st.enabled, st.level, st.dtype, st.white, st.black = state
    try:
        yield
    finally:
        st.enabled, st.level, st.dtype, st.white, st.black = prev


@contextmanager
def auto_cast(enable=True, custom_white_list: Optional[Iterable[str]] = None,
              custom_black_list: Optional[Iterable[str]] = None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast`` (reference :68): the block's ops cast by
    name at ``level`` ("O1" or "O2") to ``dtype`` ("bfloat16" or
    "float16"). The custom lists add names for the block only; a name in
    both a white and a black list is white at O1 and black at O2, as in the
    reference. ``use_promote`` is accepted unread, as there."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be 'O0', 'O1' or 'O2', got {level!r}")
    low = to_torch_dtype(dtype)
    if low not in _LOW:
        raise ValueError(f"dtype must be bfloat16 or float16, got {dtype!r}")
    st = _state
    new = (bool(enable) and level != "O0", level, low,
           st.white | frozenset(custom_white_list or ()),
           st.black | frozenset(custom_black_list or ()))
    with amp_state_scope(new):
        yield


amp_guard = auto_cast


def is_bfloat16_supported(device=None) -> bool:
    return True


def is_float16_supported(device=None) -> bool:
    return True


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate`` (reference :101-117): at O2 every model's
    floating parameters and buffers are cast to ``dtype`` in place (the
    parameter objects stay, so an optimizer built on them keeps them) and
    each optimizer keeps f32 masters (``multi_precision``, or
    ``master_weight`` when given). O1 changes nothing. Returns what it was
    given, as the reference does. ``save_dtype`` is accepted unread."""
    low = to_torch_dtype(dtype)
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    if level == "O2":
        for m in model_list:
            m.to(dtype=low)
        if optimizers is not None:
            opts = (list(optimizers) if isinstance(optimizers, (list, tuple))
                    else [optimizers])
            for o in opts:
                o._multi_precision = (True if master_weight is None
                                      else master_weight)
    if optimizers is None:
        return models
    return models, optimizers
