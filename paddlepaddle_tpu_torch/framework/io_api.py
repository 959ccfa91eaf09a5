"""``save`` / ``load`` (counterpart of
``paddlepaddle_tpu/framework/io_api.py`` :1-62; reference
python/paddle/framework/io.py:773).

A nested ``dict`` / ``list`` / ``tuple`` of tensors and plain values is
pickled; each tensor leaf becomes a :class:`_TensorPayload` holding a numpy
array, ``stop_gradient`` and ``name``, as in the JAX package. The two
packages read each other's files:

* the payload is written under the JAX package's class path
  (``paddlepaddle_tpu.framework.io_api._TensorPayload``), so that
  package's ``load`` rebuilds its own payload from a file written here;
  nothing of that package is imported to do so (the opcodes naming the
  class are written by hand, :class:`_Pickler`);
* ``load`` maps that path back to the class here (:class:`_Unpickler`).

f32, f16, integer and bool leaves cross over both ways. bf16 has no numpy
dtype without ``ml_dtypes``, which the port does not need: a bf16 leaf of
this package is written as its 16-bit words (numpy ``'<V2'``, as
:mod:`..distributed.checkpoint` writes them) and read back as
``torch.bfloat16``; a JAX-package file's ``ml_dtypes.bfloat16`` leaf is
read as the same 16-bit words into ``torch.bfloat16``, with or without
``ml_dtypes`` installed. ``return_numpy=True`` refuses a bf16 leaf, naming
the dtype: numpy cannot hold it.

``load`` gives tensors on ``device=`` (``cuda`` by default; it raises
without CUDA unless ``"cpu"`` is given, as every entry point does).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device

# the JAX package's class path of the payload (its files name it)
_REF_MODULE = "paddlepaddle_tpu.framework.io_api"
_PAYLOAD = "_TensorPayload"
_BF16_WORDS = np.dtype("V2")


class _TensorPayload:
    __slots__ = ("array", "stop_gradient", "name")

    def __init__(self, array, stop_gradient, name):
        self.array = array
        self.stop_gradient = stop_gradient
        self.name = name


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(_host_array(obj), not obj.requires_grad,
                              getattr(obj, "name", None))
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, naming :class:`_TensorPayload` by the JAX
    package's path (the C pickler would import that path to check it)."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_REF_MODULE)
            self.save(_PAYLOAD)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_REF_MODULE}\n{_PAYLOAD}\n"
                       .encode("utf-8"))
        self.memoize(obj)


# -- reading ml_dtypes.bfloat16 arrays without ml_dtypes ---------------------

class _Bf16Scalar:
    """What ``ml_dtypes.bfloat16`` unpickles to here."""


class _Bf16Dtype:
    """What ``numpy.dtype(ml_dtypes.bfloat16, ...)`` unpickles to here."""

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=False):
    if obj is _Bf16Scalar:
        return _Bf16Dtype()
    return np.dtype(obj, align, copy)


class _Words(np.ndarray):
    """An unpickled array; a bf16 one keeps its 16-bit words as ``int16``
    and says so (``bf16``)."""

    bf16 = False

    def __setstate__(self, state):
        ver, shape, dt, is_f, raw = state
        if isinstance(dt, _Bf16Dtype):
            self.bf16 = True
            dt = np.dtype("<i2")
        super().__setstate__((ver, shape, dt, is_f, raw))


def _reconstruct(cls, shape, dtype):
    return np.ndarray.__new__(_Words if cls is np.ndarray else cls, shape,
                              dtype)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _REF_MODULE and name == _PAYLOAD:
            return _TensorPayload
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return _reconstruct
        if module == "numpy" and name == "dtype":
            return _dtype
        if module.split(".")[0] == "ml_dtypes":
            if name == "bfloat16":
                return _Bf16Scalar
            raise pickle.UnpicklingError(
                f"{module}.{name}: this dtype has no torch counterpart the "
                "port reads")
        return super().find_class(module, name)


def _leaf(arr, stop_gradient, return_numpy, device):
    """One loaded array: numpy (``return_numpy``) or a tensor on
    ``device`` (a torch tensor has no settable ``name``: it is dropped)."""
    bf16 = getattr(arr, "bf16", False) or (
        isinstance(arr, np.ndarray) and arr.dtype == _BF16_WORDS)
    if isinstance(arr, np.ndarray):
        arr = arr.view(np.ndarray)
    if return_numpy:
        if bf16:
            raise TypeError("a bfloat16 leaf has no numpy dtype here; load "
                            "it without return_numpy to get a "
                            "torch.bfloat16 tensor")
        return arr
    if bf16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    t = t.to(device)
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def _to_device(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        return _leaf(obj.array, obj.stop_gradient, return_numpy, device)
    if isinstance(obj, dict):
        return {k: _to_device(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, return_numpy, device) for v in obj)
    if isinstance(obj, _Words):
        return obj.view(np.ndarray)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_host(obj))


def load(path, return_numpy=False, device=None, **configs):
    """The object ``path`` holds; tensor leaves on ``device`` (``cuda`` by
    default), or numpy arrays with ``return_numpy=True``."""
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _to_device(obj, return_numpy, dev)
