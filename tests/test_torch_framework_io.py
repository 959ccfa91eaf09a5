"""The port's ``save`` / ``load`` (``paddlepaddle_tpu_torch/framework/
io_api.py``) against the JAX package's (``paddlepaddle_tpu/framework/
io_api.py``) on the CPU.

* Round trips of nested dicts, lists and tuples, tensors and plain values,
  with ``stop_gradient`` kept (as ``requires_grad``) and ``return_numpy``.
* Files cross over both ways for f32, f16, int and bool leaves: the JAX
  package's file loads in the port, the port's in the JAX package, each
  leaf bit-equal and of the same dtype.
* bf16: the port's own bf16 leaves come back as ``torch.bfloat16``; a JAX
  package file with an ``ml_dtypes`` bf16 leaf gives the same 16-bit words
  (a numpy oracle: the high half of each f32 value, exact for values that
  bf16 holds), and ``return_numpy`` refuses it naming the dtype.
* ``load`` defaults to ``cuda`` and raises without it.
"""

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu_torch as pt

DTYPES = ("float32", "float16", "int64", "int32", "bool")


def _array(dtype, shape=(3, 4), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype.startswith("int"):
        return rng.integers(-50, 50, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _nested(make):
    return {"w": make("float32", (2, 3), 1),
            "layers": [make("float16", (4,), 2),
                       (make("int64", (2, 2), 3), make("bool", (3,), 4))],
            "step": 7, "tag": "ckpt", "scale": 0.5,
            "meta": {"ids": make("int32", (5,), 5)}}


def _port_tensor(dtype, shape, seed):
    return torch.from_numpy(_array(dtype, shape, seed))


def _ref_tensor(dtype, shape, seed):
    return paddle.to_tensor(_array(dtype, shape, seed))


def _flat(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, obj


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _same(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = _as_np(fa[k]), _as_np(fb[k])
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), k
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


def test_round_trip_keeps_nesting_values_and_stop_gradient(tmp_path):
    obj = _nested(_port_tensor)
    obj["w"].requires_grad_(True)
    path = str(tmp_path / "sub" / "state.pd")
    pt.save(obj, path)
    back = pt.load(path, device="cpu")
    _same(back, obj)
    assert isinstance(back["layers"][1], tuple)
    assert back["w"].requires_grad and not back["layers"][0].requires_grad
    assert isinstance(back["w"], torch.Tensor) and back["w"].device.type == "cpu"
    as_np = pt.load(path, return_numpy=True)
    assert isinstance(as_np["w"], np.ndarray)
    _same(as_np, _nested(_array))


def test_a_reference_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "ref.pd")
    paddle.save(_nested(_ref_tensor), path)
    _same(pt.load(path, device="cpu"), _nested(_array))
    _same(pt.load(path, return_numpy=True), _nested(_array))


def test_a_port_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port.pd")
    obj = _nested(_port_tensor)
    obj["w"].requires_grad_(True)
    pt.save(obj, path)
    back = paddle.load(path)
    assert isinstance(back["w"], paddle.Tensor)
    assert back["w"].stop_gradient is False
    assert back["layers"][0].stop_gradient is True
    _same(back, _nested(_array))
    _same(paddle.load(path, return_numpy=True), _nested(_array))


@pytest.mark.parametrize("protocol", [2, 4])
def test_both_protocols_cross_over(tmp_path, protocol):
    path = str(tmp_path / f"p{protocol}.pd")
    pt.save({"x": _port_tensor("float32", (3,), 9)}, path, protocol=protocol)
    np.testing.assert_array_equal(paddle.load(path)["x"].numpy(),
                                  _array("float32", (3,), 9))


def _bf16_oracle(f32):
    """The 16-bit words of the bf16 values of ``f32`` (exact when f32 holds
    bf16 values: the high half of each word)."""
    return (f32.view(np.uint32) >> 16).astype(np.uint16)


def _bf16_exact(n=12):
    # f32 values with a zero low half: bf16 holds them exactly
    f = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    return (f.view(np.uint32) & 0xFFFF0000).view(np.float32)


def test_port_bf16_round_trips_as_bfloat16(tmp_path):
    f = _bf16_exact()
    path = str(tmp_path / "bf16.pd")
    pt.save({"b": torch.from_numpy(f).bfloat16()}, path)
    back = pt.load(path, device="cpu")["b"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.view(torch.int16).numpy()
                                  .view(np.uint16), _bf16_oracle(f))
    with pytest.raises(TypeError, match="bfloat16"):
        pt.load(path, return_numpy=True)


def test_reference_bf16_file_gives_the_same_words(tmp_path):
    f = _bf16_exact()
    path = str(tmp_path / "ref_bf16.pd")
    paddle.save({"b": paddle.to_tensor(f).astype("bfloat16"),
                 "f": paddle.to_tensor(f)}, path)
    back = pt.load(path, device="cpu")
    assert back["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["b"].view(torch.int16).numpy()
                                  .view(np.uint16), _bf16_oracle(f))
    np.testing.assert_array_equal(back["f"].numpy(), f)
    with pytest.raises(TypeError, match="bfloat16"):
        pt.load(path, return_numpy=True)


def test_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "x.pd")
    pt.save({"x": torch.ones(2)}, path)
    if torch.cuda.is_available():
        assert pt.load(path)["x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.load(path)
    assert pt.framework.seed is pt.seed
