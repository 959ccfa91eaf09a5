"""The port stands alone: ``paddlepaddle_tpu_torch`` and ``chip_smoke``
import no JAX and nothing of the JAX package, and its entry points refuse to
drift to the CPU when no device is given and there is no card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, sys
import paddlepaddle_tpu_torch as pt
import paddlepaddle_tpu_torch.convert
import paddlepaddle_tpu_torch.jit.train
import paddlepaddle_tpu_torch.nn.clip
import paddlepaddle_tpu_torch.ops.kernels.flash_attention
import paddlepaddle_tpu_torch.ops.kernels.gather_gemm
import paddlepaddle_tpu_torch.parallel.moe
import paddlepaddle_tpu_torch.models.moe
import paddlepaddle_tpu_torch.optimizer.lr
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "paddlepaddle_tpu" or m.startswith("paddlepaddle_tpu."))
ports = sorted(m for m in sys.modules if m.startswith("paddlepaddle_tpu_torch"))
import torch
errors = {}
if not torch.cuda.is_available():
    cfg = pt.LlamaConfig.tiny()
    for name, make in (
            ("model", lambda: pt.LlamaForCausalLM(cfg)),
            ("moe_model", lambda: pt.MoEForCausalLM(pt.MoEConfig.tiny())),
            ("moe_layer", lambda: pt.MoELayer(8, 16, 2)),
            ("engine", lambda: pt.BatchDecodeEngine(
                pt.LlamaForCausalLM(cfg, device="cpu"))),
            ("serving", lambda: pt.ServingEngine(
                pt.LlamaForCausalLM(cfg, device="cpu"))),
            ("train_step", lambda: pt.TrainStep(
                pt.LlamaForCausalLM(cfg, device="cpu"), pt.AdamW(),
                lambda m, ids, labels: m(ids, labels=labels)))):
        try:
            make()
            errors[name] = None
        except RuntimeError as e:
            errors[name] = str(e)
print(json.dumps({"bad": bad, "ports": ports, "errors": errors,
                  "cuda": torch.cuda.is_available()}))
"""


def _probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_jax_package():
    got = _probe()
    assert got["bad"] == []
    # the prefix trap: the port's own modules are named paddlepaddle_tpu_torch*
    assert "paddlepaddle_tpu_torch.inference.decode_engine" in got["ports"]
    for mod in ("jit.train", "optimizer.optimizers", "optimizer.lr", "nn.clip",
                "ops.kernels.flash_attention", "ops.kernels.gather_gemm",
                "parallel.moe", "models.moe"):
        assert f"paddlepaddle_tpu_torch.{mod}" in got["ports"], mod
    if got["cuda"]:
        pytest.skip("entry points legitimately default to the card here")
    for name, err in got["errors"].items():
        assert err is not None and "CUDA is not available" in err, name


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Run where the package is missing (chip_smoke.py alone): it must exit
    non-zero and print no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_resolve_device_rules():
    import torch

    from paddlepaddle_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(dev)
