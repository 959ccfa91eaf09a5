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
import paddlepaddle_tpu_torch.ops.kernels.flash_varlen
import paddlepaddle_tpu_torch.core.random
import paddlepaddle_tpu_torch.nn.long_tail
import paddlepaddle_tpu_torch.incubate.nn.functional
import paddlepaddle_tpu_torch.parallel.moe
import paddlepaddle_tpu_torch.models.moe
import paddlepaddle_tpu_torch.optimizer.lr
import paddlepaddle_tpu_torch.inference.kv_pool
import paddlepaddle_tpu_torch.inference.speculative
import paddlepaddle_tpu_torch.nn.quant
import paddlepaddle_tpu_torch.resilience.preemption
import paddlepaddle_tpu_torch.amp
import paddlepaddle_tpu_torch.amp.amp_lists
import paddlepaddle_tpu_torch.amp.grad_scaler
import paddlepaddle_tpu_torch.regularizer
import paddlepaddle_tpu_torch.nn.loss
import paddlepaddle_tpu_torch.nn.common
import paddlepaddle_tpu_torch.nn.norm
import paddlepaddle_tpu_torch.optimizer.optimizers
import paddlepaddle_tpu_torch.distributed
import paddlepaddle_tpu_torch.distributed.fleet.recompute
import paddlepaddle_tpu_torch.distributed.collective
import paddlepaddle_tpu_torch.distributed.communication.stream
import paddlepaddle_tpu_torch.distributed.env
import paddlepaddle_tpu_torch.distributed.host_collectives
import paddlepaddle_tpu_torch.distributed.launch
import paddlepaddle_tpu_torch.distributed.mesh
import paddlepaddle_tpu_torch.distributed.parallel
import paddlepaddle_tpu_torch.distributed.placement
import paddlepaddle_tpu_torch.distributed.shard_plan
import paddlepaddle_tpu_torch.distributed.store
import paddlepaddle_tpu_torch.parallel.mpu
import paddlepaddle_tpu_torch.parallel.sharded
import paddlepaddle_tpu_torch.parallel.schedules
import paddlepaddle_tpu_torch.parallel.pipeline
import paddlepaddle_tpu_torch.parallel.pipeline_spmd
import paddlepaddle_tpu_torch.parallel.hybrid
import paddlepaddle_tpu_torch.inference.compile_plan
import paddlepaddle_tpu_torch.observability
import paddlepaddle_tpu_torch.observability.exporter
import paddlepaddle_tpu_torch.observability.flight
import paddlepaddle_tpu_torch.observability.goodput
import paddlepaddle_tpu_torch.observability.memledger
import paddlepaddle_tpu_torch.observability.metrics
import paddlepaddle_tpu_torch.observability.perf
import paddlepaddle_tpu_torch.observability.perf.costs
import paddlepaddle_tpu_torch.observability.perf.device
import paddlepaddle_tpu_torch.observability.perf.steptime
import paddlepaddle_tpu_torch.observability.profiler
import paddlepaddle_tpu_torch.observability.recorder
import paddlepaddle_tpu_torch.observability.reqtrace
import paddlepaddle_tpu_torch.observability.watchdog
import paddlepaddle_tpu_torch.observability.tsdb
import paddlepaddle_tpu_torch.observability.alerts
import paddlepaddle_tpu_torch.inference
import paddlepaddle_tpu_torch.inference.robustness
import paddlepaddle_tpu_torch.inference.router
import paddlepaddle_tpu_torch.inference.fleet
import paddlepaddle_tpu_torch.inference.remote_replica
import paddlepaddle_tpu_torch.inference.replica_main
import paddlepaddle_tpu_torch.inference.tp_worker
import paddlepaddle_tpu_torch.distributed.worker_ranks
import paddlepaddle_tpu_torch.distributed.ship
import paddlepaddle_tpu_torch.inference.c_api_server
import paddlepaddle_tpu_torch.resilience
import paddlepaddle_tpu_torch.resilience.chaos
import paddlepaddle_tpu_torch.resilience.retry
import paddlepaddle_tpu_torch.resilience.netchaos
import paddlepaddle_tpu_torch.distributed.checkpoint
import paddlepaddle_tpu_torch.distributed.comm_task
import paddlepaddle_tpu_torch.distributed.watchdog
import paddlepaddle_tpu_torch.distributed.rpc
import paddlepaddle_tpu_torch.distributed.utils
import paddlepaddle_tpu_torch.distributed.fleet
import paddlepaddle_tpu_torch.distributed.fleet.topology
import paddlepaddle_tpu_torch.distributed.fleet.random
import paddlepaddle_tpu_torch.distributed.fleet.localsgd
import paddlepaddle_tpu_torch.distributed.fleet.data_generator
import paddlepaddle_tpu_torch.distributed.fleet.base
import paddlepaddle_tpu_torch.distributed.fleet.base.role_maker
import paddlepaddle_tpu_torch.distributed.fleet.meta_optimizers
import paddlepaddle_tpu_torch.distributed.fleet.meta_optimizers.dygraph_optimizer
import paddlepaddle_tpu_torch.distributed.fleet.meta_parallel
import paddlepaddle_tpu_torch.distributed.fleet.utils
import paddlepaddle_tpu_torch.resilience.integrity
import paddlepaddle_tpu_torch.framework
import paddlepaddle_tpu_torch.framework.io_api
import paddlepaddle_tpu_torch.io
import paddlepaddle_tpu_torch.io.dataset
import paddlepaddle_tpu_torch.io.sampler
import paddlepaddle_tpu_torch.io.dataloader
import paddlepaddle_tpu_torch.distributed.compat
import paddlepaddle_tpu_torch.distributed.auto_tuner
import paddlepaddle_tpu_torch.distributed.fleet.elastic
import paddlepaddle_tpu_torch.observability.aggregate
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
            ("linear", lambda: pt.nn.Linear(4, 3)),
            ("embedding", lambda: pt.nn.Embedding(4, 3)),
            ("rms_norm", lambda: pt.nn.RMSNorm(4)),
            ("engine", lambda: pt.BatchDecodeEngine(
                pt.LlamaForCausalLM(cfg, device="cpu"))),
            ("engine_int8", lambda: pt.BatchDecodeEngine(
                pt.LlamaForCausalLM(cfg, device="cpu"), kv_quant="int8",
                kv_host_bytes=1 << 20)),
            ("serving", lambda: pt.ServingEngine(
                pt.LlamaForCausalLM(cfg, device="cpu"))),
            ("replica_main", lambda: paddlepaddle_tpu_torch.inference
             .replica_main.main(["--port", "0"])),
            ("train_step", lambda: pt.TrainStep(
                pt.LlamaForCausalLM(cfg, device="cpu"), pt.AdamW(),
                lambda m, ids, labels: m(ids, labels=labels))),
            ("dataloader", lambda: pt.io.DataLoader(
                pt.io.TensorDataset([__import__("numpy").zeros((4, 2))]),
                batch_size=2)),
            ("load", lambda: pt.load("never_opened.pd"))):
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
                "ops.kernels.paged_attention", "inference.kv_pool",
                "inference.speculative",
                "core.flags", "parallel.moe", "models.moe",
                "ops.kernels.flash_varlen", "core.random", "nn.long_tail",
                "incubate.nn.functional", "amp", "amp.amp_lists",
                "amp.grad_scaler", "regularizer", "nn.loss", "nn.common",
                "nn.norm", "distributed", "distributed.fleet.recompute",
                "inference.compile_plan", "observability",
                "observability.exporter", "observability.flight",
                "observability.goodput", "observability.memledger",
                "observability.metrics", "observability.perf",
                "observability.perf.costs", "observability.perf.device",
                "observability.perf.steptime", "observability.profiler",
                "observability.recorder", "observability.reqtrace",
                "observability.watchdog", "observability.tsdb",
                "observability.alerts", "inference.router",
                "inference.fleet", "inference.remote_replica",
                "inference.replica_main", "inference.c_api_server",
                "resilience.chaos", "resilience.retry",
                "resilience.netchaos", "parallel.schedules",
                "parallel.pipeline", "parallel.pipeline_spmd",
                "parallel.hybrid",
                # A10 slice 6: the checkpoint, integrity, the watchdog,
                # rpc and the collective fleet
                "distributed.checkpoint",
                "distributed.comm_task",
                "distributed.watchdog",
                "distributed.rpc",
                "distributed.utils",
                "distributed.fleet",
                "distributed.fleet.topology",
                "distributed.fleet.random",
                "distributed.fleet.localsgd",
                "distributed.fleet.data_generator",
                "distributed.fleet.base",
                "distributed.fleet.base.role_maker",
                "distributed.fleet.meta_optimizers",
                "distributed.fleet.meta_optimizers.dygraph_optimizer",
                "distributed.fleet.meta_parallel",
                "distributed.fleet.utils",
                "resilience.integrity",
                "resilience.preemption",
                # A10 slice 7 and the input pipeline
                "framework", "framework.io_api", "io", "io.dataset",
                "io.sampler", "io.dataloader", "distributed.compat",
                "distributed.auto_tuner", "distributed.fleet.elastic",
                "observability.aggregate"):
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
