"""The replica wire of the port (``inference/c_api_server.py``,
``inference/remote_replica.py``, ``inference/replica_main.py``,
``resilience/netchaos.py``) held against the JAX package's.

The frames are the reference's, so each side talks to the other:

* in one process: the port's ``RemoteReplicaClient`` against the
  reference's ``CApiServer`` over a JAX engine, the reference's client
  against the port's server over a port engine, each giving the tokens of
  an in-process engine; the health and metrics frames; CRC-armed frames
  and the idempotent resubmit ring; ``NetChaosProxy`` corrupting a
  CRC-armed stream into a typed ``WireCorruptionError``;
* the native client, ``native/libpaddle_inference_c.so`` (built with g++
  into a temporary directory when the checkout has no copy), running one
  predictor call through the port's server;
* three replica processes: the port's client against the reference's
  ``replica_main``; the reference's client against the port's
  ``replica_main --device cpu``; and a supervised port replica SIGKILLed
  mid-stream under a router, which fails over, respawns and answers
  health over the wire with its kernel block.

No timing assertion; every wait has its own limit.
"""

import ctypes
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.inference import c_api_server as jcapi
from paddlepaddle_tpu.inference import remote_replica as jrr
from paddlepaddle_tpu.inference.serving import ServingEngine as JaxServing
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.inference import c_api_server as tcapi
from paddlepaddle_tpu_torch.inference import remote_replica as trr
from paddlepaddle_tpu_torch.inference import replica_main as tmain
from paddlepaddle_tpu_torch.inference import robustness as trob
from paddlepaddle_tpu_torch.inference.router import ServingRouter
from paddlepaddle_tpu_torch.inference.serving import ServingEngine
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.resilience.netchaos import NetChaosProxy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120
_PROBE = 0.1      # the router's health-probe interval in the SIGKILL case
# the replica processes' engine settings (replica_main's defaults)
SERVE = dict(max_batch_size=2, decode_chunk=4, kv_page_size=16)
TINY = dict(tmain.PRESETS["tiny"], dtype="float32")


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 128, (n,)).astype(np.int32) for n in (6, 19, 33)]


@pytest.fixture(scope="module")
def models():
    """The replica processes' models, built here the same way: the
    reference's from ``paddle.seed(0)``, the port's from seed 0; plus a
    port copy of the reference's weights."""
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**TINY))
    pt.seed(0)
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu", seed=0)
    tj = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    convert.load_jax_state(
        tj, {k: np.asarray(v) for k, v in jm.functional_state().items()})
    return {"jax": jm, "port": tm, "port_of_jax": tj}


def _tokens(engine, prompts, budget=6):
    try:
        return [np.asarray(engine.generate(p, max_new_tokens=budget,
                                           timeout=WAIT)) for p in prompts]
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def want(models):
    return {"jax": _tokens(JaxServing(models["jax"], **SERVE), _prompts()),
            "port": _tokens(ServingEngine(models["port"], device="cpu",
                                          **SERVE), _prompts())}


def _check(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


# -- in one process: each package's client against the other's server --------

def test_port_client_against_reference_server(models, want):
    eng = JaxServing(models["jax"], **SERVE)
    srv = jcapi.CApiServer(None, port=0, engine=eng,
                           health_fn=eng.health).start()
    try:
        cli = trr.RemoteReplicaClient(address=srv.port, name="ref")
        cli.start()
        _check([cli.submit(p, max_new_tokens=6).result(WAIT)
                for p in _prompts()], want["jax"])
        with pytest.raises(trob.RequestValidationError):
            cli.submit(np.arange(4, dtype=np.int32), max_new_tokens=0)
        assert cli.health()["ok"] is True
    finally:
        srv.stop()
        eng.stop()


def test_reference_client_against_port_server(models, want):
    """The port server over a port engine that holds the reference's
    weights answers the reference's client with the reference's tokens,
    stamps and typed errors."""
    eng = ServingEngine(models["port_of_jax"], device="cpu", **SERVE)
    srv = tcapi.CApiServer(None, port=0, engine=eng,
                           health_fn=eng.health).start()
    try:
        cli = jrr.RemoteReplicaClient(address=srv.port, name="port")
        cli.start()
        futs = [cli.submit(p, max_new_tokens=6) for p in _prompts()]
        _check([f.result(WAIT) for f in futs], want["jax"])
        assert all(f.slo()["new_tokens"] == 6 for f in futs)
        assert all(f.slo()["ttft_s"] is not None for f in futs)
        from paddlepaddle_tpu.inference.robustness import \
            RequestValidationError as JValidation

        with pytest.raises(JValidation):
            cli.submit(np.zeros(4096, dtype=np.int32), max_new_tokens=4)
        assert cli.drain(5.0)["clean"] is True
    finally:
        srv.stop()
        eng.stop()


def _raw(port, payload):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(struct.pack("<Q", len(payload)) + payload)
        (n,) = struct.unpack("<Q", trr._recv_exact(s, 8))
        return trr._recv_exact(s, n)


def test_health_metrics_and_malformed_frames_match_reference(models):
    """Health and metrics frames carry the same shape from both servers;
    a truncated frame gets the same error frame and a close."""
    from paddlepaddle_tpu_torch import observability as tobs

    eng = ServingEngine(models["port"], device="cpu", **SERVE)
    servers = [tcapi.CApiServer(None, port=0, engine=eng,
                                health_fn=eng.health).start(),
               jcapi.CApiServer(None, port=0, health_fn=lambda: {
                   "state": "serving", "ok": True}).start()]
    tobs.enable(trace=False, metrics=True, watchdog_=False)
    try:
        eng.generate(_prompts()[0], max_new_tokens=2, timeout=WAIT)
        replies = {}
        for name, srv in zip(("port", "jax"), servers):
            h = _raw(srv.port, struct.pack("<IB", tcapi._MAGIC,
                                           tcapi._OP_HEALTH))
            m = _raw(srv.port, struct.pack("<IB", tcapi._MAGIC,
                                           tcapi._OP_METRICS))
            bad = _raw(srv.port, struct.pack("<I", tcapi._MAGIC))
            replies[name] = (h, m, bad)
        for name in ("port", "jax"):
            h, m, bad = replies[name]
            assert h[:5] == struct.pack("<IB", tcapi._MAGIC, 0)
            assert m[:5] == struct.pack("<IB", tcapi._MAGIC, 0)
            assert json.loads(h[9:])["ok"] is True
        assert replies["port"][2] == replies["jax"][2]
        text = replies["port"][1][9:].decode()
        assert "paddle_serving_requests_total" in text
        health = json.loads(replies["port"][0][9:])
        assert set(health) >= {"state", "ok", "pages_free", "est_wait_s",
                               "breaker", "kv", "goodput"}
    finally:
        tobs.disable()
        tobs.reset()
        for srv in servers:
            srv.stop()
        eng.stop()


def test_crc_frames_and_idempotent_resubmit(models, want):
    eng = ServingEngine(models["port"], device="cpu", **SERVE)
    srv = tcapi.CApiServer(None, port=0, engine=eng,
                           health_fn=eng.health).start()
    try:
        cli = trr.RemoteReplicaClient(address=srv.port, name="crc", crc=True)
        p = _prompts()[1]
        first = cli.submit(p, max_new_tokens=6, req_uid="uid-1").result(WAIT)
        again = cli.submit(p, max_new_tokens=6, req_uid="uid-1").result(WAIT)
        _check([first, again], want["port"][1:2] * 2)
        assert srv._results.replays == 1
        assert eng.stats["requests"] == 1          # decoded once
    finally:
        srv.stop()
        eng.stop()


def test_netchaos_corruption_surfaces_typed_never_bad_tokens(models, want):
    eng = ServingEngine(models["port"], device="cpu", **SERVE)
    srv = tcapi.CApiServer(None, port=0, engine=eng,
                           health_fn=eng.health).start()
    try:
        with NetChaosProxy(srv.port, specs="down:delay:@9999",
                           seed=0) as px:
            cli = trr.RemoteReplicaClient(address=srv.port, name="nc")
            cli._nc_proxy = px
            _check([cli.submit(_prompts()[0], max_new_tokens=6)
                    .result(WAIT)], want["port"][:1])
            assert px.fire_counts() == {}
        with NetChaosProxy(srv.port, specs="down:corrupt:@2",
                           seed=3) as px:
            cli = trr.RemoteReplicaClient(address=srv.port, name="nc")
            cli._nc_proxy = px
            fut = cli.submit(_prompts()[0], max_new_tokens=6)
            with pytest.raises(trob.WireCorruptionError):
                fut.result(WAIT)
            assert px.fire_counts().get("down") == 1
    finally:
        srv.stop()
        eng.stop()


# -- the native client against the port's server -----------------------------

def _native_lib(tmp_path):
    src = os.path.join(_REPO, "native", "paddle_inference_c.cpp")
    lib = os.path.join(_REPO, "native", "libpaddle_inference_c.so")
    if not os.path.exists(lib) or os.path.getmtime(src) > os.path.getmtime(
            lib):
        if shutil.which("g++") is None:
            pytest.skip("no native client library and no g++ to build it")
        lib = str(tmp_path / "libpaddle_inference_c.so")
        subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", src,
                        "-o", lib], check=True, capture_output=True,
                       timeout=180)
    c = ctypes.CDLL(lib)
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    c.PD_ConfigCreate.restype = vp
    c.PD_ConfigSetModelDir.argtypes = [vp, ctypes.c_char_p]
    c.PD_PredictorCreate.restype = vp
    c.PD_PredictorCreate.argtypes = [vp]
    c.PD_PredictorGetInputNum.restype = sz
    c.PD_PredictorGetInputNum.argtypes = [vp]
    c.PD_PredictorGetInputHandle.restype = vp
    c.PD_PredictorGetInputHandle.argtypes = [vp, ctypes.c_char_p]
    c.PD_PredictorGetOutputHandle.restype = vp
    c.PD_PredictorGetOutputHandle.argtypes = [vp, ctypes.c_char_p]
    c.PD_TensorReshape.argtypes = [vp, sz, ctypes.POINTER(ctypes.c_int32)]
    c.PD_TensorCopyFromCpuFloat.argtypes = [vp,
                                            ctypes.POINTER(ctypes.c_float)]
    c.PD_TensorCopyToCpuFloat.argtypes = [vp, ctypes.POINTER(ctypes.c_float)]
    c.PD_TensorGetNumDims.restype = sz
    c.PD_TensorGetNumDims.argtypes = [vp]
    c.PD_TensorGetShape.argtypes = [vp, ctypes.POINTER(ctypes.c_int32)]
    c.PD_PredictorRun.restype = ctypes.c_int
    c.PD_PredictorRun.argtypes = [vp]
    c.PD_PredictorGetLastError.restype = ctypes.c_char_p
    c.PD_PredictorGetLastError.argtypes = [vp]
    c.PD_PredictorDestroy.argtypes = [vp]
    return c


class _LinearPredictor:
    """A predictor of the shape the predictor ops serve: a port Linear on
    the CPU, torch tensors out."""

    def __init__(self):
        import torch

        torch.manual_seed(0)
        self.lin = pt.nn.Linear(4, 3, device="cpu")

    def get_input_names(self):
        return ["input_0"]

    def get_output_names(self):
        return ["output_0"]

    def run(self, inputs):
        import torch

        with torch.no_grad():
            return [self.lin(torch.from_numpy(np.array(inputs[0])))]


def test_native_client_runs_a_predictor_through_the_port_server(tmp_path):
    lib = _native_lib(tmp_path)
    pred = _LinearPredictor()
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    want = pred.run([x])[0].numpy()
    sock = os.path.join(tempfile.mkdtemp(prefix="pdc-"), "pd.sock")
    with tcapi.CApiServer(pred, sock):
        cfg = lib.PD_ConfigCreate()
        lib.PD_ConfigSetModelDir(cfg, sock.encode())
        p = lib.PD_PredictorCreate(cfg)
        assert p, "native client failed to connect"
        try:
            assert lib.PD_PredictorGetInputNum(p) == 1
            h = lib.PD_PredictorGetInputHandle(p, b"input_0")
            lib.PD_TensorReshape(h, 2, (ctypes.c_int32 * 2)(2, 4))
            lib.PD_TensorCopyFromCpuFloat(
                h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            assert lib.PD_PredictorRun(p) == 1, \
                lib.PD_PredictorGetLastError(p)
            out_h = lib.PD_PredictorGetOutputHandle(p, b"output_0")
            nd = lib.PD_TensorGetNumDims(out_h)
            shape = (ctypes.c_int32 * nd)()
            lib.PD_TensorGetShape(out_h, shape)
            assert list(shape) == [2, 3]
            out = np.empty((2, 3), np.float32)
            lib.PD_TensorCopyToCpuFloat(
                out_h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            np.testing.assert_allclose(out, want, rtol=1e-6)
        finally:
            lib.PD_PredictorDestroy(p)
        # the same server answers health and metrics frames on the socket
        with socket.socket(socket.AF_UNIX) as s:
            s.settimeout(30)
            s.connect(sock)
            for op in (tcapi._OP_HEALTH, tcapi._OP_METRICS):
                trr._send_frame(s, struct.pack("<IB", tcapi._MAGIC, op))
                status, _c = trr._parse_reply(trr._recv_frame(s))
                assert status == tcapi._ST_OK
    shutil.rmtree(os.path.dirname(sock), ignore_errors=True)


# -- replica processes -------------------------------------------------------

def test_port_client_against_reference_replica_process(want):
    """The port's supervisor-free client dials a reference replica
    process (``python -m paddlepaddle_tpu.inference.replica_main``)."""
    sup = jrr.ReplicaSupervisor(preset="tiny", name="refproc",
                                warmup="off", ready_timeout_s=240.0)
    sup.start()
    try:
        cli = trr.RemoteReplicaClient(address=sup.address(), name="refproc",
                                      read_timeout_s=WAIT)
        cli.start()
        _check([cli.submit(p, max_new_tokens=6).result(WAIT)
                for p in _prompts()], want["jax"])
    finally:
        sup.stop(drain_timeout=5.0)


def test_reference_client_against_port_replica_process(want):
    """The reference's client dials the port's replica process on the
    CPU: the port's Llama from seed 0, the reference's frames, the
    ``REPLICA_READY`` line, and a health answer that carries the kernel
    block."""
    sup = trr.ReplicaSupervisor(preset="tiny", name="portproc",
                                warmup="off", ready_timeout_s=240.0,
                                extra_args=["--device", "cpu"])
    sup.start()
    proc = sup._proc
    try:
        assert sup.ready_info["pid"] == sup.pid()
        cli = jrr.RemoteReplicaClient(address=sup.address(),
                                      name="portproc", read_timeout_s=WAIT)
        cli.start()
        _check([cli.submit(p, max_new_tokens=6).result(WAIT)
                for p in _prompts()], want["port"])
        h = cli.health()
        assert h["ok"] is True
        assert h["kernels"] == {"paged_attention": 0,
                                "paged_attention_int8": 0, "nvcc_runs": 0}
    finally:
        sup.stop(drain_timeout=5.0)
    assert proc.wait(30) == 143                    # SIGTERM drained


def test_sigkill_mid_stream_fails_over_and_the_supervisor_respawns(want):
    """A router over one supervised port replica process and one
    in-process replica: the process is SIGKILLed while it streams; every
    request completes with the expected tokens (failover) or fails typed;
    the supervisor respawns the child, which serves again."""
    factory = trr.ProcessReplicaFactory(
        preset="tiny", warmup="off",
        supervisor_kw=dict(ready_timeout_s=240.0,
                           extra_args=["--device", "cpu"],
                           backoff=trr.RetryPolicy(max_attempts=4,
                                                   base_delay=0.05,
                                                   max_delay=0.2,
                                                   jitter=0.0)),
        client_kw=dict(read_timeout_s=WAIT))
    remote = factory(name="proc")
    local = lambda: ServingEngine(  # noqa: E731
        LlamaForCausalLM(LlamaConfig(**TINY), device="cpu", seed=0),
        device="cpu", **SERVE)
    router = ServingRouter([remote, local], probe_interval_s=_PROBE,
                           hedge_after_s=None)
    sup = remote.supervisor
    try:
        router.start()
        assert remote.health()["ok"] is True
        pid = sup.pid()
        prompts = _prompts() * 2
        futs = [router.submit(p, max_new_tokens=6) for p in prompts]
        os.kill(pid, signal.SIGKILL)
        got, errs = [], []
        for f, w in zip(futs, want["port"] * 2):
            try:
                got.append((f.result(WAIT), w))
            except trob.ServingError as e:
                errs.append(e)
        for g, w in got:
            np.testing.assert_array_equal(g, w)
        assert len(got) + len(errs) == len(futs)
        end = time.monotonic() + 240
        while (sup.pid() in (None, pid) or sup.state != "serving") \
                and time.monotonic() < end:
            time.sleep(0.1)
        assert sup.pid() not in (None, pid), sup.info()
        assert sup.stats["crashes"] == 1 and sup.stats["spawns"] == 2
        h = remote.health()
        assert h["ok"] and h["kernels"]["nvcc_runs"] == 0
        out = remote.submit(_prompts()[0], max_new_tokens=6).result(WAIT)
        np.testing.assert_array_equal(out, want["port"][0])
    finally:
        router.stop()

