"""The single-process tensor-parallel engine on the card (``cuda`` marker;
skipped without CUDA). No JAX here: ``python -m pytest
tests/test_torch_tp_engine_card.py -m cuda --noconftest``.

This process calls ``BatchDecodeEngine(model, plan=decode_plan("mp2"))``
and is rank 0; the engine starts rank 1 on the same card over gloo groups
it owns. The kernel libraries are built here first, so the worker only
loads them.

* TP-2 decode of a 2-layer f32 Llama at head dim 128: the tokens equal the
  launcher form's (two ranks from ``spawn``), bit for bit; kernel 1 ran in
  both processes, layers x decode steps times each; 0 nvcc runs in the
  worker; the worker is gone after ``stop()``.
* A driver process SIGKILLed while it serves leaves no process behind:
  its worker exits, and ``nvidia-smi`` lists neither.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    from paddlepaddle_tpu_torch.ops.kernels import _build

    _build.build_all(["paged_attention"])


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 1024, (int(n),)).astype(np.int32)
            for n in (40, 129, 77)]


def _alive(pid):
    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except (ProcessLookupError, OSError):
        return False


def _gone(pids, timeout=15.0):
    deadline = time.monotonic() + timeout
    while any(_alive(p) for p in pids):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.1)
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout
    listed = {int(x) for x in out.split() if x.strip().isdigit()}
    return not (set(pids) & listed)


def test_single_process_mp2_equals_spmd_with_kernel_1_in_both_processes():
    _card()
    import torch_dist_workers as W

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import decode_plan, spawn
    from paddlepaddle_tpu_torch.inference.serving import GenerationRequest

    spmd = spawn(W.card_decode_session,
                 args=("float32", "gloo", "mp2", _prompts(), 20),
                 nprocs=2, timeout=600, pg_timeout=300)[0]
    model = pt.LlamaForCausalLM(pt.LlamaConfig(**dict(W.CARD,
                                                      dtype="float32")),
                                seed=0)
    eng = pt.BatchDecodeEngine(model, max_slots=4, chunk=8, page_size=64,
                               max_len=512, plan=decode_plan("mp2"))
    assert eng.kernel == "cuda" and eng.mesh_info()["backend"] == "gloo"
    eng._rank_counters(reset=True)
    reqs = [GenerationRequest(p, 20) for p in _prompts()]
    eng.serve(reqs, timeout=600)
    counters = eng._rank_counters()
    pids = eng._tp.pids
    eng.stop()
    for r, want in zip(reqs, spmd["tokens"]):
        np.testing.assert_array_equal(r.result.result(5), want)
    L = W.CARD["num_hidden_layers"]
    assert len({c["pid"] for c in counters}) == 2
    for c in counters:
        assert c["decode_steps"] > 0
        assert c["paged_attention"] == L * c["decode_steps"]
    assert counters[1]["nvcc_runs"] == 0
    assert _gone(pids)


_DRIVER = r"""
import json, sys
import numpy as np
import paddlepaddle_tpu_torch as pt
cfg = pt.LlamaConfig(**json.loads(sys.argv[1]))
srv = pt.ServingEngine(pt.LlamaForCausalLM(cfg, seed=0), max_batch_size=2,
                       decode_chunk=8, kv_page_size=64, max_len=512,
                       mesh="mp2")
srv.start()
print(json.dumps(srv.health()["mesh"]["worker_pids"]), flush=True)
while True:
    srv.generate(np.arange(64, dtype=np.int32), max_new_tokens=64,
                 timeout=120)
    print("served", flush=True)
"""


def test_a_sigkilled_driver_leaves_no_process_on_the_card():
    _card()
    import torch_dist_workers as W

    proc = subprocess.Popen(
        [sys.executable, "-c", _DRIVER,
         json.dumps(dict(W.CARD, dtype="bfloat16"))],
        cwd=os.path.dirname(HERE), stdout=subprocess.PIPE, text=True)
    try:
        pids = json.loads(proc.stdout.readline())
        assert proc.stdout.readline().strip() == "served"
        proc.kill()
        proc.wait(30)
        assert _gone(pids + [proc.pid]), pids
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
