"""Cold start and observability on the card (``cuda`` marker; skipped
without CUDA): after ``warmup()`` the serve window captures and builds
nothing; an engine built with ``bundle=`` on an empty kernel build
directory runs no ``nvcc`` and serves the same tokens; ``/metrics`` and
``/mem`` scraped from the exporter while the card serves; a capture
survives the collector freeing a dead engine's graph. No JAX here, so
the file runs on a card host without it:
``python -m pytest tests/test_torch_observability_card.py -m cuda
--noconftest``.

The model is a 2-layer bf16 Llama at head dim 128 (hidden 512, 4 query and
2 KV heads), a shape the paged kernel takes; tokens are compared exactly
(the same kernels on the same card from the same seed).
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512, dtype="bfloat16")
ENGINE = dict(max_slots=4, max_len=512, page_size=64, chunk=8)
LENS = (40, 130, 300, 7)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _model():
    from paddlepaddle_tpu_torch.models.llama import (LlamaConfig,
                                                     LlamaForCausalLM)

    return LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=5,
                            init_std=0.02)


def _requests():
    from paddlepaddle_tpu_torch.inference.serving import GenerationRequest

    rng = np.random.default_rng(2)
    return [GenerationRequest(rng.integers(0, 1024, n), 12) for n in LENS]


@pytest.mark.cuda
def test_warmup_then_serve_window_captures_nothing_on_card():
    _card()
    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.inference.decode_engine import \
        BatchDecodeEngine
    from paddlepaddle_tpu_torch.observability import watchdog
    from paddlepaddle_tpu_torch.ops.kernels import _build
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    obs.reset()
    obs.enable(trace=False, metrics=False, watchdog_=True)
    try:
        model = _model()
        eng = BatchDecodeEngine(model, device="cuda", **ENGINE)
        info = eng.warmup()
        assert info["compiled"] == len(eng.compile_plan.keys())
        assert eng.capture_info()["decode"]["captured"]
        # the window: the engine's construction may have built the library
        log, nvcc = len(watchdog.compile_log()), _build.nvcc_runs
        unplanned = watchdog.unplanned_counts()
        launches = pa.paged_attention.launches
        reqs = _requests()
        eng.serve(reqs, timeout=300)
        assert len(watchdog.compile_log()) == log
        assert watchdog.unplanned_counts() == unplanned
        assert _build.nvcc_runs == nvcc
        assert eng.capture_info()["decode"]["replays"] > 0
        assert pa.paged_attention.launches > launches
        # a cold engine serves the same tokens, capturing in its window
        cold = BatchDecodeEngine(model, device="cuda", **ENGINE)
        again = _requests()
        cold.serve(again, timeout=300)
        for a, b in zip(reqs, again):
            np.testing.assert_array_equal(a.result.result(5),
                                          b.result.result(5))
        assert watchdog.unplanned_counts() == dict(
            unplanned, **{"capture:decode": 1})
    finally:
        obs.disable()
        obs.reset()


@pytest.mark.cuda
def test_capture_survives_a_dead_engine_collected_meanwhile():
    """ROADMAP C13: a stopped engine lives in a reference cycle (its
    captured program's body is its own bound method) until the cyclic
    collector runs; the collector running during another engine's capture
    destroyed the dead engine's graph mid-capture and invalidated it. Here
    the dead engine loses its last outside reference inside the live
    engine's capture, and the capture then allocates half the heap's count
    of new objects with the collector's thresholds at 1, which brings on a
    full automatic collection: the capture must succeed."""
    _card()
    import gc

    from paddlepaddle_tpu_torch.inference.decode_engine import \
        BatchDecodeEngine

    model = _model()
    dead = BatchDecodeEngine(model, device="cuda", **ENGINE)
    dead.serve(_requests()[:1], timeout=300)
    assert dead.capture_info()["decode"]["captured"]
    holder = [dead]
    del dead
    live = BatchDecodeEngine(model, device="cuda", **ENGINE)
    prog = live._program("decode")
    body = prog.body
    n_objects = len(gc.get_objects()) // 2
    keep = []

    def body_dropping_the_dead_engine():
        if torch.cuda.is_current_stream_capturing():
            holder.clear()            # garbage now, kept by its cycle
            keep.append([[] for _ in range(n_objects)])
        body()

    prog.body = body_dropping_the_dead_engine
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        reqs = _requests()
        live.serve(reqs, timeout=300)
    finally:
        gc.set_threshold(*thresholds)
    assert not holder and live.capture_info()["decode"]["captured"]
    assert all(len(r.result.result(5)) == n + 12 for r, n in zip(reqs, LENS))


_CHILD = r"""
import json, sys
import numpy as np
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import GenerationRequest
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.ops.kernels import _build
cfg, engine, lens = json.loads(sys.argv[2])
model = LlamaForCausalLM(LlamaConfig(**cfg), device="cuda", seed=5,
                         init_std=0.02)
eng = BatchDecodeEngine(model, device="cuda", bundle=sys.argv[1], **engine)
rng = np.random.default_rng(2)
reqs = [GenerationRequest(rng.integers(0, 1024, n), 12) for n in lens]
eng.serve(reqs, timeout=300)
print(json.dumps({"nvcc_runs": _build.nvcc_runs,
                  "bundle": eng.compile_info()["bundle"],
                  "tokens": [r.result.result(5).tolist() for r in reqs]}))
"""


@pytest.mark.cuda
def test_bundle_load_runs_no_nvcc_on_card(tmp_path):
    _card()
    from paddlepaddle_tpu_torch.inference.decode_engine import \
        BatchDecodeEngine
    from paddlepaddle_tpu_torch.ops.kernels import _build

    eng = BatchDecodeEngine(_model(), device="cuda", **ENGINE)
    manifest = eng.save_serving_bundle(str(tmp_path / "bundle"))
    assert [x["source"] for x in manifest["libraries"]] == ["paged_attention"]
    reqs = _requests()
    eng.serve(reqs, timeout=300)
    empty = tmp_path / "build"
    empty.mkdir()
    env = dict(os.environ, **{_build.BUILD_DIR_ENV: str(empty)})
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path / "bundle"),
         json.dumps([CFG, ENGINE, list(LENS)])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    child = json.loads(out.stdout.strip().splitlines()[-1])
    assert child["nvcc_runs"] == 0 and child["bundle"]["loaded"]
    assert os.listdir(empty) == [manifest["libraries"][0]["file"]]
    assert child["tokens"] == [r.result.result(5).tolist() for r in reqs]


@pytest.mark.cuda
def test_metrics_and_memory_scraped_on_card():
    _card()
    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.inference.serving import ServingEngine
    from paddlepaddle_tpu_torch.observability import metrics, reqtrace

    obs.reset()
    obs.enable(trace=True, metrics=True, watchdog_=True)
    reqtrace.enable()
    ex = obs.start_exporter(port=0)
    se = ServingEngine(_model(), max_batch_size=4, max_len=512,
                       kv_page_size=64, decode_chunk=8, device="cuda")
    try:
        rng = np.random.default_rng(2)
        futs = [se.submit(rng.integers(0, 1024, n), max_new_tokens=12)
                for n in LENS]
        for f in futs:
            f.result(300)

        def get(path):
            with urllib.request.urlopen(ex.url(path), timeout=60) as r:
                return r.read().decode()

        fams = metrics.parse_prometheus_text(get("/metrics"))
        ok = [v for _, lb, v in
              fams["paddle_serving_requests_total"]["samples"]
              if lb == {"outcome": "ok"}]
        assert ok == [len(LENS)]
        assert "paddle_goodput_tokens_total" in fams
        mem = json.loads(get("/mem"))
        assert mem["leaked_pages"] == 0
        assert mem["device_bytes_in_use"] > 0 and 0 < mem["headroom_ratio"] < 1
        assert mem["buckets"]["kv_pages"] > 0 and mem["buckets"]["params"] > 0
        assert len(json.loads(get("/requests"))["journeys"]) == len(LENS)
        assert json.loads(get("/healthz"))["providers"]["serving"]["ok"]
    finally:
        se.stop()
        obs.stop_exporter()
        reqtrace.disable()
        obs.disable()
        obs.reset()
