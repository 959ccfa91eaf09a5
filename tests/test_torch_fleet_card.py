"""Several serving engines in one process on the card (``cuda`` marker;
skipped without CUDA), the case the fleet's in-process replicas and its
rolling restart create: one engine captures its decode graph (``warmup()``)
while another decodes. No JAX here, so the file runs on a card host
without it: ``python -m pytest tests/test_torch_fleet_card.py -m cuda
--noconftest``.

ROADMAP C16: a capture in PyTorch's default global error mode fails when
another thread calls into CUDA meanwhile, and a graph's launches a replay
were once read from process-global counters that another engine moves
during the capture. Each test holds: every capture succeeds, each graph's
``launches_per_replay`` is its own engine's count (layers x chunk), the
counters move by exactly the replays' launches, and the decoding engine's
tokens equal a solo run's.

The model is a 2-layer bf16 Llama at head dim 128 (hidden 512, 4 query and
2 KV heads), a shape the paged kernel takes; tokens are compared exactly
(the captured decode has fixed shapes, so a request's tokens do not depend
on what else is in the batch).
"""

import threading
import time

import numpy as np
import pytest
import torch

CFG = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=1024, dtype="bfloat16")
SERVE = dict(max_batch_size=4, max_len=1024, decode_chunk=8,
             kv_page_size=64)
PER_REPLAY = CFG["num_hidden_layers"] * SERVE["decode_chunk"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _model():
    from paddlepaddle_tpu_torch.models.llama import (LlamaConfig,
                                                     LlamaForCausalLM)

    return LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=5,
                            init_std=0.02)


def _engine(model):
    from paddlepaddle_tpu_torch.inference.serving import ServingEngine

    return ServingEngine(model, device="cuda", **SERVE)


def _prompts(n, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], int(m)).astype(np.int32)
            for m in rng.integers(16, 300, n)]


def _decode_info(se):
    return se._engine.capture_info()["decode"]


@pytest.mark.cuda
def test_capture_while_another_engine_decodes():
    _card()
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    model = _model()
    solo = _engine(model)
    solo.warmup()
    prompts = _prompts(12)
    want = [solo.generate(p, max_new_tokens=160, timeout=300)
            for p in prompts]
    solo.stop()
    del solo

    a = _engine(model)
    a.warmup()
    assert _decode_info(a)["launches_per_replay"] == {"launches":
                                                      PER_REPLAY}
    b = _engine(model)
    counter0 = pa.paged_attention.launches
    futs = [a.submit(p, max_new_tokens=160) for p in prompts]
    t_end = time.monotonic() + 120
    while _decode_info(a)["replays"] < 2 and time.monotonic() < t_end:
        time.sleep(0.001)
    replays_before = _decode_info(a)["replays"]
    busy_before = sum(not f.done() for f in futs)
    b.warmup()                        # B captures while A decodes
    replays_during = _decode_info(a)["replays"] - replays_before
    got = [f.result(300) for f in futs]
    a_info, b_info = _decode_info(a), _decode_info(b)
    moved = pa.paged_attention.launches - counter0
    print(f"A busy {busy_before} when B's warmup began, A replays during "
          f"it {replays_during}, in all {a_info['replays']}; "
          f"launches_per_replay A {a_info['launches_per_replay']} B "
          f"{b_info['launches_per_replay']}; counter moved {moved}, A's "
          f"replays launched {a_info['replays'] * PER_REPLAY}")
    assert busy_before > 0 and replays_during > 0, "no overlap to test"
    assert b_info["captured"]
    assert b_info["launches_per_replay"] == {"launches": PER_REPLAY}
    assert a_info["launches_per_replay"] == {"launches": PER_REPLAY}
    # B's warmup launches nothing that counts; A's replays are every
    # launch of the window
    assert moved == a_info["replays"] * PER_REPLAY
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # B serves the same tokens after capturing under load
    for p, w in zip(prompts[:4], want[:4]):
        np.testing.assert_array_equal(
            b.generate(p, max_new_tokens=160, timeout=300), w)
    assert _decode_info(b)["replays"] > 0
    a.stop()
    b.stop()


@pytest.mark.cuda
def test_router_rolling_restart_under_load_on_card():
    """A router over two in-process replicas that share one model: the
    rolling restart warms each fresh engine while the other replica
    decodes. No request fails, the tokens equal one engine's, each fresh
    graph counts its own launches and no page leaks."""
    _card()
    from paddlepaddle_tpu_torch.inference.router import ServingRouter
    from paddlepaddle_tpu_torch.observability import memledger
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    model = _model()
    ref = _engine(model)
    ref.warmup()
    prompts = _prompts(16, seed=3)
    want = [ref.generate(p, max_new_tokens=96, timeout=300)
            for p in prompts]
    ref.stop()
    del ref

    router = ServingRouter([lambda: _engine(model), lambda: _engine(model)],
                           probe_interval_s=0.05, hedge_after_s=None)
    router.start()
    for rep in router._replicas:
        rep.client.warmup()
    futs = [router.submit(p, max_new_tokens=96) for p in prompts]
    res = router.rolling_restart(drain_timeout=120)
    more = [router.submit(p, max_new_tokens=96) for p in prompts[:4]]
    got = [f.result(300) for f in futs + more]
    assert res["ok"], res
    assert router.health()["router"]["failed"] == 0
    for g, w in zip(got, want + want[:4]):
        np.testing.assert_array_equal(g, w)
    for rep in router._replicas:
        eng = rep.client.engine._engine
        info = eng.capture_info()["decode"]
        assert info["launches_per_replay"] == {"launches": PER_REPLAY}
        # a future is delivered before its slot is swept: wait for idle
        end = time.monotonic() + 60
        while eng.busy_slots() and time.monotonic() < end:
            time.sleep(0.01)
        assert eng.busy_slots() == 0
        assert memledger.leak_check(eng)["leaked_pages"] == 0
    assert pa.paged_attention.launches > 0
    router.stop()
