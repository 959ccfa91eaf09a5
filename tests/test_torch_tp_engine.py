"""The single-process tensor-parallel engine on the CPU against the JAX
package (``paddlepaddle_tpu/inference/decode_engine.py`` under
``decode_plan("mp2")``, ``tests/test_shard_plan.py:199-262``).

``BatchDecodeEngine(model, plan=decode_plan("mp2"), device="cpu")`` and
``ServingEngine(model, mesh="mp2", device="cpu")`` are built in this test's
own process, which holds no process group: it is rank 0, and each engine
starts its other rank itself (``inference/tp_worker.py``), on gloo groups
the engine owns. The reference test's fixed workload (2 slots, chunk 4,
page 16; the prompts of ``tests/test_torch_shard_plan.py``):

* greedy tokens equal the JAX mp2 engine's, the one-process engine's and
  the launcher form's (two ranks from ``spawn``), in f32 (also at 2 KV
  heads a rank), in bf16 and with int8 weights; first-step logits within
  1e-5 (f32) and 2e-2 (bf16) of the one-process model; prefix hits;
* two mp2 engines alive at once, each token-exact, with the mesh block of
  ``health()`` and the mesh gauges;
* speculative decoding under mp2 (the draft replicated on both ranks):
  tokens, acceptance and run lengths equal the JAX mp2 spec engine's, with
  the target as its own draft and with a noisy copy of it (partial
  acceptance), at k 2 and 3; the tokens equal the one-process non-spec
  stream; ``draft_quant`` serves; both ranks took the same accept lengths.

Engines are built once each; this process runs with 2 CPU threads (the
workers take rank 0's count), restored at the end.
"""

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed import shard_plan as jsp
from paddlepaddle_tpu.inference.decode_engine import \
    BatchDecodeEngine as JaxEngine
from paddlepaddle_tpu.inference.serving import \
    GenerationRequest as JaxRequest
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama

import torch_dist_workers as W
from paddlepaddle_tpu_torch.distributed import decode_plan, spawn
from test_torch_shard_plan import (_jax_serve, _jax_tiny, _pfx_prompts,
                                   _prompts, _state_f32)

ENGINE = dict(max_slots=2, chunk=4, page_size=16)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_models():
    models = {d: _jax_tiny(d) for d in ("float32", "bfloat16")}
    models["gqa"] = _jax_tiny("float32", cfg=W.TINY_GQA)
    return models


@pytest.fixture(scope="module")
def port(jax_models):
    states = {d: _state_f32(m) for d, m in jax_models.items()}
    return {"float32": W.port_llama(states["float32"], "float32"),
            "bfloat16": W.port_llama(states["bfloat16"], "bfloat16"),
            "gqa": W.port_llama(states["gqa"], "float32", W.TINY_GQA),
            "states": states}


def _serve(model, prompts, n, prefix_len=None, **kw):
    """(tokens, engine) of one engine in this process; a plan's engine is
    stopped (its worker joined) before it returns."""
    import paddlepaddle_tpu_torch as pt

    eng = pt.BatchDecodeEngine(model, device="cpu", **dict(ENGINE, **kw))
    reqs = W._requests(prompts, n, prefix_len)
    eng.serve(reqs, timeout=300)
    eng.stop()
    return [np.asarray(r.result.result(5)) for r in reqs], eng


def _first_logits(eng, model, prompts):
    """Largest |logit difference| of the last prompt position: the plan's
    view (both ranks in step) against the one-process model."""
    diff = 0.0
    for p in prompts:
        tp = eng._forward_logits(p[None])[0, -1]
        with torch.no_grad():
            one = model(torch.from_numpy(p[None]).long())[0, -1]
        diff = max(diff, float(np.abs(tp - one.float().numpy()).max()))
    return diff


@pytest.fixture(scope="module")
def single(port):
    """Tokens (and first-step logit differences) of the single-process mp2
    engines, each stopped after it served."""
    import paddlepaddle_tpu_torch as pt

    out = {}
    for label, model in (("float32", port["float32"]),
                         ("bfloat16", port["bfloat16"]),
                         ("gqa", port["gqa"])):
        eng = pt.BatchDecodeEngine(model, device="cpu",
                                   plan=decode_plan("mp2"), **ENGINE)
        reqs = W._requests(_prompts(), 12)
        eng.serve(reqs, timeout=300)
        out[label] = [np.asarray(r.result.result(5)) for r in reqs]
        out[f"logit_diff_{label}"] = _first_logits(eng, model, _prompts())
        out[f"pool_{label}"] = tuple(eng.caches[0][0].shape)
        out[f"pids_{label}"] = eng._tp.pids
        eng.stop()
        out[f"exit_{label}"] = [p.exitcode for p in eng._tp.procs]
        out[f"one_{label}"], _ = _serve(model, _prompts(), 12)
    out["int8"], eng = _serve(port["bfloat16"], _prompts(), 12,
                              plan=decode_plan("mp2"),
                              quant="weight_only_int8")
    out["int8_q_shape"] = tuple(
        eng.net.model.layers[0].self_attn.q_proj.quant_weight.shape)
    out["one_int8"], _ = _serve(port["bfloat16"], _prompts(), 12,
                                quant="weight_only_int8")
    out["pfx"], eng = _serve(port["bfloat16"], _pfx_prompts(), 8,
                             prefix_len=20, mesh="mp2")
    out["pfx_stats"] = (eng.prefix.hits, eng.prefix.misses)
    out["pfx_one"], _ = _serve(port["bfloat16"], _pfx_prompts(), 8)
    return out


@pytest.fixture(scope="module")
def spmd(port):
    """The launcher form's tokens on the same workload (two ranks from the
    port's ``spawn``)."""
    st = port["states"]
    cases = [("float32", st["float32"], "float32", None, None),
             ("gqa", st["gqa"], "float32", W.TINY_GQA, None),
             ("bfloat16", st["bfloat16"], "bfloat16", None, None),
             ("int8", st["bfloat16"], "bfloat16", None, "weight_only_int8")]
    return spawn(W.spmd_tokens_session, args=(cases, _prompts(), 12),
                 nprocs=2, timeout=280, pg_timeout=120)[0]


def _equal(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -- token parity ----------------------------------------------------------------

@pytest.mark.parametrize("label", ["float32", "gqa", "bfloat16"])
def test_single_process_mp2_tokens_equal_jax_one_process_and_spmd(
        jax_models, single, spmd, label):
    """One process, no group: the greedy tokens are the JAX mp2 engine's,
    the plan-less engine's and the launcher form's; the first-step logits
    are within 1e-5 (f32) and 2e-2 (bf16) of the one-process model (bf16:
    each partial of the row-parallel sums rounded to bf16 first); the KV
    pool holds this rank's KV heads; the worker exited 0 after stop()."""
    want = _jax_serve(jax_models[label], _prompts(), 12)
    _equal(single[label], want, single[f"one_{label}"], spmd[label])
    tol = 2e-2 if label == "bfloat16" else 1e-5
    assert single[f"logit_diff_{label}"] < tol, single[f"logit_diff_{label}"]
    kvh = (W.TINY_GQA if label == "gqa" else W.TINY)["num_key_value_heads"]
    assert single[f"pool_{label}"][2] == kvh // 2
    assert single[f"exit_{label}"] == [0]


def test_single_process_mp2_int8_weights(jax_models, single, spmd):
    """Rank 0 quantizes the whole weights, then cuts both ranks' shards:
    the tokens are the JAX mp2 int8 engine's."""
    want = _jax_serve(jax_models["bfloat16"], _prompts(), 12,
                      quant="weight_only_int8")
    _equal(single["int8"], want, single["one_int8"], spmd["int8"])
    assert single["int8_q_shape"] == (64, 32)     # q columns split over mp


def test_single_process_mp2_prefix_hits(jax_models, single):
    want = _jax_serve(jax_models["bfloat16"], _pfx_prompts(), 8,
                      prefix_len=20)
    _equal(single["pfx"], want, single["pfx_one"])
    assert single["pfx_stats"] == (2, 1)


# -- two engines at once ---------------------------------------------------------

def test_two_mp2_serving_engines_at_once_health_and_gauges(jax_models, port):
    """Two ``ServingEngine(mesh="mp2")`` alive together in this process
    (four processes, two sets of groups): each answers the JAX mp2
    engine's tokens, reports the reference's mesh block plus the backend
    and its worker, and the mesh gauges; stop() joins each worker."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch import observability as obs

    obs.reset()
    prompt = np.arange(8, dtype=np.int32)
    (want,) = _jax_serve(jax_models["float32"], [prompt], 4)
    engines = [pt.ServingEngine(port["float32"], max_batch_size=2,
                                decode_chunk=4, kv_page_size=16, mesh="mp2",
                                device="cpu") for _ in range(2)]
    procs = [e._engine._tp.procs[0] for e in engines]
    try:
        for e in engines:
            e.start()
        futs = [e.submit(prompt, max_new_tokens=4) for e in engines
                for _ in range(2)]
        for f in futs:
            np.testing.assert_array_equal(f.result(120), want)
        for e, p in zip(engines, procs):
            h = e.health()["mesh"]
            assert h == {"enabled": True, "axes": {"mp": 2}, "devices": 2,
                         "tp": 2, "dp": 1, "path": "spmd",
                         "backend": "gloo", "worker_pids": [p.pid]}
        assert procs[0].pid != procs[1].pid
        snap = obs.snapshot()
        assert snap["paddle_tp_degree"][()] == 2
        assert snap["paddle_mesh_devices"][(("axes", "mp2"),)] == 2
        assert snap["paddle_mesh_axes"][(("axes", "mp2"),)] == 1
        assert engines[0].drain(timeout=30)["clean"] is True
        assert procs[0].exitcode == 0
    finally:
        for e in engines:
            e.stop()
    assert [p.exitcode for p in procs] == [0, 0]


# -- speculative decoding under a plan --------------------------------------------

@pytest.fixture(scope="module")
def drafts(jax_models, port):
    """(JAX, port) drafts for the GQA target: the target itself, and a
    noisy copy of its weights (noise 0.8x each tensor's scale, seeded:
    partial acceptance, so verify rolls back)."""
    state = port["states"]["gqa"]
    rng = np.random.default_rng(5)
    near = {k: (v + 0.8 * v.std() * rng.standard_normal(v.shape)
                ).astype(np.float32) if "norm" not in k else v
            for k, v in state.items()}
    paddle.seed(0)
    jnear = JaxLlama(JaxConfig(**dict(W.TINY_GQA, dtype="float32")))
    jnear.set_state_dict(near)
    return {"self": (jax_models["gqa"], port["gqa"]),
            "near": (jnear, W.port_llama(near, "float32", W.TINY_GQA))}


@pytest.fixture(scope="module")
def plain_gqa(port):
    """The one-process non-spec engine's stream on the GQA target."""
    return _serve(port["gqa"], _prompts(), 8)[0]


def _jax_spec(model, draft, k):
    eng = JaxEngine(model, plan=jsp.decode_plan("mp2"), draft=draft,
                    spec_k=k, **ENGINE)
    reqs = [JaxRequest(p, 8, 0.0, 0, None) for p in _prompts()]
    eng.serve(reqs, timeout=300)
    return [np.asarray(r.result.result(5)) for r in reqs], eng


@pytest.mark.parametrize("draft,k", [("self", 2), ("self", 3),
                                     ("near", 2), ("near", 3)])
def test_speculative_under_mp2_matches_jax_spec_engine(jax_models, port,
                                                       drafts, plain_gqa,
                                                       draft, k):
    """The draft replicated on both ranks, the verify at W = k+1 on each
    rank's local heads: tokens, acceptance stats and the accepted-run
    histogram equal the JAX mp2 spec engine's; the tokens equal the
    one-process non-spec stream; both ranks took the same accept lengths
    (their checksums of every accepted-run matrix agree)."""
    jd, td = drafts[draft]
    want, jeng = _jax_spec(jax_models["gqa"], jd, k)
    import paddlepaddle_tpu_torch as pt

    eng = pt.BatchDecodeEngine(port["gqa"], device="cpu",
                               plan=decode_plan("mp2"), draft=td, spec_k=k,
                               **ENGINE)
    reqs = W._requests(_prompts(), 8)
    eng.serve(reqs, timeout=300)
    ranks = eng._rank_counters()
    eng.stop()
    got = [np.asarray(r.result.result(5)) for r in reqs]
    _equal(got, want, plain_gqa)
    assert eng.spec.stats == jeng.spec.stats
    assert eng.spec.runlen == jeng.spec.runlen
    assert ranks[0]["spec"] == ranks[1]["spec"]
    assert ranks[0]["spec"]["target_steps"] > 0
    st = eng.spec.stats
    if draft == "self":
        assert st["accepted"] == st["proposed"]
    else:
        assert 0 < st["accepted"] < st["proposed"]
    kv = eng.kv_stats()
    assert kv["pages_used"] == kv["prefix"]["cached_pages"]


def test_speculative_under_mp2_with_draft_quant(port, drafts):
    """``draft_quant`` quantizes each rank's replica of the draft alike:
    the stream is the one-process spec engine's with the same draft."""
    import paddlepaddle_tpu_torch as pt

    _, td = drafts["near"]
    kw = dict(draft=td, spec_k=2, draft_quant="weight_only_int8")
    want, one = _serve(port["gqa"], _prompts(), 8, **kw)
    eng = pt.BatchDecodeEngine(port["gqa"], device="cpu",
                               plan=decode_plan("mp2"), **dict(ENGINE, **kw))
    reqs = W._requests(_prompts(), 8)
    eng.serve(reqs, timeout=300)
    ranks = eng._rank_counters()
    eng.stop()
    _equal([np.asarray(r.result.result(5)) for r in reqs], want)
    assert eng.spec.stats == one.spec.stats
    assert ranks[0]["spec"] == ranks[1]["spec"]
    assert eng.spec_info()["draft"]["quant"] == "weight_only_int8"
