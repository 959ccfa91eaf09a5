"""The port's compile plan, warmup and bundles (paddlepaddle_tpu_torch/
inference/compile_plan.py and the engine's ``warmup`` / ``bundle=``) against
the JAX package on the CPU.

What is held, and how tightly:
* plan keys: equal to the reference's for the same configuration (exact);
* the fingerprint: equal facts give an equal hash, each changed fact a new
  one (exact);
* warmup: the serve window after it builds no program and the watchdog
  counts no unplanned capture or build; a warmed engine serves the tokens a
  cold one serves, sampled ones included (exact: the warmup restores the
  sampling generator);
* bundles: the reference's own bundle tests are red (ROADMAP,
  "Reference-side red"), so the port's bundle is held to its own round
  trip: a CPU engine's bundle is a manifest without libraries (the CPU
  launches no kernel library).
"""

import json
import os

import numpy as np
import pytest

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.inference.decode_engine import \
    BatchDecodeEngine as JEngine
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch import observability as tobs
from paddlepaddle_tpu_torch.inference import compile_plan as cp
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import (GenerationRequest,
                                                      ServingEngine)
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.observability import watchdog

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=384, dtype="float32")
ENGINE = dict(max_slots=2, max_len=384, page_size=16, chunk=4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**CFG))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**CFG), device="cpu")
    convert.load_jax_state(tm, state)
    return jm, tm


@pytest.fixture
def watched():
    tobs.reset()
    tobs.enable(trace=False, metrics=True, watchdog_=True)
    yield
    tobs.disable()
    tobs.reset()


def _prompts(lens=(5, 130, 40), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, n) for n in lens]


@pytest.mark.parametrize("kw", [
    {}, {"kv_layout": "contiguous"}, {"kv_quant": "int8"},
    {"spec_k": 2}], ids=["paged", "contiguous", "int8_kv", "spec"])
def test_plan_keys_match_reference(models, kw):
    jm, tm = models
    jkw, tkw = dict(kw), dict(kw)
    if "spec_k" in kw:
        jkw["draft"], tkw["draft"] = jm, tm
    want = JEngine(jm, **ENGINE, **jkw).compile_plan
    got = BatchDecodeEngine(tm, device="cpu", **ENGINE, **tkw).compile_plan
    assert got.keys() == want.keys()
    assert [e.kind for e in got.entries] == [e.kind for e in want.entries]
    assert cp.prompt_buckets(384) == [128, 256, 384]
    for key in got.keys():
        assert cp.parse_key(key)[0] == dict(
            (e.key, e.kind) for e in want.entries)[key]
    if kw.get("kv_layout") == "contiguous":
        assert got.entries[0].meta["program"] == "decode_contig"


def test_fingerprint_is_stable_and_each_fact_moves_it(models):
    _, tm = models
    a = BatchDecodeEngine(tm, device="cpu", **ENGINE).compile_plan
    b = BatchDecodeEngine(tm, device="cpu", **ENGINE).compile_plan
    assert a.fingerprint() == b.fingerprint()
    base = a.facts
    for fact, value in (("max_slots", 3), ("chunk", 8), ("kv_quant", "int8"),
                        ("torch", "0.0"), ("cuda", "0.0"),
                        ("device_name", "another card"),
                        ("kernels", {"paged_attention": "x.so"}),
                        ("spec", {"k": 2}), ("quant", "weight_only_int8")):
        moved = cp.CompilePlan(a.entries, dict(base, **{fact: value}))
        assert moved.fingerprint() != a.fingerprint(), fact
    for fact, value in (("max_slots", 3), ("chunk", 8),
                        ("kv_quant", "int8"), ("kv_layout", "contiguous")):
        kw = dict(ENGINE, **{fact: value})
        other = BatchDecodeEngine(tm, device="cpu", **kw).compile_plan
        assert other.fingerprint() != a.fingerprint(), fact
        assert fact in cp._facts_diff(a.facts, other.facts)
    assert set(base) >= {"model", "torch", "cuda", "platform", "kernels",
                         "fused"}


def test_warmup_then_serve_window_builds_nothing(models, watched):
    _, tm = models
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    info = eng.warmup()
    assert info["programs"] == len(eng.compile_plan.keys())
    assert info["compiled"] == len(eng.compile_plan.keys())
    assert eng.compile_info()["warmup"] == info
    snap = tobs.snapshot()
    assert snap["paddle_serving_warmup_programs"][()] == info["compiled"]
    assert eng.warmup()["skipped"] == info["programs"]        # idempotent
    built = len(eng._programs)
    log = len(watchdog.compile_log())
    reqs = [GenerationRequest(p, 6) for p in _prompts()]
    eng.serve(reqs, timeout=120)
    assert len(eng._programs) == built
    assert len(watchdog.compile_log()) == log
    assert watchdog.unplanned_counts() == {}
    assert eng.compile_info()["programs_warmed"] == len(eng.compile_plan.keys())
    assert eng.pool.free_count == eng.pool.usable


@pytest.mark.parametrize("kw", [{}, {"kv_layout": "contiguous"},
                                {"spec_k": 2}],
                         ids=["paged", "contiguous", "spec"])
def test_warmed_engine_serves_what_a_cold_one_serves(models, kw):
    _, tm = models
    kw = dict(kw, draft=tm) if "spec_k" in kw else kw
    temp = 0.0 if "spec_k" in kw else 0.9     # spec serves greedy only
    outs = []
    for warm in (False, True):
        eng = BatchDecodeEngine(tm, device="cpu", seed=3, **ENGINE, **kw)
        if warm:
            eng.warmup()
        reqs = [GenerationRequest(p, 8, temperature=temp)
                for p in _prompts()]
        eng.serve(reqs, timeout=120)
        outs.append([r.result.result(5) for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_warmup_refuses_a_busy_engine(models):
    _, tm = models
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    assert eng._admit(GenerationRequest(_prompts()[0], 8))
    with pytest.raises(RuntimeError, match="idle"):
        eng.warmup()


def test_bundle_round_trip_mismatch_and_corruption(models, tmp_path,
                                                   watched):
    _, tm = models
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    path = str(tmp_path / "bundle")
    m = eng.save_serving_bundle(path)
    assert m["libraries"] == [] and m["keys"] == eng.compile_plan.keys()
    assert os.listdir(path) == [cp.MANIFEST_NAME]
    assert not any(p.endswith(".staging." + str(os.getpid()))
                   for p in os.listdir(tmp_path))
    assert cp.validate_bundle(path)["fingerprint"] == \
        eng.compile_plan.fingerprint()
    # the round trip: a second engine of the same configuration loads it
    again = BatchDecodeEngine(tm, device="cpu", bundle=path, **ENGINE)
    info = again.compile_info()["bundle"]
    assert info["loaded"] and info["programs"] == len(m["keys"])
    assert info["version"] == m["version"]
    assert tobs.snapshot()["paddle_serving_bundle_loaded"][()] == 1
    reqs = [GenerationRequest(p, 4) for p in _prompts()]
    again.serve(reqs, timeout=120)
    assert all(r.result.done() for r in reqs)
    # another configuration: rejected with the differing fact, still serves
    other = BatchDecodeEngine(tm, device="cpu", bundle=path,
                              **dict(ENGINE, chunk=8))
    info = other.compile_info()["bundle"]
    assert not info["loaded"] and "chunk" in info["error"]
    assert info["error"].startswith("BundleMismatchError")
    with pytest.raises(cp.BundleMismatchError) as ei:
        cp.load_bundle(other, path)
    assert ei.value.mismatches == ["chunk"]
    reqs = [GenerationRequest(p, 4) for p in _prompts()]
    other.serve(reqs, timeout=120)
    assert all(r.result.done() for r in reqs)
    # corruption: a tampered manifest and an unknown format are refused
    mpath = os.path.join(path, cp.MANIFEST_NAME)
    doc = json.load(open(mpath))
    doc["keys"].append("not_a_key")
    json.dump(doc, open(mpath, "w"))
    with pytest.raises(ValueError):
        cp.validate_bundle(path)
    doc["keys"].pop()
    doc["format_version"] = 99
    json.dump(doc, open(mpath, "w"))
    with pytest.raises(cp.BundleMismatchError):
        cp.load_bundle(eng, path)
    open(mpath, "w").write("{not json")
    bad = BatchDecodeEngine(tm, device="cpu", bundle=path, **ENGINE)
    assert bad.compile_info()["bundle"]["error"].startswith("JSONDecodeError")
    fallbacks = tobs.snapshot()["paddle_serving_bundle_fallbacks_total"]
    assert fallbacks[(("reason", "BundleMismatchError"),)] == 1
    assert fallbacks[(("reason", "JSONDecodeError"),)] == 1


def test_bundle_libraries_are_checked_and_placed(models, tmp_path,
                                                 monkeypatch):
    """A bundle's kernel libraries: verified by sha256 and copied into the
    build directory under their content-hashed names (no nvcc here: the
    library is a stand-in file, and the engine's plan is told it launches
    it)."""
    from paddlepaddle_tpu_torch.ops.kernels import _build

    _, tm = models
    build = tmp_path / "build"
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(build))
    build.mkdir()
    lib = _build.library_path("paged_attention")
    lib.write_bytes(b"stand-in library")
    eng = BatchDecodeEngine(tm, device="cpu", **ENGINE)
    eng.compile_plan.libraries = ["paged_attention"]
    eng.compile_plan.facts["kernels"] = {"paged_attention": lib.name}
    eng.compile_plan._fingerprint = None
    path = str(tmp_path / "bundle")
    m = cp.save_bundle(eng, path)
    assert [x["file"] for x in m["libraries"]] == [lib.name]
    lib.unlink()                                # a fresh host
    cp.load_bundle(eng, path)
    assert lib.read_bytes() == b"stand-in library"
    lib.unlink()
    with open(os.path.join(path, lib.name), "ab") as f:
        f.write(b"x")                           # corrupted in transit
    with pytest.raises(cp.BundleMismatchError, match="sha256"):
        cp.load_bundle(eng, path)
    assert not lib.exists()


def test_serving_engine_warmup_and_bundle_passthrough(models, tmp_path):
    _, tm = models
    se = ServingEngine(tm, max_batch_size=2, max_len=384, kv_page_size=16,
                       decode_chunk=4, device="cpu")
    try:
        w = se.warmup()
        assert w["compiled"] == len(se.engine.compile_plan.keys())
        se.save_serving_bundle(str(tmp_path / "b"))
        block = se.health()["compile"]
        assert block["warmup"] == w and block["plan"]["entries"] == 4
    finally:
        se.stop()
    se2 = ServingEngine(tm, max_batch_size=2, max_len=384, kv_page_size=16,
                        decode_chunk=4, device="cpu",
                        bundle=str(tmp_path / "b"))
    try:
        assert se2.health()["compile"]["bundle"]["loaded"]
        out = se2.generate(_prompts()[0], max_new_tokens=3, timeout=60)
        assert len(out) == 8
    finally:
        se2.stop()
    static = ServingEngine(tm, mode="static", device="cpu")
    assert static.warmup() == {"programs": 0, "compiled": 0, "skipped": 0,
                               "wall_s": 0.0, "mode": "static"}
    with pytest.raises(ValueError, match="continuous"):
        static.save_serving_bundle(str(tmp_path / "c"))
