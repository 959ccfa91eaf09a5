"""Shared-prefix hits, int8 KV pages and the host-RAM prefix tier in the
port's serving path, on the CPU, against the JAX package.

* The ``KVS1`` page slab (inference/kv_pool.py) is byte-identical to the
  reference's in both directions for f32, int8 and bf16 arrays, rejects
  corruption, and the host tier keeps the reference's LRU and budget
  bookkeeping (both modules run the same cases).
* Engines at fp32 greedy against the JAX reference engine with
  ``fused_kernels=False`` (its non-kernel path; the fused engine is not an
  oracle, ROADMAP): prefix-hit tokens equal miss tokens and the JAX tokens,
  with equal prefix counters; the int8 engine token-exact against the JAX
  int8 engine; int8 against full precision with greedy agreement >= 0.9
  (as tests/test_kv_quant_tier.py:174); spill/restore, a corrupt slab and
  the tier switched off as tests/test_kv_quant_tier.py:231-286, token-exact
  against the JAX engine on the same workloads.

The workloads keep every reservation inside the reference's prefill bucket
(max_len 96 < 128), where its int8 pages start at scale 0 as the port's do.
"""

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.inference import kv_pool as jax_kv_pool
from paddlepaddle_tpu.inference.decode_engine import \
    BatchDecodeEngine as JaxEngine
from paddlepaddle_tpu.inference.serving import \
    GenerationRequest as JaxRequest
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.core import flags as port_flags
from paddlepaddle_tpu_torch.inference import kv_pool as port_kv_pool
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.robustness import \
    RequestValidationError
from paddlepaddle_tpu_torch.inference.serving import (
    GenerationRequest,
    ServingEngine,
)
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96, dtype="float32")
MODULES = pytest.mark.parametrize("kv", [jax_kv_pool, port_kv_pool],
                                  ids=["jax", "port"])


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    convert.load_jax_state(
        tm, {k: np.asarray(v) for k, v in jm.functional_state().items()})
    return jm, tm


def _serve(eng, specs, jax=False):
    """specs: (prompt ids, max_new_tokens, prefix_len) each, served in one
    call; returns the output ids."""
    make = JaxRequest if jax else GenerationRequest
    reqs = []
    for ids, n, pfx in specs:
        r = make(np.asarray(ids, np.int32), n, 0.0, 0, None)
        r.prefix_len = pfx
        reqs.append(r)
    eng.serve(reqs, timeout=300)
    return [np.asarray(r.result.result(5)) for r in reqs]


def _pair(models, specs_runs, port_kw, jax_kw=None):
    """Serve the same runs (a list of spec lists, served one after the
    other on one engine) through a port engine and a JAX engine."""
    jm, tm = models
    eng = BatchDecodeEngine(tm, device="cpu", **port_kw)
    jeng = JaxEngine(jm, fused_kernels=False, **(jax_kw or port_kw))
    got = [_serve(eng, run) for run in specs_runs]
    want = [_serve(jeng, run, jax=True) for run in specs_runs]
    for g_run, w_run in zip(got, want):
        for g, w in zip(g_run, w_run):
            np.testing.assert_array_equal(g, w)
    return eng, jeng, got


# -- KVS1 slabs ---------------------------------------------------------------

def _slab_arrays(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((4, 8, 2, 16)).astype(np.float32),
            rng.integers(-127, 128, (4, 8, 2, 16)).astype(np.int8),
            rng.standard_normal((4, 2)).astype(np.float32),
            np.float32(2.5)]


def test_slab_bytes_identical_to_reference_f32_int8():
    arrays = _slab_arrays()
    meta = {"page_size": 8, "kv_quant": "int8", "length": 30, "n_pages": 4}
    want = jax_kv_pool.serialize_page_slab(meta, arrays)
    assert port_kv_pool.serialize_page_slab(meta, arrays) == want
    # the same values as torch tensors give the same bytes
    tens = [torch.from_numpy(np.asarray(a)) for a in arrays]
    assert port_kv_pool.serialize_page_slab(meta, tens) == want
    # reference blob -> port reader
    m2, got = port_kv_pool.deserialize_page_slab(want)
    assert m2 == meta
    for a, t in zip(arrays, got):
        assert isinstance(t, torch.Tensor)
        assert t.numpy().dtype == np.asarray(a).dtype
        assert t.numpy().tobytes() == np.asarray(a).tobytes()
    # port blob -> reference reader
    m3, back = jax_kv_pool.deserialize_page_slab(
        port_kv_pool.serialize_page_slab(meta, tens))
    assert m3 == meta
    for a, b in zip(arrays, back):
        assert b.dtype == np.asarray(a).dtype and b.tobytes() == \
            np.asarray(a).tobytes()


def test_slab_bytes_identical_to_reference_bf16():
    import ml_dtypes

    x = (np.arange(64, dtype=np.float32) / 7.0 - 3.0).reshape(2, 4, 8)
    jx = x.astype(ml_dtypes.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    meta = {"dtype": "bfloat16", "length": 16}
    want = jax_kv_pool.serialize_page_slab(meta, [jx])
    got = port_kv_pool.serialize_page_slab(meta, [tx])
    assert got == want
    assert b'"dtype": "bfloat16"' in got
    _, (t,) = port_kv_pool.deserialize_page_slab(want)
    assert t.dtype == torch.bfloat16 and torch.equal(t, tx)
    _, (y,) = jax_kv_pool.deserialize_page_slab(got)
    assert y.dtype == jx.dtype and y.tobytes() == jx.tobytes()


@MODULES
def test_slab_rejects_corruption(kv):
    blob = kv.serialize_page_slab({"k": 1}, [np.zeros(4, np.float32)])
    with pytest.raises(ValueError):
        kv.deserialize_page_slab(b"XXXX" + blob[4:])      # bad magic
    with pytest.raises(ValueError):
        kv.deserialize_page_slab(blob[:-3])               # truncated payload
    with pytest.raises(ValueError):
        kv.deserialize_page_slab(blob + b"\x00")          # trailing bytes


def test_port_slab_rejects_unknown_dtype():
    blob = port_kv_pool.serialize_page_slab({}, [np.zeros(2, np.int8)])
    bad = blob.replace(b'"int8"', b'"int9"')
    with pytest.raises(ValueError, match="dtype"):
        port_kv_pool.deserialize_page_slab(bad)


def _host_slab(kv, nbytes, stamp):
    return kv.HostSlab(b"x" * nbytes, length=8, n_pages=1, stamp=stamp)


@MODULES
def test_host_tier_lru_budget_and_oversize(kv):
    with pytest.raises(ValueError):
        kv.HostPrefixTier(0)
    tier = kv.HostPrefixTier(100)
    assert tier.put("a", _host_slab(kv, 40, stamp=1))
    assert tier.put("b", _host_slab(kv, 40, stamp=2))
    assert tier.put("c", _host_slab(kv, 40, stamp=3))   # "a" is the victim
    assert tier.pop("a") is None and tier.discards == 1
    assert sorted(tier.keys()) == ["b", "c"] and tier.used_bytes == 80
    assert not tier.put("big", _host_slab(kv, 200, stamp=4))
    assert tier.discards == 2 and sorted(tier.keys()) == ["b", "c"]
    s = tier.pop("b")
    assert s is not None and tier.used_bytes == 40 and tier.restores == 1
    tier.put_back("b", s)
    assert tier.used_bytes == 80 and tier.restores == 0 and tier.spills == 3
    st = tier.stats()
    assert st["entries"] == 2 and st["budget_bytes"] == 100
    assert st["occupancy"] == pytest.approx(0.8)
    assert "b" in tier and len(tier) == 2
    tier.clear()
    assert tier.used_bytes == 0 and len(tier) == 0


# -- prefix-cache hits --------------------------------------------------------

def _system_prompts(seed=2, tails=(4, 7, 9)):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 128, (35,)).astype(np.int32)  # aligns to 32
    return system, [np.concatenate([system, rng.integers(0, 128, (k,))
                                    .astype(np.int32)]) for k in tails]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["full", "int8"])
def test_prefix_hits_token_exact_vs_miss_and_jax(models, kv_quant):
    """One miss registers the 32-token prefix, two hits prefill only their
    tails; a later request re-hits the retained entry. Tokens equal the
    no-cache port engine and the JAX engine, and the prefix counters equal
    the JAX engine's."""
    system, prompts = _system_prompts()
    specs = [(p, 8, len(system)) for p in prompts]
    kw = dict(max_slots=4, chunk=4, page_size=16, kv_quant=kv_quant)
    eng, jeng, got = _pair(models, [specs, specs[:1]], kw)
    _, tm = models
    base = BatchDecodeEngine(tm, device="cpu", prefix_cache=False, **kw)
    for g, b in zip(got[0], _serve(base, specs)):
        np.testing.assert_array_equal(g, b)
    np.testing.assert_array_equal(got[1][0], got[0][0])
    st, jst = eng.kv_stats(), jeng.kv_stats()
    assert st["prefix"] == jst["prefix"] == {
        "enabled": True, "entries": 1, "cached_pages": 2, "hits": 3,
        "misses": 1, "evictions": 0}
    # only the pinned prefix stays resident after every slot retired
    assert st["pages_used"] == 2 == jst["pages_used"]
    assert base.kv_stats()["prefix"]["hits"] == 0


def test_prefix_eviction_when_free_list_dry(models):
    """A refcount-0 prefix is LRU-evicted (no host tier: discarded) to
    admit a request that needs its pages (tests/test_paged_kv.py:185)."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, 128, (35,)).astype(np.int32)
    p1 = np.concatenate([system, rng.integers(0, 128, (5,)).astype(np.int32)])
    big = rng.integers(0, 128, (88,)).astype(np.int32)
    kw = dict(max_slots=2, chunk=4, page_size=16, num_pages=7)
    eng, jeng, _ = _pair(models, [[(p1, 4, 35)], [(big, 8, None)]], kw)
    for st in (eng.kv_stats(), jeng.kv_stats()):
        assert st["prefix"]["evictions"] == 1 and st["prefix"]["entries"] == 0
    assert eng.pool.free_count == eng.pool.usable


def test_prefix_plan_rules(models):
    _, tm = models
    eng = BatchDecodeEngine(tm, device="cpu", max_slots=2, page_size=16)
    ids = np.arange(40, dtype=np.int32)[None]

    class R:
        prefix_len = 0

    r = R()
    for pfx, want in ((0, (0, 0)), (15, (0, 0)), (35, (32, 2)),
                      (40, (32, 2)), (16, (16, 1))):
        r.prefix_len = pfx
        aligned, n_pfx, h, entry = eng._prefix_plan(r, ids, 40)
        assert (aligned, n_pfx) == want and entry is None
        assert (h is None) == (n_pfx == 0)
    r.prefix_len = 32                     # aligned == plen: keep one tail page
    assert eng._prefix_plan(r, ids[:, :32], 32)[:2] == (16, 1)
    r.prefix_len = 41
    with pytest.raises(ValueError, match="exceeds the prompt"):
        eng._prefix_plan(r, ids, 40)
    off = BatchDecodeEngine(tm, device="cpu", max_slots=2, page_size=16,
                            prefix_cache=False)
    r.prefix_len = 35
    assert off._prefix_plan(r, ids, 40) == (0, 0, None, None)


# -- int8 KV ------------------------------------------------------------------

def _int8_prompts(seed=0, lens=(12, 20, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, (n,)).astype(np.int32) for n in lens]


def test_int8_engine_token_exact_vs_jax_int8_engine(models):
    specs = [(p, 8, None) for p in _int8_prompts()]
    kw = dict(max_slots=4, chunk=4, page_size=8, kv_quant="int8")
    before = pa.paged_attention.int8_launches
    eng, jeng, _ = _pair(models, [specs], kw)
    assert pa.paged_attention.int8_launches == before   # CPU: plain version
    assert eng.kv_stats()["kv_quant"] == jeng.kv_stats()["kv_quant"] == "int8"
    kq, ksc = eng.caches[0][0]
    assert kq.dtype == torch.int8 and ksc.dtype == torch.float32
    assert tuple(ksc.shape) == (eng.pool.num_pages, CFG["num_key_value_heads"])
    assert eng.pool.free_count == eng.pool.usable


def test_int8_greedy_agreement_vs_full_precision(models):
    _, tm = models
    prompts = _int8_prompts(seed=1)
    specs = [(p, 8, None) for p in prompts]
    kw = dict(max_slots=4, chunk=4, page_size=8)
    base = _serve(BatchDecodeEngine(tm, device="cpu", **kw), specs)
    quant = _serve(BatchDecodeEngine(tm, device="cpu", kv_quant="int8", **kw),
                   specs)
    agree = np.mean([np.mean(a[len(p):] == b[len(p):])
                     for a, b, p in zip(base, quant, prompts)])
    assert agree >= 0.9, f"greedy top-1 agreement {agree} < 0.9"


def test_kv_quant_validation_flags_and_page_bytes(models):
    jm, tm = models
    with pytest.raises(ValueError, match="int4.*seam"):
        BatchDecodeEngine(tm, device="cpu", max_slots=2, kv_quant="int4")
    with pytest.raises(ValueError, match="'int8' is the supported"):
        BatchDecodeEngine(tm, device="cpu", max_slots=2, kv_quant="int3")
    with pytest.raises(ValueError, match="needs kv_layout='paged'"):
        JaxEngine(jm, max_slots=2, kv_layout="contiguous", kv_quant="int8")
    with pytest.raises(ValueError, match="needs kv_layout='paged'"):
        BatchDecodeEngine(tm, device="cpu", max_slots=2,
                          kv_layout="contiguous", kv_quant="int8")
    with pytest.raises(NotImplementedError, match="A10"):
        BatchDecodeEngine(tm, device="cpu", max_slots=2, kv_quant="int8",
                          plan=object())
    kw = dict(max_slots=2, chunk=4, page_size=8)
    for off in ("", "off"):
        assert BatchDecodeEngine(tm, device="cpu", kv_quant=off,
                                 **kw).kv_quant is None
    base = BatchDecodeEngine(tm, device="cpu", **kw)
    quant = BatchDecodeEngine(tm, device="cpu", kv_quant="int8", **kw)
    for port, jax_kw in ((base, {}), (quant, {"kv_quant": "int8"})):
        jst = JaxEngine(jm, fused_kernels=False, **kw, **jax_kw).kv_stats()
        st = port.kv_stats()
        for key in ("kv_quant", "page_bytes", "kv_bytes", "pages_total"):
            assert st[key] == jst[key], key
    assert quant.kv_stats()["page_bytes"] < base.kv_stats()["page_bytes"]
    # flags: an argument wins, a flag fills in for None
    old = (port_flags.flag_value("serving_kv_quant"),
           port_flags.flag_value("serving_kv_host_bytes"))
    try:
        port_flags._registry["FLAGS_serving_kv_quant"].value = "int8"
        port_flags._registry["FLAGS_serving_kv_host_bytes"].value = 1 << 20
        eng = BatchDecodeEngine(tm, device="cpu", **kw)
        assert eng.kv_quant == "int8" and eng.kv_host is not None
        assert eng.kv_host.max_bytes == 1 << 20
        eng = BatchDecodeEngine(tm, device="cpu", kv_quant="off",
                                kv_host_bytes=0, **kw)
        assert eng.kv_quant is None and eng.kv_host is None
        # no prefix cache, nothing to spill: no tier
        assert BatchDecodeEngine(tm, device="cpu", prefix_cache=False,
                                 **kw).kv_host is None
    finally:
        port_flags._registry["FLAGS_serving_kv_quant"].value = old[0]
        port_flags._registry["FLAGS_serving_kv_host_bytes"].value = old[1]


# -- host-RAM prefix tier -----------------------------------------------------

TIERED = dict(max_slots=1, chunk=4, page_size=8, kv_quant="int8",
              prefix_cache=True, num_pages=6, kv_host_bytes=1 << 20)


def _prefix_specs(seed=1):
    rng = np.random.default_rng(seed)
    pfx_a = rng.integers(1, 127, (16,)).astype(np.int32)
    pfx_b = rng.integers(1, 127, (16,)).astype(np.int32)
    tail = rng.integers(1, 127, (4,)).astype(np.int32)
    return ([(np.concatenate([p, tail]), 6, 16)] for p in (pfx_a, pfx_b))


def test_spill_restore_token_parity_vs_jax(models):
    """5 usable pages: B's admission spills A to the host tier, A's next
    request restores it into fresh pages and hits. Tokens equal A's first
    run, the JAX engine's, and a pool large enough that A never left the
    device; the host counters equal the JAX engine's."""
    run_a, run_b = _prefix_specs()
    eng, jeng, got = _pair(models, [run_a, run_b, run_a], TIERED)
    np.testing.assert_array_equal(got[0][0], got[2][0])
    hs, jhs = eng.kv_stats()["host"], jeng.kv_stats()["host"]
    for key in ("entries", "spills", "restores", "discards", "used_bytes"):
        if key == "used_bytes":
            continue    # slab bytes hold each framework's own f32 scales
        assert hs[key] == jhs[key], key
    assert hs["spills"] >= 1 and hs["restores"] >= 1
    assert hs["restore_ms_p50"] is not None
    assert hs["restore_ms_p99"] >= hs["restore_ms_p50"]
    assert eng.kv_stats()["prefix"] == jeng.kv_stats()["prefix"]
    assert eng.stats["restore_failures"] == 0
    _, tm = models
    big = BatchDecodeEngine(tm, device="cpu", **dict(TIERED, num_pages=32))
    _serve(big, run_a)
    again = _serve(big, run_a)
    assert big.kv_host.stats()["spills"] == 0
    np.testing.assert_array_equal(again[0], got[2][0])


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["full", "int8"])
def test_spilled_slab_holds_the_device_pages(models, kv_quant):
    """The slab the tier keeps is the evicted pages' exact bytes, framed
    as the reference frames it, so the reference reader takes it."""
    _, tm = models
    run_a, run_b = _prefix_specs()
    eng = BatchDecodeEngine(tm, device="cpu",
                            **dict(TIERED, kv_quant=kv_quant))
    _serve(eng, run_a)
    h = port_kv_pool.prefix_hash(run_a[0][0], 16)
    pages = list(eng.prefix.lookup(h).pages)
    want = [t[pages].clone() for kc, vc in eng.caches
            for t in eng._pool_tensors(kc, vc)]
    _serve(eng, run_b)                     # spills A
    assert eng.prefix.lookup(h) is None and h in eng.kv_host
    blob = eng.kv_host._entries[h].blob
    meta, arrays = jax_kv_pool.deserialize_page_slab(blob)
    assert meta == dict(eng._slab_meta(), length=16, n_pages=2)
    assert meta["dtype"] == "float32"
    assert len(arrays) == len(want) == (4 if kv_quant else 2) * 2
    for a, t in zip(arrays, want):
        assert a.tobytes() == t.numpy().tobytes()


def test_corrupt_or_foreign_slab_degrades_to_miss(models):
    jm, tm = models
    run_a, run_b = _prefix_specs()
    jeng = JaxEngine(jm, fused_kernels=False, **TIERED)
    want = _serve(jeng, run_a, jax=True)[0]
    eng = BatchDecodeEngine(tm, device="cpu", **TIERED)
    h = port_kv_pool.prefix_hash(run_a[0][0], 16)
    bad_blobs = [
        port_kv_pool.serialize_page_slab({"garbage": True},
                                         [np.zeros(4, np.int8)]),
        None,                              # truncated: filled in below
        None,                              # a full-precision engine's slab
    ]
    for i, bad in enumerate(bad_blobs):
        np.testing.assert_array_equal(_serve(eng, run_a)[0], want)
        _serve(eng, run_b)                 # spills A
        slab = eng.kv_host.pop(h)
        assert slab is not None
        if i == 1:
            bad = slab.blob[:-5]
        elif i == 2:
            full = BatchDecodeEngine(tm, device="cpu",
                                     **dict(TIERED, kv_quant=None))
            _serve(full, run_a)
            _serve(full, run_b)
            bad = full.kv_host.pop(h).blob
        eng.kv_host.put_back(h, port_kv_pool.HostSlab(
            bad, slab.length, slab.n_pages, slab.stamp))
        misses = eng.prefix.misses
        np.testing.assert_array_equal(_serve(eng, run_a)[0], want)
        assert eng.prefix.misses == misses + 1
        assert eng.stats["restore_failures"] == i + 1
        _serve(eng, run_b)                 # put A back on the host tier
        eng.kv_host.pop(h)
        _serve(eng, run_b)
    assert eng.pool.free_count + eng.prefix.cached_pages == eng.pool.usable


def test_host_tier_off_is_plain_eviction(models):
    run_a, run_b = _prefix_specs()
    kw = dict(TIERED, kv_quant=None, kv_host_bytes=None)
    eng, jeng, got = _pair(models, [run_a, run_b, run_a], kw)
    assert eng.kv_host is None and jeng.kv_host is None
    assert eng.prefix.evictions == jeng.prefix.evictions >= 1
    np.testing.assert_array_equal(got[0][0], got[2][0])
    assert eng.kv_stats()["host"] == {"enabled": False}


def test_chaos_tiered_kv_zero_leak_both_tiers(models):
    """Churn a tiny two-tier config (spills, restores, host discards) and
    audit: every device page is free, pinned by a prefix or held by a
    slot, no prefix is resident on both tiers, and the host byte ledger
    equals its slabs (tests/test_kv_quant_tier.py:350)."""
    _, tm = models
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(1, 127, (16,)).astype(np.int32)
                for _ in range(4)]
    tail = rng.integers(1, 127, (4,)).astype(np.int32)
    slab_bytes = 2 * 2 * (2 * 8 * 2 * 16 + 2 * 2 * 4)
    eng = BatchDecodeEngine(tm, device="cpu",
                            **dict(TIERED, kv_host_bytes=slab_bytes + 600))
    for i in rng.permutation(np.repeat(np.arange(4), 3)):
        _serve(eng, [(np.concatenate([prefixes[i], tail]), 4, 16)])
    st = eng.kv_host.stats()
    assert st["spills"] >= 3 and st["discards"] >= 1 and st["restores"] >= 1
    device = set(eng.prefix._entries)
    assert not device & set(eng.kv_host.keys())
    assert eng.pool.free_count + eng.prefix.cached_pages == eng.pool.usable
    assert eng.kv_host.used_bytes == sum(
        eng.kv_host._entries[h].nbytes for h in eng.kv_host.keys())


# -- ServingEngine ------------------------------------------------------------

def test_serving_engine_prefix_len_and_int8(models):
    _, tm = models
    system, prompts = _system_prompts(seed=5)
    kw = dict(max_slots=3, chunk=4, page_size=16, kv_quant="int8",
              kv_host_bytes=1 << 20)
    direct = _serve(BatchDecodeEngine(tm, device="cpu", **kw),
                    [(p, 6, len(system)) for p in prompts])
    with ServingEngine(tm, max_batch_size=3, kv_page_size=16,
                       decode_chunk=4, kv_quant="int8",
                       kv_host_bytes=1 << 20, device="cpu") as se:
        with pytest.raises(RequestValidationError, match="prefix_len"):
            se.submit(prompts[0], max_new_tokens=4, prefix_len=99)
        with pytest.raises(RequestValidationError, match="prefix_len"):
            se.submit(prompts[0], max_new_tokens=4, prefix_len=-1)
        outs = [se.generate(p, max_new_tokens=6, prefix_len=len(system),
                            timeout=120) for p in prompts]
        st = se.engine.kv_stats()
    for a, b in zip(outs, direct):
        np.testing.assert_array_equal(a, b)
    assert st["kv_quant"] == "int8" and st["host"]["enabled"]
    assert st["prefix"]["hits"] == 2 and st["prefix"]["misses"] == 1
    assert se.engine.prefix_enabled
    off = ServingEngine(tm, max_batch_size=2, kv_page_size=16,
                        prefix_cache=False, device="cpu")
    assert not off.engine.prefix_enabled and off.engine.kv_host is None
