"""The port's copy of the paged-KV host bookkeeping
(paddlepaddle_tpu_torch/inference/kv_pool.py) runs the JAX package's own unit
cases, side by side with the reference module, and hashes prefixes alike."""

import numpy as np
import pytest

from paddlepaddle_tpu.inference import kv_pool as jax_kv_pool
from paddlepaddle_tpu_torch.inference import kv_pool as port_kv_pool

MODULES = pytest.mark.parametrize("kv", [jax_kv_pool, port_kv_pool],
                                  ids=["jax", "port"])


@MODULES
def test_page_pool_unit(kv):
    pool = kv.PagePool(num_pages=9, page_size=16)
    assert pool.usable == 8 and pool.free_count == 8 and pool.used == 0
    a = pool.alloc(3)
    assert len(a) == 3 and 0 not in a          # null page never handed out
    assert pool.used == 3 and pool.peak_used == 3
    b = pool.alloc(5)
    assert pool.free_count == 0 and pool.peak_used == 8
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(1)
    pool.free(a)
    assert pool.free_count == 3 and pool.peak_used == 8
    with pytest.raises(ValueError, match="double free"):
        pool.free([a[0]])
    with pytest.raises(ValueError, match="invalid page"):
        pool.free([0])
    pool.free(b)
    assert pool.used == 0
    assert kv.pages_needed(96, 16) == 6 and kv.pages_needed(97, 16) == 7


@MODULES
def test_prefix_cache_refcount_and_lru_eviction(kv):
    pool = kv.PagePool(num_pages=11, page_size=16)
    cache = kv.PrefixCache()
    pa, pb, pc = pool.alloc(2), pool.alloc(2), pool.alloc(2)
    cache.register("a", pa, 32)
    cache.register("b", pb, 32)
    cache.register("c", pc, 32)
    assert cache.evict_until(pool, 10) == 0   # every entry still referenced
    cache.unref("a")
    cache.unref("b")
    cache.ref("b")
    cache.unref("b")
    assert cache.evict_until(pool, 6) == 1    # "a": LRU among refcount 0
    assert cache.lookup("a") is None and cache.lookup("b") is not None
    assert pool.free_count == 6 and cache.evictions == 1
    assert cache.evict_until(pool, 10) == 1   # "b" goes too, "c" is held
    assert pool.free_count == 8 and cache.lookup("c") is not None
    cache.unref("c")
    cache.clear(pool)
    assert len(cache) == 0 and pool.free_count == 10


def test_prefix_hash_matches_reference():
    ids = np.arange(64, dtype=np.int32)
    assert port_kv_pool.prefix_hash(ids, 32) == jax_kv_pool.prefix_hash(ids, 32)
    assert port_kv_pool.prefix_hash(ids, 32) != port_kv_pool.prefix_hash(ids, 16)
