"""The port's input pipeline (``paddlepaddle_tpu_torch/io``) against the JAX
package's (``paddlepaddle_tpu/io``) on the CPU.

* Datasets: the same items from both packages' ``TensorDataset``,
  ``ComposeDataset``, ``ChainDataset``, ``ConcatDataset`` and ``Subset``.
* The deterministic samplers (``SequenceSampler``, ``BatchSampler``,
  ``DistributedBatchSampler``) give the reference's index streams bit for
  bit, for every ``num_replicas`` 1-4, ``rank``, ``shuffle``,
  ``drop_last`` and three epochs (iteration and ``set_epoch``).
* The random samplers and ``random_split`` draw from the port's generator
  where the reference draws JAX keys (ROADMAP, the sixth divergence), so
  they are held to their contract: a permutation (or draws in range, or
  draws with the weights' frequencies), reproducible under ``seed``.
* DataLoader batches equal the reference DataLoader's, leaf for leaf and
  dtype for dtype, with ``num_workers`` 0, threads and 2 processes, for a
  map-style and an iterable dataset; ``default_collate_fn`` keeps the
  reference's dtypes.
* The counterparts of reference ``tests/test_dataloader_workers.py``
  :131-234 (worker_init_fn and order, persistent workers, an abandoned
  epoch, a dead worker's pool replaced, iterable self-sharding, the
  picklability fallback to fork, an explicit spawn refusing, an explicit
  fork, a killed worker raising); its timing test (:107) is left out.
* The ``dataloader`` span reaches the step-time decomposition.
"""

import os
import signal

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu.io as jio
import paddlepaddle_tpu_torch as pt
import paddlepaddle_tpu_torch.io as tio

import torch_io_datasets as D

PORT_IO, REF_IO = "paddlepaddle_tpu_torch.io", "paddlepaddle_tpu.io"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _leaves(batch):
    if isinstance(batch, (list, tuple)):
        return [leaf for b in batch for leaf in _leaves(b)]
    if isinstance(batch, dict):
        return [leaf for k in sorted(batch) for leaf in _leaves(batch[k])]
    return [_np(batch)]


def _assert_batches_equal(port, ref):
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        la, lb = _leaves(a), _leaves(b)
        assert len(la) == len(lb), i
        for x, y in zip(la, lb):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, (i, x, y)
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, i


# -- datasets ----------------------------------------------------------------

def test_datasets_give_the_reference_items():
    a = np.arange(12).reshape(6, 2).astype(np.int64)
    b = np.arange(6).astype(np.float32)
    cases = []
    for io in (tio, jio):
        t = io.TensorDataset([a, b])
        c = io.ComposeDataset([t, io.TensorDataset([b * 2])])
        cat = io.ConcatDataset([t, io.Subset(t, [5, 0, 3])])
        chain = io.ChainDataset([[1, 2], [3]])
        cases.append(([t[i] for i in range(len(t))],
                      [c[i] for i in range(len(c))],
                      [cat[i] for i in range(len(cat))] + [cat[-1]],
                      [x for x in chain], len(t), len(c), len(cat)))
    for x, y in zip(*cases):
        if isinstance(x, int):
            assert x == y
            continue
        assert len(x) == len(y)
        for u, v in zip(x, y):
            for p, q in zip(u if isinstance(u, tuple) else [u],
                            v if isinstance(v, tuple) else [v]):
                np.testing.assert_array_equal(p, q)
    with pytest.raises(RuntimeError):
        len(tio.ChainDataset([]))


# -- deterministic samplers, bit for bit --------------------------------------

def test_sequence_and_batch_samplers_match_the_reference():
    ds = list(range(11))
    assert list(tio.SequenceSampler(ds)) == list(jio.SequenceSampler(ds))
    for bs in (1, 3, 4, 11, 13):
        for drop in (False, True):
            p = tio.BatchSampler(ds, batch_size=bs, drop_last=drop)
            r = jio.BatchSampler(ds, batch_size=bs, drop_last=drop)
            assert list(p) == list(r) and len(p) == len(r)
            p = tio.BatchSampler(sampler=tio.SequenceSampler(ds[:7]),
                                 batch_size=bs, drop_last=drop)
            r = jio.BatchSampler(sampler=jio.SequenceSampler(ds[:7]),
                                 batch_size=bs, drop_last=drop)
            assert list(p) == list(r) and len(p) == len(r)


@pytest.mark.parametrize("n", [1, 7, 16, 23])
def test_distributed_batch_sampler_matches_the_reference(n):
    ds = list(range(n))
    for world in (1, 2, 3, 4):
        for rank in range(world):
            for shuffle in (False, True):
                for drop in (False, True):
                    kw = dict(num_replicas=world, rank=rank,
                              shuffle=shuffle, drop_last=drop)
                    p = tio.DistributedBatchSampler(ds, 3, **kw)
                    r = jio.DistributedBatchSampler(ds, 3, **kw)
                    assert len(p) == len(r)
                    assert (p.num_samples, p.total_size) == \
                        (r.num_samples, r.total_size)
                    for _ in range(3):   # epochs advance while iterating
                        assert list(p) == list(r), (world, rank, kw)
                    p.set_epoch(7)
                    r.set_epoch(7)
                    assert list(p) == list(r)


def test_distributed_batch_sampler_defaults_to_the_live_world(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    s = tio.DistributedBatchSampler(list(range(9)), 2)
    assert (s.nranks, s.local_rank) == (3, 1)
    assert list(s) == [[1, 4], [7]]


# -- random samplers: the contract under seed ---------------------------------

def test_random_samplers_are_permutations_reproducible_under_seed():
    ds = list(range(40))

    def draw():
        return (list(tio.RandomSampler(ds)),
                list(tio.RandomSampler(ds, num_samples=10)),
                list(tio.RandomSampler(ds, replacement=True,
                                       num_samples=60)),
                list(tio.SubsetRandomSampler([5, 9, 11, 2])),
                [s.indices for s in tio.random_split(ds, [30, 10])],
                [len(s) for s in tio.random_split(ds, [0.5, 0.25, 0.25])])

    pt.seed(11)
    a = draw()
    pt.seed(11)
    assert draw() == a
    pt.seed(12)
    assert draw() != a
    perm, head, rep, sub, split, sizes = a
    assert sorted(perm) == ds and perm != ds
    assert len(head) == 10 and len(set(head)) == 10
    assert len(rep) == 60 and all(0 <= i < 40 for i in rep)
    assert sorted(sub) == [2, 5, 9, 11]
    assert sorted(split[0] + split[1]) == ds and len(split[0]) == 30
    assert sizes == [20, 10, 10]
    # the JAX package's RandomSampler is a permutation too
    assert sorted(jio.RandomSampler(ds)) == ds


def test_weighted_random_sampler_draws_with_the_weights():
    w = [0.0, 1.0, 3.0, 0.0, 4.0]
    pt.seed(5)
    draws = list(tio.WeightedRandomSampler(w, 8000))
    pt.seed(5)
    assert list(tio.WeightedRandomSampler(w, 8000)) == draws
    counts = np.bincount(draws, minlength=5) / len(draws)
    assert counts[0] == 0 and counts[3] == 0
    np.testing.assert_allclose(counts, np.asarray(w) / sum(w), atol=0.03)
    once = list(tio.WeightedRandomSampler(w, 3, replacement=False))
    assert sorted(once) == [1, 2, 4]
    assert len(tio.WeightedRandomSampler(w, 3)) == 3


# -- DataLoader batches against the reference's -------------------------------

MODES = {"sync": dict(num_workers=0),
         "threads": dict(num_workers=2, use_multiprocess=False),
         "procs": dict(num_workers=2)}


def test_default_collate_keeps_the_reference_dtypes():
    samples = [{"a": np.ones(2, np.float32), "n": 3, "f": 0.5, "s": "x",
                "t": (np.int32(4), [1.5, 2])} for _ in range(3)]
    got = tio.default_collate_fn(samples)
    want = jio.dataloader.default_collate_fn(samples)
    assert isinstance(got["a"], torch.Tensor) and got["s"] == ["x"] * 3
    _assert_batches_equal([got], [want])
    assert got["n"].dtype == torch.int64 and got["f"].dtype == torch.float32


def test_map_batches_equal_the_reference_in_every_mode():
    ds = D.Rows()
    sampler_args = dict(num_replicas=2, rank=1, shuffle=True)
    # a map-style loader's order is its sampler's in every mode (the
    # reference's own tests hold its modes to each other)
    ref = [list(jio.DataLoader(ds, batch_size=3)),
           list(jio.DataLoader(ds, batch_sampler=jio.DistributedBatchSampler(
               ds, 3, **sampler_args)))]
    for mode, kw in MODES.items():
        got = list(tio.DataLoader(ds, batch_size=3, device="cpu", **kw))
        assert all(b[0].device.type == "cpu" for b in got)
        _assert_batches_equal(got, ref[0])
        got = list(tio.DataLoader(
            ds, batch_sampler=tio.DistributedBatchSampler(ds, 3,
                                                          **sampler_args),
            device="cpu", **kw))
        _assert_batches_equal(got, ref[1])


def test_iterable_batches_equal_the_reference_in_every_mode():
    ref = {mode: list(jio.DataLoader(D.RefStream(REF_IO), batch_size=3,
                                     **kw))
           for mode, kw in (("sync", MODES["sync"]),
                            ("procs", MODES["procs"]))}
    ref["threads"] = ref["sync"]
    for mode, kw in MODES.items():
        got = list(tio.DataLoader(D.PortStream(PORT_IO), batch_size=3,
                                  device="cpu", **kw))
        _assert_batches_equal(got, ref[mode])
    # two processes interleave the workers' self-sharded halves
    assert len(ref["procs"]) == 6


def test_loader_needs_the_card_unless_the_cpu_is_given():
    if torch.cuda.is_available():
        pytest.skip("the loader legitimately defaults to the card here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.DataLoader(D.Plain(), batch_size=2)
    dl = tio.DataLoader(D.Plain(4), batch_size=2, places=["cpu"])
    assert dl.device == torch.device("cpu") and len(dl) == 2


# -- worker processes (reference tests/test_dataloader_workers.py:131-234) ---

def _flat(loader):
    return np.concatenate([b.numpy().ravel() for b in loader])


def test_worker_init_fn_and_order():
    loader = tio.DataLoader(D.Arange(PORT_IO), batch_size=2, num_workers=2,
                            worker_init_fn=D.record_init, device="cpu")
    np.testing.assert_array_equal(_flat(loader), np.arange(10))
    assert D.init_calls == []  # init ran in the workers, not the parent
    assert tio.get_worker_info() is None  # the main process sees None


def test_persistent_workers_reuse_pool():
    loader = tio.DataLoader(D.Pid(), batch_size=2, num_workers=2,
                            persistent_workers=True, device="cpu")
    pids1 = {int(b.numpy()[0, 0]) for b in loader}
    pool1 = loader._pool
    pids2 = {int(b.numpy()[0, 0]) for b in loader}
    assert loader._pool is pool1 and pool1.alive
    assert pids1 == pids2
    assert os.getpid() not in pids1  # loading happened in children
    loader._pool.shutdown()


def test_abandoned_epoch_does_not_leak_stale_batches():
    dl = tio.DataLoader(D.Plain(), batch_size=2, num_workers=2,
                        persistent_workers=True, device="cpu")
    it = iter(dl)
    np.testing.assert_array_equal(next(it).numpy().ravel(), [0, 1])
    del it  # abandon mid-epoch
    np.testing.assert_array_equal(_flat(dl), np.arange(16))
    dl._pool.shutdown()


def test_dead_worker_pool_is_replaced_not_hung():
    dl = tio.DataLoader(D.Bad(), batch_size=2, num_workers=2,
                        persistent_workers=True, device="cpu")
    with pytest.raises(tio.DataLoaderWorkerError, match="boom"):
        list(dl)
    assert dl._pool is None  # a broken pool is not kept for reuse
    assert issubclass(tio.DataLoaderWorkerError, RuntimeError)


def test_iterable_dataset_self_sharding():
    loader = tio.DataLoader(D.PortStream(PORT_IO), batch_size=2,
                            num_workers=2, device="cpu")
    assert sorted(int(x) for b in loader for x in b.numpy().ravel()) == \
        list(range(16))


def test_unpicklable_dataset_falls_back_to_fork_with_warning():
    class Local(tio.Dataset):
        def __getitem__(self, i):
            return np.array([i], np.int64)

        def __len__(self):
            return 6

    with pytest.warns(UserWarning, match="falling back to the 'fork'"):
        loader = tio.DataLoader(Local(), batch_size=2, num_workers=2,
                                device="cpu")
        flat = _flat(loader)
    np.testing.assert_array_equal(flat, np.arange(6))


def test_explicit_spawn_with_unpicklable_dataset_raises(monkeypatch):
    class Local(tio.Dataset):
        def __getitem__(self, i):
            return np.array([i], np.int64)

        def __len__(self):
            return 4

    monkeypatch.setenv("PADDLE_TPU_MP_START_METHOD", "spawn")
    with pytest.raises(RuntimeError, match="picklable"):
        list(tio.DataLoader(Local(), batch_size=2, num_workers=2,
                            device="cpu"))


def test_explicit_fork_still_works(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MP_START_METHOD", "fork")
    loader = tio.DataLoader(D.Plain(8), batch_size=2, num_workers=2,
                            device="cpu")
    np.testing.assert_array_equal(_flat(loader), np.arange(8))


def test_killed_worker_raises_instead_of_hanging():
    from paddlepaddle_tpu_torch import observability as obs

    before = obs.snapshot().get("paddle_dataloader_worker_deaths_total",
                                {}).get((), 0)
    dl = tio.DataLoader(D.Slow(), batch_size=2, num_workers=2,
                        persistent_workers=True, device="cpu")
    it = iter(dl)
    next(it)
    os.kill(dl._pool.procs[0].pid, signal.SIGKILL)
    with pytest.raises(RuntimeError, match="died unexpectedly"):
        for _ in it:
            pass
    dl._pool.shutdown()
    after = obs.snapshot()["paddle_dataloader_worker_deaths_total"][()]
    assert after >= before + 1


# -- observability: the dataloader span feeds the step timeline ---------------

def test_dataloader_wait_feeds_the_step_timeline():
    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.io import dataloader as dl_mod

    obs.reset()
    obs.enable(trace=True, metrics=True, watchdog_=False)
    try:
        tl = obs.perf.timeline()
        loader = tio.DataLoader(D.Plain(8), batch_size=2, device="cpu")
        it = iter(loader)
        for _ in range(4):
            with tl.step("train"):
                next(it)
        snap = obs.snapshot()
        assert snap["paddle_dataloader_batches_total"][()] == 4
        assert snap["paddle_dataloader_wait_seconds"][()]["count"] == 4
        assert "dataloader_wait" in obs.get_recorder().stats()
        assert "DataLoader" in obs.summary()
        assert dl_mod._obs_io is not None
    finally:
        obs.disable()
        obs.reset()
    assert dl_mod._obs_io is None
