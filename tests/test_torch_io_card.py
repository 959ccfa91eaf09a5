"""The DataLoader onto the card (``cuda`` marker; skipped without CUDA). No
JAX here: ``python -m pytest tests/test_torch_io_card.py -m cuda
--noconftest``.

* **Forked workers beside a live CUDA context.** With CUDA initialised in
  the parent, two workers forked from it (``PADDLE_TPU_MP_START_METHOD=
  fork``) load batches that never touch the card; the parent copies them
  to ``cuda``. Every batch equals the CPU loader's, bit for bit, over 3
  epochs of a shuffled ``DistributedBatchSampler`` with persistent workers;
  the same through the default ``forkserver`` workers.
* **The copy against the step.** A step that keeps the card busy and then
  writes its input batch in place before dropping it (what an in-place op
  of a train step does) must never change a later batch: each copy is
  queued on the consumer's stream behind the steps before it, and its
  page-locked source is not reused before the copy has run. Every batch,
  snapshotted on the card the moment it arrives, equals the CPU
  loader's.
"""

import os

import numpy as np
import pytest
import torch

import torch_io_datasets as D

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _loaders(ds, device, **kw):
    from paddlepaddle_tpu_torch.io import DataLoader, DistributedBatchSampler

    sampler = DistributedBatchSampler(ds, 8, num_replicas=2, rank=1,
                                      shuffle=True)
    return DataLoader(ds, batch_sampler=sampler, device=device, **kw)


def _epochs(loader, n=3):
    out = []
    for _ in range(n):
        epoch = []
        for b in loader:
            assert all(t.device == loader.device for t in b)
            epoch.append(tuple(t.cpu() for t in b))
        out.append(epoch)
    return out


def _same(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for bg, bw in zip(eg, ew):
            for tg, tw in zip(bg, bw):
                assert tg.dtype == tw.dtype and torch.equal(tg, tw)


@pytest.mark.parametrize("method", ["fork", "forkserver"])
def test_card_batches_equal_the_cpu_loaders(monkeypatch, method):
    _card()
    monkeypatch.setenv("PADDLE_TPU_MP_START_METHOD", method)
    torch.ones(1, device="cuda").sum().item()        # a live CUDA context
    assert torch.cuda.is_initialized()
    ds = D.Rows(n=64, width=512)
    want = _epochs(_loaders(ds, "cpu"))
    card = _loaders(ds, "cuda", num_workers=2, persistent_workers=True)
    assert card.device.type == "cuda"
    got = _epochs(card)
    assert card._pool.start_method == method
    assert os.getpid() not in {p.pid for p in card._pool.procs}
    card._pool.shutdown()
    _same(got, want)


def test_in_place_step_never_changes_a_later_batch():
    _card()
    ds = D.Rows(n=256, width=16384)            # 128 KB of int64 a row
    want = _epochs(_loaders(ds, "cpu"), 2)
    loader = _loaders(ds, "cuda", num_workers=2, persistent_workers=True)
    for epoch in range(2):
        got = []
        for tokens, feats, idx in loader:
            got.append((tokens.clone(), feats.clone(), idx.clone()))
            torch.cuda._sleep(5_000_000)       # the step's work queues up
            tokens.mul_(-1)                    # then an in-place write
            feats.add_(1.0)
            del tokens, feats, idx             # the step drops its input
        torch.cuda.synchronize()
        _same([[tuple(t.cpu() for t in b) for b in got]], [want[epoch]])
    loader._pool.shutdown()
