"""The port's tensor- and data-parallel paths on the card (``cuda``
marker; skipped without CUDA). No JAX here: ``python -m pytest
tests/test_torch_distributed_card.py -m cuda --noconftest``.

One host with one card: two ranks share ``cuda:0`` over gloo (given
explicitly; NCCL refuses two ranks on one device), the compute on the
card and only the collectives through the host; NCCL runs at world size
1. The kernel libraries are built here before the ranks are spawned, so
the ranks only load them (their ``nvcc`` runs are 0). Rank bodies:
``tests/torch_dist_workers.py`` (``card_*``).

* TP-2 decode of a 2-layer f32 Llama at head dim 128: tokens equal the
  plan-less engine's; each rank launched kernel 1 layers x decode steps
  times on its local heads; under gloo the chunk runs eagerly and
  ``capture_info()`` says why;
* NCCL at world size 1 (``decode_plan("mp1")``): the decode chunk is
  captured with the NCCL all-reduce inside, its tokens bit-equal to the
  plan-less captured engine's;
* ``ShardedTrainStep`` ``mp2`` (f32): losses within 1e-4 of a one-process
  ``TrainStep``; each rank runs kernels 2-4 on its local heads (layers x
  steps each).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddlepaddle_tpu_torch.ops.kernels import _build

    _build.build_all(["paged_attention", "flash_attention"])


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 1024, (int(n),)).astype(np.int32)
            for n in (40, 129, 77)]


def test_tp2_decode_on_a_shared_card():
    _card()
    import torch_dist_workers as W
    from paddlepaddle_tpu_torch.distributed import spawn

    ranks = spawn(W.card_decode_session,
                  args=("float32", "gloo", "mp2", _prompts(), 20),
                  nprocs=2, timeout=600, pg_timeout=300)
    r0 = ranks[0]
    for a, b in zip(r0["tokens"], r0["one_tokens"]):
        np.testing.assert_array_equal(a, b)
    for r in ranks:
        assert r["nvcc"] == 0
        assert r["steps"] > 0
        assert r["paged"] == W.CARD["num_hidden_layers"] * r["steps"]
        info = r["capture"]["decode"]
        assert info["captured"] is False and "gloo" in info["reason"]


def test_nccl_world1_captures_the_chunk_bit_equal():
    _card()
    import torch_dist_workers as W
    from paddlepaddle_tpu_torch.distributed import spawn

    (r,) = spawn(W.card_decode_session,
                 args=("bfloat16", None, "mp1", _prompts(), 20),
                 nprocs=1, timeout=600, pg_timeout=300)
    for a, b in zip(r["tokens"], r["one_tokens"]):
        np.testing.assert_array_equal(a, b)
    info = r["capture"]["decode"]
    assert info["captured"] is True and info["replays"] > 0
    assert r["nvcc"] == 0


def test_sharded_train_step_mp2_on_a_shared_card():
    _card()
    import torch_dist_workers as W
    from paddlepaddle_tpu_torch.distributed import spawn

    ranks = spawn(W.card_train_session, args=("mp2",), nprocs=2,
                  timeout=600, pg_timeout=300)
    np.testing.assert_allclose(ranks[0]["losses"], ranks[0]["one_losses"],
                               rtol=1e-4)
    L = W.CARD["num_hidden_layers"]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        assert r["flash"] == {"flash_fwd": 2 * L, "flash_bwd_dq": 2 * L,
                              "flash_bwd_dkv": 2 * L}
        assert r["nvcc"] == 0
