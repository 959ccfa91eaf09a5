"""The fsdp axis and the auto-parallel API on the card (``cuda`` marker;
skipped without CUDA). No JAX here: ``python -m pytest
tests/test_torch_fsdp_card.py -m cuda --noconftest``.

* ``DistModel`` (``to_static``) on ``fsdp2`` with the Llama table, in this
  process (rank 0; its sharded step starts rank 1 on the same card over
  gloo): an f32 Llama (hidden 512, head dim 128, 2 layers) trained two
  momentum steps (lr 0.2) against a one-process ``TrainStep`` on the same
  weights: losses within 1e-5 relative (the gathers are exact, the
  data-parallel sums reorder), the predicted logits on the synced weights
  within 1e-4 of the one-process model's; kernels 2-4 launched layers x
  steps on each rank, each rank holding half of every matrix.
* ``shard_tensor`` / ``reshard`` with CUDA tensors on two ranks that share
  the card over gloo (the port's ``spawn``; rank body
  ``tests/torch_dist_workers.py:sharding_api_card_session``): every pair
  of ``Replicate``, ``Shard(0)``, ``Shard(1)`` and ``Partial`` ->
  ``Replicate`` keeps the global value, exactly, on the card (each rank
  notes its progress in the test's temporary directory).
"""

import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
LAYERS = 2
CFG = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
           num_hidden_layers=LAYERS, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=512)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    from paddlepaddle_tpu_torch.ops.kernels import _build

    _build.build_all(["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False


def _opt(pt, model):
    # momentum moves each parameter by its gradient's scale: Adam would
    # turn f32 rounding of near-cancelling gradients into 1e-4 moves
    return pt.Momentum(learning_rate=0.2, momentum=0.9,
                       parameters=model.parameters())


def test_dist_model_on_fsdp2_matches_one_process_on_card():
    _card()
    import paddlepaddle_tpu_torch as pt
    import paddlepaddle_tpu_torch.distributed as D
    from paddlepaddle_tpu_torch.models.llama import llama_sharding_rules

    cfg = pt.LlamaConfig(**CFG)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 128))).cuda()
    m1 = pt.LlamaForCausalLM(cfg, seed=1)
    one = pt.TrainStep(m1, _opt(pt, m1), lambda m, i, l: m(i, labels=l))
    want = [float(one(ids, ids)) for _ in range(2)]
    with torch.no_grad():
        want_logits = m1(ids)
    m2 = pt.LlamaForCausalLM(cfg, seed=1)
    dm = D.to_static(m2, None, pt.LlamaForCausalLM.loss_from_logits,
                     _opt(pt, m2),
                     mesh=D.ProcessMesh(shape=[2], dim_names=["fsdp"]),
                     rules=llama_sharding_rules())
    try:
        step = dm._step
        step._rank_stats(reset=True)
        got = [float(dm(ids, ids)) for _ in range(2)]
        stats = step._rank_stats()
        q = tuple(step.params["model.layers.0.self_attn.q_proj.weight"]
                  .shape)
        pids = step.workers.pids
        dm.predict()
        logits = dm(ids)
    finally:
        dm.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float((logits - want_logits).abs().max()) <= 1e-4
    assert q == (256, 512)
    for r in stats:
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert r["launches"][k] == LAYERS * 2, stats
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_shard_tensor_and_reshard_keep_the_global_value_on_card(tmp_path):
    _card()
    import torch_dist_workers as W

    from paddlepaddle_tpu_torch.distributed import spawn

    x = np.random.default_rng(4).standard_normal((4, 6)).astype(np.float32)
    kinds = [("R",), ("S", 0), ("S", 1)]
    pairs = [([2], ["x"], [a], [b]) for a in kinds for b in kinds]
    pairs.append(([2], ["x"], [("P", "sum")], [("R",)]))
    ranks = spawn(W.sharding_api_card_session,
                  args=(x, pairs, str(tmp_path)), nprocs=2, timeout=300,
                  pg_timeout=120)
    for r in ranks:
        for (_, _, _, dst), got in zip(pairs, r["pairs"]):
            np.testing.assert_array_equal(got["src_global"], x)
            np.testing.assert_array_equal(got["global"], x)
            assert got["device"].startswith("cuda")
            assert got["placements"] == [
                "Replicate()" if dst[0][0] == "R"
                else f"Shard(dim={dst[0][1]})"]
