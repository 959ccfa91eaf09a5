"""Expert parallelism on the card (``cuda`` marker; skipped without CUDA).
No JAX here: ``python -m pytest tests/test_torch_expert_parallel_card.py
-m cuda --noconftest``.

* Kernel 8 on one rank's local experts: the slot maps of a global routing
  (E 8, top-2, capacity binding) kept for experts 4..7 (the second ``ep``
  rank's) and for the second half of the tokens (the second ``dp`` rank's
  rows; slots another rank's tokens filled take the sentinel), against its
  plain version on the same inputs: f32 within 1e-5; bf16 within the
  bound of ``tests/test_torch_gather_gemm.py`` (the kernel rounds the
  hidden activation to bf16 before the second product); sentinel rows
  zero.
* ``ep2`` against one process: a 2-layer f32 MoE (d 128, h 256, E 8,
  top-2, capacity factor 0.5: entries drop, ``fused``) trained two AdamW
  steps by ``ShardedTrainStep(..., plan=train_plan("ep2",
  rules=moe_train_rules()))`` in this process (rank 0; the step starts
  rank 1 on the same card over gloo) against a one-process ``TrainStep``
  on the same weights: losses within 1e-5 relative (the partial combine's
  two-rank sum is the only reordering), every synced parameter within
  1e-4 (a tenth of one step's move at lr 1e-3); kernel 8 launched layers
  x steps on each rank; the worker gone after ``close()``.
"""

import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
LAYERS = 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    from paddlepaddle_tpu_torch.ops.kernels import _build

    _build.build_all(["gather_gemm", "gather_gemm_sm90", "flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel8_on_local_experts_matches_plain_on_card(dtype):
    _card()
    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg
    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    T, E, C, d, h = 512, 8, 96, 128, 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(T, d, device="cuda", generator=gen)
    logits = x @ torch.randn(d, E, device="cuda", generator=gen)
    E_loc, T_loc = E // 2, T // 2
    _, _, soe, valid, slot_token = tmoe._local_capacity_maps(
        logits, 2, E, C, T_loc, T_loc, E_loc, E_loc)
    # drops, and slots of this rank's and of the other rank's tokens
    assert bool((soe < 0).any()) and 0 < int(valid.sum()) < E_loc * C
    assert bool((slot_token[~valid] == T_loc).all())
    slot = slot_token.to(torch.int32)
    xl = x[T_loc:].to(dtype).contiguous()
    wg, wu = (torch.randn(E_loc, d, h, device="cuda", generator=gen)
              .div_(d ** 0.5).to(dtype) for _ in range(2))
    wd = torch.randn(E_loc, h, d, device="cuda", generator=gen) \
        .div_(h ** 0.5).to(dtype)
    gg.gather_gemm_ffn.launches = 0
    got = gg.gather_gemm_ffn(xl, slot, wg, wu, wd, capacity=C)
    want = gg.gather_gemm_ffn_plain(xl, slot, wg, wu, wd, capacity=C)
    torch.cuda.synchronize()
    assert gg.gather_gemm_ffn.launches == 1
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        allowed = gg.bf16_error_bound(xl, slot, wg, wu, wd, capacity=C,
                                      plain=want)
        assert bool((err <= allowed).all()), float((err / allowed).max())
    assert not bool(got[~valid].any())


def _moe_cfg(pt):
    return pt.MoEConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=LAYERS, num_attention_heads=2,
        num_key_value_heads=2, num_experts=8, num_experts_per_tok=2,
        capacity_factor=0.5, max_position_embeddings=256, dtype="float32",
        dispatch_mode="fused")


def _loss(m, i, l):  # noqa: E741
    return m(i, labels=l)


def test_ep2_in_one_process_matches_one_process_on_card():
    _card()
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import moe_train_rules, train_plan
    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    cfg = _moe_cfg(pt)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 128))).cuda()
    m1 = pt.MoEForCausalLM(cfg, seed=1)
    one = pt.TrainStep(m1, pt.AdamW(learning_rate=1e-3,
                                    parameters=m1.parameters()), _loss)
    want = [float(one(ids, ids)) for _ in range(2)]
    m2 = pt.MoEForCausalLM(cfg, seed=1)
    step = ShardedTrainStep(m2, pt.AdamW(learning_rate=1e-3,
                                         parameters=m2.parameters()),
                            _loss, plan=train_plan("ep2",
                                                   rules=moe_train_rules()))
    try:
        step._rank_stats(reset=True)
        got = [float(step(ids, ids)) for _ in range(2)]
        stats = step._rank_stats()
        step.sync_to_model()
        pids = step.workers.pids
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for (name, p), q in zip(m2.named_parameters(), m1.parameters()):
        np.testing.assert_allclose(p.detach().cpu().numpy(),
                                   q.detach().cpu().numpy(), atol=1e-4,
                                   err_msg=name)
    assert tuple(step.params["layers.0.mlp.w_gate_proj"].shape) == \
        (4, 128, 256)
    for r in stats:
        assert r["launches"]["gather_gemm_ffn"] == LAYERS * 2, stats
        assert r["launches"]["flash_fwd"] == LAYERS * 2, stats
    assert gg.gather_gemm_ffn.launches >= LAYERS * 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
