"""The pipeline executor and the 4D hybrid on the card (``cuda`` marker;
skipped without CUDA). No JAX here: ``python -m pytest
tests/test_torch_pipeline_card.py -m cuda --noconftest``.

* ``tp2 pp2`` on four ranks that share the card over gloo (the port's
  ``spawn``; rank body ``tests/torch_dist_workers.py:
  pipeline_card_session``): the hybrid's Llama stages (f32, hidden 256,
  head dim 64) under 1F1B and ZBH1 against ``reference_forward`` with
  plain attention on the card (loss rtol 1e-4; gradients rtol 2e-3, atol
  2e-4), and kernels 2-4 launched on every rank as often as the schedule
  predicts (``chip_smoke.pp_predicted_launches``).
* the single-process form: this process (no process group) calls
  ``spmd_pipeline_train`` over ``pp2`` with CUDA tensors, starts rank 1
  on the same card for the call, returns the oracle's values, and no
  worker is left when it returns.
"""

import multiprocessing as mp
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    from paddlepaddle_tpu_torch.ops.kernels import _build

    _build.build_all(["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("schedule", ["1f1b", "zbh1"])
def test_tp2pp2_hybrid_matches_the_oracle_on_card(schedule):
    _card()
    import torch_dist_workers as W
    from chip_smoke import pp_predicted_launches
    from paddlepaddle_tpu_torch.distributed import spawn

    ranks = spawn(W.pipeline_card_session, args=(schedule,), nprocs=4,
                  timeout=600, pg_timeout=300)
    for r in ranks:
        assert r["loss_rel"] <= 1e-4, r
        assert r["worst_over_tol"] <= 0.0, r
        assert r["launches"] == pp_predicted_launches(schedule, 1, 4, 1, 2,
                                                      r["pp"]), r


def test_single_process_form_on_card_leaves_no_worker():
    _card()
    import torch_dist_workers as W
    from chip_smoke import pp_predicted_launches
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.parallel import hybrid as H
    from paddlepaddle_tpu_torch.parallel import pipeline_spmd as ps

    dev = torch.device("cuda")
    cfg, stages, head, acts, ids = W.pp_card_problem(1, 2, dev)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = 0
    before = {p.pid for p in mp.active_children()}
    got = ps.spmd_pipeline_train(
        ps.stack_stage_params(stages), head, acts, ids,
        H.make_llama_block(cfg, tp_axis=None, fsdp_axis=None),
        H.make_vocab_parallel_head(cfg, tp_axis=None),
        ProcessMesh(shape=[2], dim_names=["pp"]), schedule="1f1b",
        n_microbatches=4, param_specs=H.llama_stage_specs(None, None),
        head_specs=H.llama_head_specs(None))
    assert {p.pid for p in mp.active_children()} - before == set()
    errs = W.pp_card_errors(got, W.pp_card_oracle(cfg, stages, head, acts,
                                                  ids))
    assert errs["loss_rel"] <= 1e-4 and errs["worst_over_tol"] <= 0.0, errs
    assert got[3].device.type == "cuda"
    # this process is pp rank 0
    assert {w.__name__: w.launches for w in (fa.flash_fwd, fa.flash_bwd_dq,
                                             fa.flash_bwd_dkv)} == \
        pp_predicted_launches("1f1b", 1, 4, 1, 2, 0)
