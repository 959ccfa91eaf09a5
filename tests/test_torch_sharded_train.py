"""The port's ``ShardedTrainStep`` on the CPU against the JAX package's
(``paddlepaddle_tpu/parallel/sharded.py``, ``tests/test_shard_plan.py``
:264-317).

Each case trains the reference test's tiny Llama (vocab 64, hidden 32, two
layers, 4 heads, 2 KV heads) from the JAX model's initial weights for two
AdamW steps on one global batch, which every rank is given, and holds:

* the losses against the JAX ``ShardedTrainStep`` over the same plan, at
  rtol 1e-5 (``dp2``: the data-parallel sums are the only reordering) and
  1e-4 (``dp2mp2``: the row-parallel matmuls reorder the hidden sums too),
  every rank reporting the same losses;
* the parameters after ``sync_to_model()`` against a one-process port
  ``TrainStep`` on the whole batch, at 1e-5, the replicated norm weights
  included;
* the local shards' shapes (column / row halves under ``mp``);
* a ``loss_fn`` that never reports its valid-token count refused on every
  rank.

The ``dp2mp2`` case masks the labels of one row (``-100``), so the two
data-parallel ranks hold different counts of valid tokens and only a
global token mean matches, and clips by global norm (0.5), which needs the
``mp``-sharded squared norms summed over ``mp``. Ranks are spawned by the
port's ``spawn`` over gloo (4 processes for ``dp2mp2``); the rank body is
``tests/torch_dist_workers.py:train_session``.
"""

import numpy as np
import pytest

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed.shard_plan import train_plan
from paddlepaddle_tpu.models import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu.optimizer import AdamW
from paddlepaddle_tpu.parallel import ShardedTrainStep

import torch_dist_workers as W
from paddlepaddle_tpu_torch.distributed import spawn

CASES = {
    # spec: (ids seed, mask a row, clip, loss rtol)
    "dp2": (0, False, None, 1e-5),
    "dp2mp2": (1, True, 0.5, 1e-4),
}


def _batch(seed, mask):
    ids = np.random.default_rng(seed).integers(0, 64, (4, 16)).astype(np.int32)
    labels = ids.copy()
    if mask:
        labels[1, :11] = -100      # rank 0 of dp holds rows 0-1
    return ids, labels


def _jax_run(spec):
    seed, mask, clip, _ = CASES[spec]
    ids, labels = _batch(seed, mask)
    cfg = LlamaConfig.tiny(vocab_size=64, hidden_size=32, layers=2,
                           heads=4, kv_heads=2, max_len=64)
    paddle.seed(7)
    m = LlamaForCausalLM(cfg)
    state = {k: np.asarray(v).astype(np.float32)
             for k, v in m.functional_state().items()
             if k not in ("model.rope_cos", "model.rope_sin")}
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                grad_clip=paddle.nn.ClipGradByGlobalNorm(clip)
                if clip else None)
    step = ShardedTrainStep(m, opt, lambda mm, i, l: mm(i, labels=l),
                            plan=train_plan(spec, data_axes=("dp",)))
    losses = [float(step(ids, labels).numpy()) for _ in range(2)]
    return state, ids, labels, losses


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    spec = request.param
    state, ids, labels, jax_losses = _jax_run(spec)
    n = 2 if spec == "dp2" else 4
    ranks = spawn(W.train_session,
                  args=(state, ids.astype(np.int64), labels.astype(np.int64),
                        spec, CASES[spec][2]),
                  nprocs=n, timeout=240, pg_timeout=120)
    return spec, jax_losses, ranks


def test_losses_match_the_reference_sharded_step(case):
    spec, jax_losses, ranks = case
    rtol = CASES[spec][3]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jax_losses, rtol=rtol,
                                   atol=rtol * 0.1)
        assert r["losses"] == ranks[0]["losses"]


def test_losses_and_parameters_match_one_process_step(case):
    spec, _, ranks = case
    r0 = ranks[0]
    np.testing.assert_allclose(r0["losses"], r0["one_losses"],
                               rtol=CASES[spec][3])
    diffs = r0["param_diff"]
    assert set(diffs) >= {"model.norm.weight",
                          "model.layers.0.input_layernorm.weight",
                          "model.layers.1.post_attention_layernorm.weight"}
    for name, d in diffs.items():
        assert d < 1e-5, (name, d)


def test_a_loss_without_its_token_count_is_refused_under_dp(case):
    _, _, ranks = case
    for r in ranks:
        assert "valid-token count" in r["blind_loss"], r["blind_loss"]


def test_local_shards_are_the_plan_halves(case):
    spec, _, ranks = case
    shapes = ranks[0]["local_shapes"]
    if spec == "dp2":
        assert shapes["model.layers.0.self_attn.q_proj.weight"] == (32, 32)
        return
    assert shapes["model.layers.0.self_attn.q_proj.weight"] == (32, 16)
    assert shapes["model.layers.0.self_attn.o_proj.weight"] == (16, 32)
    assert shapes["model.layers.0.mlp.down_proj.weight"] == (48, 32)
    assert shapes["model.embed_tokens.weight"] == (64, 16)
    assert shapes["lm_head.weight"] == (32, 32)
    assert shapes["model.norm.weight"] == (32,)
