"""The port's auto-tuner (``paddlepaddle_tpu_torch/distributed/
auto_tuner.py``) against the JAX package's (``paddlepaddle_tpu/distributed/
auto_tuner.py``) on the CPU.

The five tuner tests of reference ``tests/test_rpc_tuner_geometric.py``
:46-181 run against both packages, with the JAX package's cost-model
numbers (a TPU's: 16 GiB, 197 TFLOP/s, 45 GB/s, 5 us) passed to the port
explicitly; every candidate's estimates, every prune reason and the rank
order must then be the reference's. The port's own defaults are an H100's,
and without a card ``hbm_bytes`` must be given.
"""

import inspect

import pytest
import torch

from paddlepaddle_tpu.distributed import auto_tuner as JT
from paddlepaddle_tpu_torch.distributed import auto_tuner as TT

# the JAX package's defaults (its auto_tuner.py:114-118), passed explicitly
REF_NUMBERS = dict(hbm_bytes=16 * 2 ** 30, peak_flops=197e12,
                   ici_bandwidth=4.5e10, collective_latency=5e-6)


def _tuners(num_devices, **kw):
    return (TT.AutoTuner(num_devices, **dict(REF_NUMBERS, **kw)),
            JT.AutoTuner(num_devices, **kw))


def _row(c):
    return (c.key(), c.est_param_bytes_per_chip,
            c.est_activation_bytes_per_chip, c.est_total_bytes_per_chip,
            c.est_step_time, c.pruned_reason, c.measured_step_time)


def _tune_both(num_devices, hist=None, run_fn=None, top_k=3, **spec):
    out = []
    for t in _tuners(num_devices, history_path=hist):
        out.append(t.tune(run_fn=run_fn, top_k=top_k, **spec))
    return out


@pytest.mark.parametrize("spec", [
    dict(num_params=7_000_000_000, batch_size=8, seq_len=2048, hidden=4096,
         layers=32),
    dict(num_params=1_000_000, batch_size=8, seq_len=128, hidden=64,
         layers=2),
    dict(num_params=8_000_000_000, batch_size=64, seq_len=2048,
         hidden=4096, layers=32, heads=32, kv_heads=8, vocab=128256)])
def test_candidates_estimates_prunes_and_order_equal_the_reference(spec):
    n = 64 if spec["batch_size"] == 64 else 8
    tp, tj = _tuners(n)
    sp, sj = TT.ModelSpec(**spec), JT.ModelSpec(**spec)
    cp = [tp.estimate(c, sp) for c in tp.candidates(spec=sp)]
    cj = [tj.estimate(c, sj) for c in tj.candidates(spec=sj)]
    survivors_p, survivors_j = tp.prune(cp, spec=sp), tj.prune(cj, spec=sj)
    assert [_row(c) for c in cp] == [_row(c) for c in cj]
    assert [c.key() for c in tp.rank(survivors_p)] == \
        [c.key() for c in tj.rank(survivors_j)]
    assert [_row(c) for c in tp.prune(cp)] == [_row(c) for c in tj.prune(cj)]
    ranked_p, ranked_j = _tune_both(n, **spec)
    assert [_row(c) for c in ranked_p] == [_row(c) for c in ranked_j]


def test_auto_tuner_candidates_and_pruning():
    for tuner in _tuners(8):
        ranked = tuner.tune(num_params=7_000_000_000, batch_size=8,
                            seq_len=2048, hidden=4096, layers=32)
        assert ranked, "no surviving config"
        for c in ranked:
            assert c.dp * c.fsdp * c.tp * c.pp == 8
            assert c.est_total_bytes_per_chip <= 16 * 2 ** 30
            assert c.tp * c.fsdp * c.pp > 1
        small = tuner.tune(num_params=1_000_000, batch_size=8, seq_len=128,
                           hidden=64, layers=2)
        assert small[0].pp == 1 and small[0].tp == 1


def test_auto_tuner_pruning_reasons_and_model_rules():
    got = []
    for tuner, mod in zip(_tuners(8), (TT, JT)):
        spec = mod.ModelSpec(num_params=100_000_000, batch_size=8,
                             seq_len=512, hidden=512, layers=6, heads=6,
                             kv_heads=3, vocab=1000)
        cfgs = [tuner.estimate(c, spec) for c in tuner.candidates(spec=spec)]
        survivors = tuner.prune(cfgs, spec=spec)
        pruned = [c for c in cfgs if c.pruned_reason]
        assert survivors and pruned
        assert all(c.tp in (1, 2) for c in survivors)
        assert all(c.pp == 1 or 6 % c.pp == 0 for c in survivors)
        reasons = " ".join(c.pruned_reason for c in pruned)
        assert "heads" in reasons and "% pp" in reasons
        got.append([(c.key(), c.pruned_reason) for c in cfgs])
    assert got[0] == got[1]


def test_auto_tuner_recorder_resume(tmp_path):
    spec = dict(num_params=50_000_000, batch_size=8, seq_len=256, hidden=256,
                layers=4)
    results = []
    for i, tuner_cls in enumerate((TT.AutoTuner, JT.AutoTuner)):
        hist = str(tmp_path / f"trials{i}.jsonl")
        calls = []

        def run_fn(cfg):
            calls.append(cfg.key())
            return 0.01 * (cfg.tp + cfg.pp)

        kw = REF_NUMBERS if tuner_cls is TT.AutoTuner else {}
        best = tuner_cls(8, history_path=hist, **kw).tune(
            run_fn=run_fn, top_k=2, **spec)
        assert best and best[0].measured_step_time is not None
        assert len(calls) == 2
        t2 = tuner_cls(8, history_path=hist, **kw)
        best2 = t2.tune(run_fn=run_fn, top_k=2, **spec)
        assert len(calls) == 2  # resumed from the history: no re-run
        assert best2[0].key() == best[0].key()
        assert t2.recorder.best()["measured_step_time"] == \
            best[0].measured_step_time
        results.append(([_row(c) for c in best2], open(hist).read()))
    assert results[0] == results[1]   # the same history file, line for line


def test_auto_tuner_cost_model_prefers_sharding_for_big_models():
    for t8 in _tuners(8):
        assert t8.tune(num_params=8_000_000_000, batch_size=16, seq_len=2048,
                       hidden=4096, layers=32, heads=32, kv_heads=8,
                       vocab=128256) == []
    for t in _tuners(64):
        top = t.tune(num_params=8_000_000_000, batch_size=64, seq_len=2048,
                     hidden=4096, layers=32, heads=32, kv_heads=8,
                     vocab=128256)[0]
        assert top.fsdp * top.tp * top.pp > 1
        assert 0 < top.est_step_time < 60
        assert top.est_total_bytes_per_chip < 16 * 2 ** 30 * 0.9


def test_auto_tuner_recorder_scoped_by_model(tmp_path):
    for i, (tuner) in enumerate(_tuners(8, history_path=str(
            tmp_path / "t.jsonl"))):
        calls = []

        def run_fn(cfg):
            calls.append(cfg.key())
            return 0.01

        tuner.recorder.history.clear()
        tuner.tune(num_params=50_000_000 + i, batch_size=8, seq_len=256,
                   hidden=256, layers=4, run_fn=run_fn, top_k=1)
        n = len(calls)
        tuner.tune(num_params=100_000_000 + i, batch_size=8, seq_len=256,
                   hidden=256, layers=4, run_fn=run_fn, top_k=1)
        assert len(calls) == n + 1


def test_defaults_are_the_cards_not_a_tpus():
    sig = inspect.signature(TT.AutoTuner.__init__).parameters
    defaults = {k: p.default for k, p in sig.items()}
    for key, tpu in REF_NUMBERS.items():
        assert defaults[key] != tpu, key
    assert defaults["hbm_bytes"] is None
    assert defaults["peak_flops"] == 989e12          # H100 SXM dense bf16
    assert defaults["ici_bandwidth"] == 450e9        # NVLink 4, a direction
    src = inspect.getsource(TT)
    for tpu in ("197e12", "4.5e10", "16 * 2 ** 30"):
        assert tpu not in src
    if torch.cuda.is_available():
        assert TT.AutoTuner(2).hbm_bytes == \
            torch.cuda.get_device_properties(0).total_memory
    else:
        with pytest.raises(ValueError, match="hbm_bytes"):
            TT.AutoTuner(2)
    assert TT.AutoTuner(2, hbm_bytes=80e9).hbm_bytes == 80e9
