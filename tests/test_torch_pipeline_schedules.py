"""The port's pipeline schedule tables against the JAX package's
(``paddlepaddle_tpu/parallel/schedules.py``), which is pure numpy: the
port keeps its own copy, and every table, buffer capacity, statistic,
memory estimate, diagram and error must be the same, bit for bit. The
cases mirror ``tests/test_pipeline_schedules.py``."""

import numpy as np
import pytest

from paddlepaddle_tpu.parallel import schedules as J

from paddlepaddle_tpu_torch.parallel import schedules as T

SWEEP = [(name, S, M, V)
         for S in (2, 3, 4) for M in (1, 2, 4, 6, 8, 12)
         for name, V in (("gpipe", 1), ("1f1b", 1), ("zbh1", 1),
                         ("interleaved", 2), ("interleaved", 3),
                         ("zbvpp", 2), ("zbvpp", 3))
         if V == 1 or M % S == 0]


def _same(a, b):
    np.testing.assert_array_equal(a.ops, b.ops)
    np.testing.assert_array_equal(a.mbs, b.mbs)
    np.testing.assert_array_equal(a.chunks, b.chunks)
    assert a.ops.dtype == b.ops.dtype == np.int32
    assert (a.S, a.M, a.V) == (b.S, b.M, b.V)
    assert (a.stash_cap, a.inbox_f_cap, a.inbox_b_cap, a.gstash_cap) == (
        b.stash_cap, b.inbox_f_cap, b.inbox_b_cap, b.gstash_cap)
    assert a.gstash_entries == b.gstash_entries
    assert a.has_split_backward == b.has_split_backward
    assert a.stats == b.stats
    assert a.pretty() == b.pretty()


@pytest.mark.parametrize("S", [2, 3, 4])
def test_tables_are_bit_equal_over_the_sweep(S):
    for name, s, M, V in SWEEP:
        if s != S:
            continue
        _same(T.build_schedule(name, S, M, V), J.build_schedule(name, S, M, V))


@pytest.mark.parametrize("S,M,V", [(2, 4, 1), (3, 6, 2), (4, 8, 2)])
def test_arrival_tables_are_bit_equal(S, M, V):
    name = "interleaved" if V > 1 else "1f1b"
    for a, b in zip(T._arrival_tables(T.build_schedule(name, S, M, V)),
                    J._arrival_tables(J.build_schedule(name, S, M, V)),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_opcodes_and_names_match():
    for k in ("OP_IDLE", "OP_F", "OP_B", "OP_B_LAST", "OP_BX", "OP_BW",
              "OP_BX_LAST", "OP_BW_LAST"):
        assert getattr(T, k) == getattr(J, k), k
    assert T.OP_NAMES == J.OP_NAMES
    assert T._BX_OPS == J._BX_OPS and T._BW_OPS == J._BW_OPS


def test_schedule_legality_sweep():
    for S in (1, 2, 3, 4, 8):
        for M in (1, 2, 4, 8, 16):
            _same(T.build_gpipe(S, M), J.build_gpipe(S, M))
            _same(T.build_1f1b(S, M), J.build_1f1b(S, M))
            for V in (2, 3):
                if M % S == 0:
                    _same(T.build_1f1b(S, M, V=V), J.build_1f1b(S, M, V=V))


def test_1f1b_memory_and_bubble_vs_gpipe():
    S, M = 4, 8
    gp, fb = T.build_gpipe(S, M), T.build_1f1b(S, M)
    assert gp.T == fb.T == 2 * (M + S - 1)
    assert gp.stats["bubble_fraction"] == fb.stats["bubble_fraction"]
    assert gp.stash_cap == M and fb.stash_cap == S
    assert T.build_1f1b(S, 32).stash_cap == S
    assert T.build_gpipe(S, 32).stash_cap == 32


@pytest.mark.parametrize("S,M", [(2, 4), (4, 8), (4, 16), (8, 32)])
def test_zbh1_beats_1f1b_bubble_at_near_equal_memory(S, M):
    z, o = T.build_schedule("zbh1", S, M), T.build_schedule("1f1b", S, M)
    _same(z, J.build_schedule("zbh1", S, M))
    assert z.stats["bubble_fraction"] < o.stats["bubble_fraction"]
    assert z.stash_cap <= S + 1 and z.gstash_cap <= S
    ops = z.ops
    assert (ops == T.OP_F).sum() == M * S
    assert ((ops == T.OP_BX) | (ops == T.OP_BX_LAST)).sum() == M * S
    assert ((ops == T.OP_BW) | (ops == T.OP_BW_LAST)).sum() == M * S


@pytest.mark.parametrize("S,M,V", [(2, 4, 2), (4, 8, 2), (4, 16, 2),
                                   (4, 16, 4), (2, 8, 3)])
def test_zbvpp_beats_vpp_bubble_at_near_equal_memory(S, M, V):
    z, v = T.build_schedule("zbvpp", S, M, V), T.build_schedule("vpp", S, M, V)
    _same(z, J.build_schedule("zbvpp", S, M, V))
    assert z.stats["bubble_fraction"] < v.stats["bubble_fraction"]
    assert z.stash_cap <= v.stash_cap + 1
    G = S * V
    assert (z.ops == T.OP_F).sum() == M * G
    assert ((z.ops == T.OP_BX) | (z.ops == T.OP_BX_LAST)).sum() == M * G
    assert ((z.ops == T.OP_BW) | (z.ops == T.OP_BW_LAST)).sum() == M * G


def _raises_alike(fn_t, fn_j, match):
    with pytest.raises(Exception, match=match) as et:
        fn_t()
    with pytest.raises(Exception, match=match) as ej:
        fn_j()
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)


def test_validate_rejects_modular_slot_collision():
    def sched(mod):
        ops = np.array([[mod.OP_F], [mod.OP_F], [mod.OP_B_LAST], [mod.OP_F],
                        [mod.OP_B_LAST], [mod.OP_B_LAST]], np.int32)
        mbs = np.array([[0], [1], [1], [2], [0], [2]], np.int32)
        return mod.PipelineSchedule(S=1, M=3, V=1, ops=ops, mbs=mbs,
                                    chunks=np.zeros_like(mbs))

    _raises_alike(lambda: T.validate(sched(T)), lambda: J.validate(sched(J)),
                  "collision")


@pytest.mark.parametrize("bad", ["before upstream", "incomplete",
                                 "duplicate", "opcode"])
def test_validate_errors_match(bad):
    def sched(mod):
        F, B, L = mod.OP_F, mod.OP_B, mod.OP_B_LAST
        ops = {"before upstream": [[F, F], [0, L], [B, 0]],
               "incomplete": [[F, 0], [0, F]],
               "duplicate": [[F, 0], [F, F], [0, L], [B, 0]],
               "opcode": [[F, 0], [0, F], [0, B], [B, 0]]}[bad]
        ops = np.array(ops, np.int32)
        return mod.PipelineSchedule(S=2, M=1, V=1, ops=ops,
                                    mbs=np.zeros_like(ops),
                                    chunks=np.zeros_like(ops))

    _raises_alike(lambda: T.validate(sched(T)), lambda: J.validate(sched(J)),
                  bad)


@pytest.mark.parametrize("args,match", [
    (("1f1b", 4, 8, 2), "interleaved"), (("gpipe", 4, 8, 2), "virtual"),
    (("zbh1", 4, 8, 2), "zbvpp"), (("zbvpp", 4, 8, 1), "V>1"),
    (("zbvpp", 4, 6, 2), "M % S"), (("interleaved", 4, 6, 2), "M % S"),
    (("bogus", 4, 8, 1), "unknown")])
def test_build_schedule_errors_match(args, match):
    _raises_alike(lambda: T.build_schedule(*args),
                  lambda: J.build_schedule(*args), match)


def test_interleaved_shrinks_bubble():
    S, M = 4, 8
    b1 = T.build_1f1b(S, M).stats["bubble_fraction"]
    b2 = T.build_1f1b(S, M, V=2).stats["bubble_fraction"]
    b4 = T.build_1f1b(S, M, V=4).stats["bubble_fraction"]
    assert b2 < b1 and b4 < b2


@pytest.mark.parametrize("name,V", [("gpipe", 1), ("1f1b", 1), ("zbh1", 1),
                                    ("interleaved", 2), ("zbvpp", 2)])
def test_memory_estimate_matches(name, V):
    S, M = 4, 16
    mb_act = (2, 2048, 4096)            # [mb, seq, hidden] bf16
    t = T.build_schedule(name, S, M, V).memory_estimate(mb_act, 2)
    assert t == J.build_schedule(name, S, M, V).memory_estimate(mb_act, 2)
    assert t["total"] == sum(v for k, v in t.items() if k != "total")
    act = 2 * 2048 * 4096 * 2
    if name == "gpipe":
        assert t["stash"] == M * act
    if name == "1f1b":
        assert t["stash"] == S * act == 4 * 32 * 1024 * 1024
        assert t["gstash"] == 0
    if name == "zbh1":
        assert t["stash"] == (S + 1) * act and t["gstash"] > 0


def test_pretty_diagram_matches():
    for name, V in (("1f1b", 1), ("zbvpp", 2)):
        t = T.build_schedule(name, 2, 4, V).pretty()
        assert t == J.build_schedule(name, 2, 4, V).pretty()
        assert t.splitlines()[0].startswith("s0: ")
