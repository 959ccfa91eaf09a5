"""The gather-GEMM expert FFN (paddlepaddle_tpu_torch/ops/kernels/
gather_gemm.py) against the JAX package's ``gather_gemm_ffn``, which runs its
Pallas kernel in interpret mode on the CPU.

Tolerances, each with its reason:
* plain version vs the Pallas kernel at f32: 1e-5 absolute on outputs of
  magnitude ~1 — the same f32 products, summed in other orders;
* the two plain halves (``gather_gateup_plain`` then ``expert_down_plain``)
  against ``gather_gemm_ffn_plain`` at f32: bit for bit, the same ops;
* kernels vs plain versions on the card (``cuda`` marker, skipped without a
  card): 1e-5 at f32 (FMA in full f32, another summation order). In bf16
  each phase against its plain half within one bf16 step (2^-7 relative,
  both round one f32 result) plus what two f32 summation orders of a
  K-term product may differ by, sqrt(K) 2^-24 (|a| @ |b|), carried through
  silu(g) u for the first phase; the whole call is held to the
  bound the kernel's one departure implies: it rounds the hidden activation
  to bf16 before the second product (relative error 2^-9 per element), so
  |kernel - plain| <= 2^-9 (|hmid| @ |wd|) plus one bf16 step of the output
  (2^-7 relative) plus 1e-5.

JAX is imported inside the comparison only, so the card tests also run
where JAX is not installed:
``python -m pytest tests/test_torch_gather_gemm.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg
from paddlepaddle_tpu_torch.parallel import moe as tmoe


def _planted_slots(T, E, k, C, seed=0, empty=None, heavy=0):
    """Slot token rows from the port's capacity routing of planted logits:
    expert ``heavy`` takes the first choice of half the tokens (more than
    ``C`` of them: drops), ``empty`` receives no entry at all."""
    rng = np.random.default_rng(seed)
    # each row a permutation of 0..E-1 plus noise below 0.1: margins > 0.8
    logits = np.argsort(rng.random((T, E)), axis=1).astype(np.float32)
    logits += rng.uniform(0, 0.1, (T, E)).astype(np.float32)
    logits[: (T + 1) // 2, heavy] = E + 1.0
    if empty is not None:
        logits[:, empty] = -10.0
    _, _, _, valid, entry = tmoe._capacity_slot_maps(
        torch.from_numpy(logits), k, E, C, T)
    return torch.where(valid, entry % T, T).to(torch.int32)


def _inputs(T, E, d, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    wg = (rng.standard_normal((E, d, h)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, h)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((E, h, d)) / np.sqrt(h)).astype(np.float32)
    return x, wg, wu, wd


# (T, E, k, C, d, h, empty expert): planted drops at C 8 with an empty
# expert (its block is all sentinels); C 13 (not a multiple of 8) with a
# ragged tail; T = 1 (one token, most slots sentinels)
CASES = [(48, 4, 2, 8, 16, 24, 3), (20, 4, 2, 13, 8, 16, None),
         (1, 4, 2, 4, 16, 8, None)]


@pytest.mark.parametrize("T,E,k,C,d,h,empty", CASES)
def test_plain_matches_pallas_interpret(T, E, k, C, d, h, empty):
    import jax.numpy as jnp

    from paddlepaddle_tpu.ops.kernels.gather_gemm import \
        gather_gemm_ffn as jffn

    x, wg, wu, wd = _inputs(T, E, d, h)
    slot = _planted_slots(T, E, k, C, empty=empty)
    if empty is not None:
        assert (slot.reshape(E, C)[empty] == T).all()
    want = jffn(jnp.asarray(x, jnp.float32),
                jnp.asarray(slot.numpy(), jnp.int32),
                jnp.asarray(np.concatenate([wg, wu], -1), jnp.float32),
                jnp.asarray(wd, jnp.float32), capacity=C, interpret=True)
    before = gg.gather_gemm_ffn.launches
    got = gg.gather_gemm_ffn(torch.from_numpy(x), slot,
                             torch.from_numpy(wg), torch.from_numpy(wu),
                             torch.from_numpy(wd), capacity=C)
    assert gg.gather_gemm_ffn.launches == before   # CPU: no kernel launch
    assert got.shape == (E * C, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # sentinel slots give exact zero rows
    dead = (slot >= T).numpy()
    assert dead.any() and not got.numpy()[dead].any()


def test_plain_keeps_x_dtype_and_treats_negative_slots_as_sentinels():
    x, wg, wu, wd = _inputs(6, 2, 8, 8)
    slot = torch.tensor([0, 5, -1, 6, 2, 2], dtype=torch.int32)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, wg, wu, wd)]
    out = gg.gather_gemm_ffn_plain(args[0], slot, *args[1:], capacity=3)
    assert out.dtype == torch.bfloat16 and out.shape == (6, 8)
    assert not out[2].any() and not out[3].any()
    assert out[0].any() and torch.equal(out[4], out[5])


@pytest.mark.parametrize("T,E,k,C,d,h,empty", CASES)
def test_plain_halves_compose_to_plain_and_match_pallas(T, E, k, C, d, h,
                                                        empty):
    """gather_gateup_plain then expert_down_plain is gather_gemm_ffn_plain
    bit for bit in f32, and within 1e-5 of the Pallas kernel; the CPU
    wrappers of the two phases run them and launch nothing."""
    import jax.numpy as jnp

    from paddlepaddle_tpu.ops.kernels.gather_gemm import \
        gather_gemm_ffn as jffn

    x, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(T, E, d, h, seed=1))
    slot = _planted_slots(T, E, k, C, seed=1, empty=empty)
    before = (gg.gather_gateup.launches, gg.expert_down.launches)
    hmid = gg.gather_gateup(x, slot, wg, wu, capacity=C)
    got = gg.expert_down(hmid, slot, wd, n_tokens=T)
    assert (gg.gather_gateup.launches, gg.expert_down.launches) == before
    assert hmid.shape == (E, C, h) and hmid.dtype == torch.float32
    assert torch.equal(hmid, gg.gather_gateup_plain(x, slot, wg, wu,
                                                    capacity=C))
    assert torch.equal(got, gg.gather_gemm_ffn_plain(x, slot, wg, wu, wd,
                                                     capacity=C))
    want = jffn(jnp.asarray(x.numpy(), jnp.float32),
                jnp.asarray(slot.numpy(), jnp.int32),
                jnp.asarray(np.concatenate([wg.numpy(), wu.numpy()], -1),
                            jnp.float32),
                jnp.asarray(wd.numpy(), jnp.float32), capacity=C,
                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    dead = (slot >= T).numpy()
    assert not hmid.reshape(E * C, h).numpy()[dead].any()
    assert not got.numpy()[dead].any()


def test_expert_down_plain_zeroes_sentinel_rows_whatever_hmid_holds():
    rng = np.random.default_rng(2)
    hmid = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    wd = torch.from_numpy(rng.standard_normal((2, 8, 4)).astype(np.float32))
    slot = torch.tensor([0, 5, -1, 2, 9, 1], dtype=torch.int32)
    out = gg.expert_down_plain(hmid, slot, wd, n_tokens=5)
    assert not out[1].any() and not out[2].any() and not out[4].any()
    torch.testing.assert_close(out[3], hmid[1, 0] @ wd[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("d,h,dtype,ok", [
    (2048, 1408, torch.bfloat16, True),     # DeepSeekMoE-16B expert
    (128, 128, torch.bfloat16, True),       # the smallest admitted
    (128, 128, torch.float32, True),
    (2048, 2304, torch.bfloat16, True),
    # admitted since neither kernel keeps the [rows, h] activation on chip:
    # past the fused kernel's shared-memory cap (h 2304 bf16 / 2432 f32)
    (2048, 2432, torch.bfloat16, True),
    (2048, 2432, torch.float32, True),
    (2048, 2560, torch.float32, True),
    (4096, 14336, torch.bfloat16, True),    # Mixtral-8x7B expert
    (4096, 14336, torch.float32, True),
    (96, 128, torch.bfloat16, False),       # not a multiple of 128
    (128, 64, torch.float32, False),
    (128, 128, torch.float16, False),
])
def test_support_check(d, h, dtype, ok):
    got, why = gg.gather_gemm_supported(d, h, dtype)
    assert got is ok, why
    if ok:
        for phase in gg.PHASES:
            assert gg.smem_bytes(phase, dtype) <= gg.MAX_SMEM


def test_moe_layer_fused_builds_on_cpu_at_any_width():
    """The support check belongs to the card: on the CPU the fused layer
    takes any width and runs the plain version."""
    layer = tmoe.MoELayer(24, 40, 3, dispatch_mode="fused", device="cpu")
    y = layer(torch.randn(2, 5, 24))
    assert y.shape == (2, 5, 24) and layer.l_aux is not None


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the hand-written CUDA kernel)")
    return torch.device("cuda")


def _check_phases(x, slot, wg, wu, wd, C):
    """Each phase against its plain half on the same inputs, the call
    against gather_gemm_ffn_plain, every counter moved once, and every
    sentinel slot's rows exactly zero."""
    T = x.shape[0]
    E, _, h = wg.shape
    before = (gg.gather_gateup.launches, gg.expert_down.launches,
              gg.gather_gemm_ffn.launches)
    hmid = gg.gather_gateup(x, slot, wg, wu, capacity=C)
    hmid_want = gg.gather_gateup_plain(x, slot, wg, wu, capacity=C)
    down = gg.expert_down(hmid_want, slot, wd, n_tokens=T)
    down_want = gg.expert_down_plain(hmid_want, slot, wd, n_tokens=T)
    got = gg.gather_gemm_ffn(x, slot, wg, wu, wd, capacity=C)
    want = gg.gather_gemm_ffn_plain(x, slot, wg, wu, wd, capacity=C)
    torch.cuda.synchronize()
    assert (gg.gather_gateup.launches, gg.expert_down.launches,
            gg.gather_gemm_ffn.launches) == (before[0] + 2, before[1] + 2,
                                             before[2] + 1)
    for a, b, bound in (
            (hmid, hmid_want, lambda p: gg.gather_gateup_bf16_bound(
                x, slot, wg, wu, capacity=C, plain=p)),
            (down, down_want, lambda p: gg.expert_down_bf16_bound(
                hmid_want, wd, plain=p)),
            (got, want, lambda p: gg.bf16_error_bound(
                x, slot, wg, wu, wd, capacity=C, plain=p))):
        err = (a.float() - b.float()).abs()
        if x.dtype == torch.float32:
            assert float(err.max()) <= 1e-5
        else:
            assert bool((err <= bound(b)).all()), float(err.max())
    dead = (slot < 0) | (slot >= T)
    assert not hmid.reshape(E * C, h)[dead].any()
    assert not down[dead].any() and not got[dead].any()


def _hand_slots(T, E, C, fills, seed=0):
    """Token rows per slot with ``fills[e]`` filled slots in expert e (the
    capacity maps' layout: a filled head, a sentinel tail, here marked T
    and -1 in turn)."""
    rng = np.random.default_rng(seed)
    slot = np.empty((E, C), np.int32)
    for e, n in enumerate(fills):
        slot[e, :n] = rng.integers(0, T, n)
        slot[e, n:] = np.where(np.arange(C - n) % 2, -1, T)
    return torch.from_numpy(slot.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,C,d,h,empty", [
    (48, 4, 40, 128, 128, 3),       # ragged C, an empty expert, drops
    (300, 6, 37, 256, 384, None),
    (1, 2, 4, 128, 256, None),
])
def test_kernel_matches_plain_on_card(dtype, T, E, C, d, h, empty):
    dev = _card()
    x, wg, wu, wd = (torch.from_numpy(a).to(dev, dtype)
                     for a in _inputs(T, E, d, h))
    slot = _planted_slots(T, E, 2, C, empty=empty).to(dev)
    before = gg.gather_gemm_ffn.launches
    got = gg.gather_gemm_ffn(x, slot, wg, wu, wd, capacity=C)
    want = gg.gather_gemm_ffn_plain(x, slot, wg, wu, wd, capacity=C)
    torch.cuda.synchronize()
    assert gg.gather_gemm_ffn.launches == before + 1
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= gg.bf16_error_bound(
            x, slot, wg, wu, wd, capacity=C, plain=want)).all())
    assert not got[(slot >= T)].any()
    for phase in gg.PHASES:
        assert gg.kernel_smem_bytes(phase, dtype) == gg.smem_bytes(phase,
                                                                   dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,C,d,h,fills", [
    # C % 128 = 37 (in 1..63): the last row tile has one live half; expert
    # 2 all sentinels; expert 1's second 64-slot half all sentinels next
    # to its filled first half
    (300, 3, 165, 128, 256, (165, 50, 0)),
    # C % 128 = 100 (in 65..127); expert 3's tile 0 half 1 empty
    (200, 4, 228, 256, 128, (228, 128, 170, 64)),
    (1, 3, 6, 128, 128, (1, 0, 1)),                 # T 1
])
def test_phases_match_plain_on_card(dtype, T, E, C, d, h, fills):
    dev = _card()
    x, wg, wu, wd = (torch.from_numpy(a).to(dev, dtype)
                     for a in _inputs(T, E, d, h, seed=3))
    _check_phases(x, _hand_slots(T, E, C, fills).to(dev), wg, wu, wd, C)


@pytest.mark.cuda
def test_phases_f32_past_the_old_cap_on_card():
    """h 4096 in f32, past the fused kernel's 2432."""
    dev = _card()
    T, E, C, d, h = 96, 3, 70, 128, 4096
    x, wg, wu, wd = (torch.from_numpy(a).to(dev)
                     for a in _inputs(T, E, d, h, seed=4))
    _check_phases(x, _hand_slots(T, E, C, (70, 33, 0)).to(dev), wg, wu, wd, C)


@pytest.mark.cuda
def test_phases_mixtral_width_on_card():
    """Mixtral-8x7B's expert widths (d 4096, h 14336, 8 experts; public
    config of mistralai/Mixtral-8x7B-v0.1) at T 2048, top-2, capacity
    1.25 (C 640), bf16, slots from a capacity routing."""
    dev = _card()
    T, E, C, d, h = 2048, 8, 640, 4096, 14336
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(T, d, device=dev, generator=gen).to(torch.bfloat16)
    wg, wu = (torch.randn(E, d, h, device=dev, generator=gen)
              .mul_(d ** -0.5).to(torch.bfloat16) for _ in range(2))
    wd = torch.randn(E, h, d, device=dev, generator=gen).mul_(h ** -0.5) \
        .to(torch.bfloat16)
    logits = torch.randn(T, E, device=dev, generator=gen)
    _, _, _, valid, entry = tmoe._capacity_slot_maps(logits, 2, E, C, T)
    slot = torch.where(valid, entry % T, T).to(torch.int32)
    _check_phases(x, slot, wg, wu, wd, C)


@pytest.mark.cuda
def test_fused_layer_at_mixtral_width_matches_sorted_on_card():
    """MoELayer(4096, 14336, 8) in f32: the fused mode (both kernels) on
    the card against the sorted mode (cuBLAS bmm, TF32 off) on the same
    card, 2 x 256 tokens. The routing is the same code on the same logits;
    the products are f32 sums of 4096 and 14336 terms in other orders
    (relative error ~sqrt(n) 2^-24, under 1e-5 of the row's scale): 5e-5 of
    the output's largest magnitude."""
    dev = _card()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fused = tmoe.MoELayer(4096, 14336, 8, dispatch_mode="fused",
                              device=dev, seed=6)
        ref = tmoe.MoELayer(4096, 14336, 8, dispatch_mode="sorted",
                            device=dev, seed=6)
        x = torch.randn(2, 256, 4096, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
        before = gg.gather_gemm_ffn.launches
        with torch.no_grad():
            y, y_ref = fused(x), ref(x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert gg.gather_gemm_ffn.launches == before + 1
    scale = float(y_ref.abs().max())
    assert float((y - y_ref).abs().max()) <= 5e-5 * scale
    assert float((fused.l_aux - ref.l_aux).abs()) <= 1e-6


@pytest.mark.cuda
def test_kernel_main_shape_on_card():
    """DeepSeekMoE-16B widths at the main path's capacity: E 64, C 320,
    T 8192, d 2048, h 1408, bf16."""
    dev = _card()
    T, E, C, d, h = 8192, 64, 320, 2048, 1408
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(T, d, device=dev, generator=gen).to(torch.bfloat16)
    wg, wu = (torch.randn(E, d, h, device=dev, generator=gen)
              .mul_(0.02).to(torch.bfloat16) for _ in range(2))
    wd = torch.randn(E, h, d, device=dev, generator=gen).mul_(0.02) \
        .to(torch.bfloat16)
    logits = torch.randn(T, E, device=dev, generator=gen)
    _, _, _, valid, entry = tmoe._capacity_slot_maps(logits, 2, E, C, T)
    slot = torch.where(valid, entry % T, T).to(torch.int32)
    got = gg.gather_gemm_ffn(x, slot, wg, wu, wd, capacity=C)
    want = gg.gather_gemm_ffn_plain(x, slot, wg, wu, wd, capacity=C)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert bool((err <= gg.bf16_error_bound(x, slot, wg, wu, wd, capacity=C,
                                            plain=want)).all())


@pytest.mark.cuda
def test_fused_layer_refuses_unsupported_width_on_card():
    dev = _card()
    with pytest.raises(ValueError, match="gather-GEMM"):
        tmoe.MoELayer(96, 128, 4, dispatch_mode="fused", device=dev)
    tmoe.MoELayer(96, 128, 4, dispatch_mode="sorted", device=dev)
    with pytest.raises(ValueError, match="does not take"):
        gg.gather_gemm_ffn(torch.zeros(4, 96, device=dev),
                           torch.zeros(8, dtype=torch.int32, device=dev),
                           torch.zeros(2, 96, 128, device=dev),
                           torch.zeros(2, 96, 128, device=dev),
                           torch.zeros(2, 128, 96, device=dev), capacity=4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sorted", "fused", "dropless", "einsum"])
def test_moe_layer_modes_on_card_match_cpu(mode):
    """Each dispatch mode on the card (the fused one through the kernel)
    against the same layer on the CPU, f32: output, aux loss and every
    gradient within 1e-5 of that tensor's largest magnitude (f32 sums in
    other orders on the two devices; gradients reach ~350 here). The gate
    is drawn N(0, 0.1): the router's top-3 margins are above 0.02, far from
    a tie that f32 noise could flip."""
    dev = _card()
    layers = {}
    for where in ("cpu", dev):
        layers[where] = tmoe.MoELayer(128, 128, 4, dispatch_mode=mode,
                                      device=where, seed=3, init_std=0.1)
    layers[dev].load_state_dict(layers["cpu"].state_dict())
    x = np.random.default_rng(4).standard_normal((2, 24, 128)).astype(
        np.float32)
    out = {}
    for where, layer in layers.items():
        xt = torch.from_numpy(x).to(where).requires_grad_(True)
        y = layer(xt)
        (y.square().sum() + layer.l_aux).backward()
        out[where] = [y, layer.l_aux, xt.grad] + [
            p.grad for p in layer.parameters()]
    for i, (a, b) in enumerate(zip(out[dev], out["cpu"])):
        scale = max(1.0, float(b.detach().abs().max()))
        err = float((a.detach().cpu() - b.detach()).abs().max())
        assert err <= 1e-5 * scale, (i, err, scale)
