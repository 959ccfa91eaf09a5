"""The gather-GEMM expert FFN (paddlepaddle_tpu_torch/ops/kernels/
gather_gemm.py) against the JAX package's ``gather_gemm_ffn``, which runs its
Pallas kernel in interpret mode on the CPU.

Tolerances, each with its reason:
* plain version vs the Pallas kernel at f32: 1e-5 absolute on outputs of
  magnitude ~1 — the same f32 products, summed in other orders;
* kernel vs plain version on the card (``cuda`` marker, skipped without a
  card): 1e-5 at f32 (FMA in full f32, another summation order); bf16 is
  held to the bound the kernel's one departure implies: it rounds the
  hidden activation to bf16 before the second product (relative error
  2^-9 per element), so |kernel - plain| <= 2^-9 (|hmid| @ |wd|) plus one
  bf16 step of the output (2^-7 relative) plus 1e-5.

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


@pytest.mark.parametrize("d,h,dtype,ok", [
    (2048, 1408, torch.bfloat16, True),     # DeepSeekMoE-16B expert
    (128, 128, torch.bfloat16, True),       # the smallest admitted
    (128, 128, torch.float32, True),
    (2048, 2304, torch.bfloat16, True),     # the widest bf16 h
    (2048, 2432, torch.bfloat16, False),
    (2048, 2432, torch.float32, True),      # the widest f32 h
    (2048, 2560, torch.float32, False),
    (96, 128, torch.bfloat16, False),       # not a multiple of 128
    (128, 64, torch.float32, False),
    (128, 128, torch.float16, False),
])
def test_support_check(d, h, dtype, ok):
    got, why = gg.gather_gemm_supported(d, h, dtype)
    assert got is ok, why
    if ok:
        assert gg.smem_bytes(h, dtype) <= gg.MAX_SMEM


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
    lib = gg._library()
    assert lib.gather_gemm_smem_bytes(h, int(dtype == torch.bfloat16)) \
        == gg.smem_bytes(h, dtype)


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
