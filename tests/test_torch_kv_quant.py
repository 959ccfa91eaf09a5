"""int8 KV pages in the port against the JAX package, on the same numpy inputs.

* The three int8 page functions of the port's decode engine
  (``_kv_quant_pages``, ``_kv_dequant_gather``, ``_kv_quant_scatter``) are
  bit-equal to the reference's (paddlepaddle_tpu/inference/decode_engine.py
  :78-132): codes and scales, an all-zero page, a scale that grows and one
  that does not, W 1 and 3. ``jnp.round`` and ``torch.round`` both round
  half to even, so no tolerance is needed.
* The plain int8 ``paged_attention`` (k_scale/v_scale given) is within 1e-5
  of the Pallas kernel's ``quantized=True`` branch in interpret mode (two
  f32 softmax orders), and bit-equal to the plain f32 version run over
  pools dequantized beforehand (the same f32 products in the same order).
* The int8 support check and the wrapper's argument rules; the kernel on
  the card (``cuda`` marker) against the plain version and against kernel 1
  over dequantized pools: ``python -m pytest tests/test_torch_kv_quant.py
  -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.inference import decode_engine as tde
from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa


def _jax_engine_module():
    from paddlepaddle_tpu.inference import decode_engine as jde

    return jde


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# -- the three page functions, bit for bit -----------------------------------

def test_quant_pages_bit_equal_with_zero_page():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 2, 16)).astype(np.float32)
    x[1] = 0.0                                 # an all-zero page: scale 0
    x[2, 3:] = 0.0                             # a prompt's padded tail
    x[3, 0, 0, 0] = 127.5 * 0.01               # a .5 after scaling
    jc, js = _jax_engine_module()._kv_quant_pages(jnp.asarray(x))
    tc, ts = tde._kv_quant_pages(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    assert not tc[1].any() and float(ts[1].abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_gather_bit_equal(dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    codes = rng.integers(-127, 128, (6, 8, 2, 16)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, (6, 2)).astype(np.float32)
    idx = np.array([[3, 1, 0], [5, 5, 2]], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = _jax_engine_module()._kv_dequant_gather(
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(idx), jdt)
    got = tde._kv_dequant_gather(torch.from_numpy(codes),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(idx).long(), tdt)
    assert got.dtype == tdt and tuple(got.shape) == (2, 3, 8, 2, 16)
    np.testing.assert_array_equal(
        _bits(got.float().numpy()),
        _bits(np.asarray(jnp.asarray(want, jnp.float32))))


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("grow", [False, True], ids=["no_growth", "growth"])
def test_quant_scatter_bit_equal(W, grow):
    """Rows written into pages with existing codes: without growth the
    factor is exactly 1.0 and the old codes stay; with growth (slot 0's
    rows 20x larger) the page is requantized. Slot 2 writes into a page of
    scale 0 (a fresh page); slot 3 is retired and writes into the null
    page 0, which is not compared (one writer wins there)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2 + W)
    pages, ps, kvh, hd = 8, 8, 2, 16
    codes = rng.integers(-127, 128, (pages, ps, kvh, hd)).astype(np.int8)
    scales = rng.uniform(0.02, 0.03, (pages, kvh)).astype(np.float32)
    scales[4] = 0.0
    codes[4] = 0
    new = (rng.standard_normal((4, W, kvh, hd)) * 0.3).astype(np.float32)
    if grow:
        new[0] *= 20.0
    else:
        assert (np.abs(new).max(-1) / 127.0 < scales[[1, 2]].min()).all()
    phys = np.array([[1] * W, [2] * W, [4] * W, [0] * W], np.int32)
    off = np.array([[0, 1, 2][:W], [5, 6, 7][:W], [0, 1, 2][:W],
                    [3, 4, 5][:W]], np.int32)
    jcodes, jsc = _jax_engine_module()._kv_quant_scatter(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(phys), jnp.asarray(off))
    tcodes, tsc = torch.from_numpy(codes.copy()), torch.from_numpy(
        scales.copy())
    out = tde._kv_quant_scatter(tcodes, tsc, torch.from_numpy(new),
                                torch.from_numpy(phys).long(),
                                torch.from_numpy(off).long())
    assert out[0] is tcodes and out[1] is tsc          # in place
    real = slice(1, None)                              # page 0 is the null page
    np.testing.assert_array_equal(tcodes.numpy()[real],
                                  np.asarray(jcodes)[real])
    np.testing.assert_array_equal(_bits(tsc.numpy()[real]),
                                  _bits(np.asarray(jsc)[real]))
    if not grow:
        # drift-free appends: every code outside the written rows is kept
        keep = np.ones((pages, ps), bool)
        for s in range(3):
            keep[phys[s], off[s]] = False
        np.testing.assert_array_equal(tcodes.numpy()[1:][keep[1:]],
                                      codes[1:][keep[1:]])
        np.testing.assert_array_equal(tsc.numpy()[[1, 2]], scales[[1, 2]])
    else:
        assert float(tsc[1].max()) > float(scales[1].max())


# -- the plain int8 paged attention -----------------------------------------

S, H, KVH, HD, PS, P = 2, 4, 2, 16, 8, 3
NPAGES = S * P + 1


def _int8_inputs(W, seed=7):
    """Shapes of tests/test_kv_quant_tier.py:138; lens 11 (a mid-page tail)
    and the last position the table holds."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, W, H, HD)).astype(np.float32)
    kq = rng.integers(-127, 128, (NPAGES, PS, KVH, HD)).astype(np.int8)
    vq = rng.integers(-127, 128, (NPAGES, PS, KVH, HD)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (NPAGES, KVH)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (NPAGES, KVH)).astype(np.float32)
    pt = np.arange(1, NPAGES, dtype=np.int32).reshape(S, P)
    lens = np.array([11, PS * P - W], dtype=np.int32)
    return q, kq, vq, ks, vs, pt, lens


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("W", [1, 3])
def test_plain_int8_matches_pallas_interpret(W):
    import jax.numpy as jnp

    from paddlepaddle_tpu.ops.kernels.paged_attention import \
        paged_attention as jax_paged_attention

    q, kq, vq, ks, vs, pt, lens = _int8_inputs(W)
    want = jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), pt, lens,
        rep=H // KVH, scale=HD ** -0.5, k_scale=ks, v_scale=vs,
        interpret=True)
    before = (pa.paged_attention.launches, pa.paged_attention.int8_launches)
    tq, tkq, tvq, tks, tvs, tpt, tl = _t(q, kq, vq, ks, vs, pt, lens)
    got = pa.paged_attention(tq, tkq, tvq, tpt, tl, rep=H // KVH,
                             scale=HD ** -0.5, k_scale=tks, v_scale=tvs)
    assert (pa.paged_attention.launches,
            pa.paged_attention.int8_launches) == before   # CPU: plain
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("W", [1, 3])
def test_plain_int8_bit_equal_to_plain_over_dequantized_pools(W):
    q, kq, vq, ks, vs, pt, lens = _int8_inputs(W, seed=8)
    pt[1] = 0                                  # a retired slot's zeroed row
    lens[0] = 0
    tq, tkq, tvq, tks, tvs, tpt, tl = _t(q, kq, vq, ks, vs, pt, lens)
    kw = dict(rep=H // KVH, scale=HD ** -0.5)
    got = pa.paged_attention(tq, tkq, tvq, tpt, tl, k_scale=tks,
                             v_scale=tvs, **kw)
    kd = tkq.float() * tks[:, None, :, None]
    vd = tvq.float() * tvs[:, None, :, None]
    want = pa.paged_attention(tq, kd, vd, tpt, tl, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_plain_int8_bf16_query():
    """bf16 queries over int8 pools: within bf16 rounding of the f32 run."""
    q, kq, vq, ks, vs, pt, lens = _int8_inputs(1, seed=9)
    tq, tkq, tvq, tks, tvs, tpt, tl = _t(q, kq, vq, ks, vs, pt, lens)
    kw = dict(rep=H // KVH, scale=HD ** -0.5, k_scale=tks, v_scale=tvs)
    got = pa.paged_attention(tq.bfloat16(), tkq, tvq, tpt, tl, **kw)
    want = pa.paged_attention(tq.bfloat16().float(), tkq, tvq, tpt, tl, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2,
                               rtol=0)


def test_scales_both_or_neither():
    q, kq, vq, ks, vs, pt, lens = _int8_inputs(1)
    tq, tkq, tvq, tks, _, tpt, tl = _t(q, kq, vq, ks, vs, pt, lens)
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention(tq, tkq, tvq, tpt, tl, rep=2, scale=0.25,
                           k_scale=tks)
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention_plain(tq, tkq, tvq, tpt, tl, rep=2, scale=0.25,
                                 v_scale=tks)


@pytest.mark.parametrize("kwargs,ok,why", [
    (dict(page_size=64, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.bfloat16, kv_quant="int8"), True, "ok"),
    (dict(page_size=16, head_dim=64, num_heads=4, num_kv_heads=2,
          dtype=torch.float32, w=3, kv_quant="int8"), True, "ok"),
    # int8 pages stage a quarter of the f32 bytes: 256-row pages fit in
    # shared memory as codes, not as f32
    (dict(page_size=256, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.float32, kv_quant="int8"), True, "ok"),
    (dict(page_size=256, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.float32), False, "shared memory"),
    (dict(page_size=512, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.float32, kv_quant="int8"), False, "shared memory"),
    (dict(page_size=64, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.bfloat16, kv_quant="int4"), False, "kv_quant"),
    (dict(page_size=64, head_dim=96, num_heads=32, num_kv_heads=8,
          dtype=torch.bfloat16, kv_quant="int8"), False, "head_dim"),
])
def test_int8_support_check_table(kwargs, ok, why):
    got_ok, reason = pa.paged_attention_supported(**kwargs)
    assert got_ok is ok
    assert why in reason


def test_int8_smem_bytes_formula():
    # two staged pages (K rows padded by 16 elements, V rows unpadded), the
    # f32 q rows of the row bucket (4), eight warps' row maxima and the row
    # sums, and the staged pages' two scales
    assert pa.smem_bytes(64, 128, 4, 1) == (2 * 64 * (144 + 128)
                                            + 4 * 128 * 4 + 9 * 4 * 4
                                            + 2 * 2 * 4)
    assert pa.smem_bytes(64, 128, 4, 1) < pa.smem_bytes(64, 128, 4, 2)


# -- the kernel on the card ---------------------------------------------------

@pytest.mark.cuda
def test_int8_kernel_matches_plain_on_card():
    """Kernel 1q against the plain version (W 1 and 3, q f32 and bf16, a
    zeroed row, lens 0, a zero-scale page) and, at f32, against kernel 1
    run over pools dequantized beforehand."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (Hopper) and nvcc")
    for W in (1, 3):
        q, kq, vq, ks, vs, pt, lens = _int8_inputs(W)
        # kernel head_dims are 64/128: tile the 16-wide test rows up to 64
        q, kq, vq = (np.tile(a, 4) for a in (q, kq, vq))
        pt = np.concatenate([pt, np.zeros((1, P), np.int32)])
        lens = np.concatenate([lens, [0]]).astype(np.int32)
        q = np.concatenate([q, q[:1]])
        ks[pt[0, 1]] = 0.0
        tkq, tvq, tks, tvs, tpt, tl = (x.cuda() for x in _t(kq, vq, ks, vs,
                                                              pt, lens))
        kw = dict(rep=H // KVH, scale=0.125)
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            tq = torch.from_numpy(q).to("cuda", dtype)
            before = pa.paged_attention.int8_launches
            got = pa.paged_attention(tq, tkq, tvq, tpt, tl, k_scale=tks,
                                     v_scale=tvs, **kw)
            torch.cuda.synchronize()
            assert pa.paged_attention.int8_launches == before + 1
            want = pa.paged_attention_plain(tq, tkq, tvq, tpt, tl,
                                            k_scale=tks, v_scale=tvs, **kw)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=atol, rtol=0)
            if dtype == torch.float32:
                kd = (tkq.float() * tks[:, None, :, None]).contiguous()
                vd = (tvq.float() * tvs[:, None, :, None]).contiguous()
                one = pa.paged_attention(tq, kd, vd, tpt, tl, **kw)
                np.testing.assert_allclose(got.cpu().numpy(),
                                           one.cpu().numpy(), atol=1e-5,
                                           rtol=0)
