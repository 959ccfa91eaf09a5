"""Port paged attention (paddlepaddle_tpu_torch/ops/kernels/paged_attention.py)
against the JAX Pallas kernel run in interpret mode on the same numpy inputs.

Tolerances: f32 2e-6 (two f32 softmax orders: the Pallas online pass vs one
torch softmax), bf16 2e-2 (the output is rounded to bf16 on both sides; the
same bound tests/test_fused_kernels.py uses for the kernel itself).

JAX is imported inside the comparisons only, so the card test also runs
where JAX is not installed:
``python -m pytest tests/test_torch_paged_attention.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

S, P, PS, KVH, HD, H = 4, 3, 8, 2, 16, 4
REP = H // KVH


def _inputs(W, seed=1):
    rng = np.random.default_rng(seed)
    pages = 1 + S * P
    kp = rng.standard_normal((pages, PS, KVH, HD)).astype(np.float32)
    vp = rng.standard_normal((pages, PS, KVH, HD)).astype(np.float32)
    pt = rng.permutation(np.arange(1, pages))[: S * P].reshape(S, P)
    pt = pt.astype(np.int32)
    pt[3] = 0                                  # retired slot: zeroed row
    lens = np.asarray([5, 13, 0, 20], np.int32)  # 0, mid-page tails
    q = rng.standard_normal((S, W, H, HD)).astype(np.float32)
    return q, kp, vp, pt, lens


def _jax_out(q, kp, vp, pt, lens, dtype):
    import jax.numpy as jnp

    from paddlepaddle_tpu.ops.kernels.paged_attention import \
        paged_attention as jax_paged_attention

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jax_paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(pt, jnp.int32), jnp.asarray(lens, jnp.int32), rep=REP,
        scale=1.0 / np.sqrt(HD), interpret=True)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _torch_out(q, kp, vp, pt, lens, dtype, device="cpu"):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    args = [torch.from_numpy(a).to(device=device, dtype=tdt)
            for a in (q, kp, vp)]
    out = pa.paged_attention(
        *args, torch.from_numpy(pt).to(device), torch.from_numpy(lens).to(device),
        rep=REP, scale=1.0 / np.sqrt(HD))
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    return out.float().cpu().numpy()


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6), ("bfloat16", 2e-2)])
def test_plain_matches_pallas_interpret(W, dtype, atol):
    inputs = _inputs(W)
    before = pa.paged_attention.launches
    got = _torch_out(*inputs, dtype)
    assert pa.paged_attention.launches == before   # CPU: plain, no launch
    want = _jax_out(*inputs, dtype)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_stale_table_entries_past_window_are_ignored():
    """Pages wholly past the visible window are redirected to the null page
    (the TPU index map's rule): garbage planted there must not matter."""
    q, kp, vp, pt, lens = _inputs(1)
    base = _torch_out(q, kp, vp, pt, lens, "float32")
    kp2, vp2 = kp.copy(), vp.copy()
    # slot 0 (lens 5) sees page 0 only; poison its pages 1 and 2
    kp2[pt[0, 1:]] = np.nan
    vp2[pt[0, 1:]] = np.nan
    got = _torch_out(q, kp2, vp2, pt, lens, "float32")
    np.testing.assert_array_equal(got[0], base[0])


@pytest.mark.parametrize("kwargs,ok,why", [
    (dict(page_size=64, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.bfloat16), True, "ok"),
    (dict(page_size=16, head_dim=64, num_heads=4, num_kv_heads=2,
          dtype=torch.float32, w=3), True, "ok"),
    (dict(page_size=64, head_dim=96, num_heads=32, num_kv_heads=8,
          dtype=torch.bfloat16), False, "head_dim"),
    (dict(page_size=64, head_dim=128, num_heads=30, num_kv_heads=8,
          dtype=torch.bfloat16), False, "divisible"),
    (dict(page_size=64, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.float16), False, "dtype"),
    (dict(page_size=64, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.bfloat16, w=5), False, "W 5"),
    (dict(page_size=64, head_dim=128, num_heads=64, num_kv_heads=1,
          dtype=torch.bfloat16), False, "query rows"),
    (dict(page_size=512, head_dim=128, num_heads=32, num_kv_heads=8,
          dtype=torch.float32), False, "shared memory"),
])
def test_support_check_table(kwargs, ok, why):
    got_ok, reason = pa.paged_attention_supported(**kwargs)
    assert got_ok is ok
    assert why in reason


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Kernel vs plain version on the card (W=1 and W=3, f32 and bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (Hopper) and nvcc")
    for W in (1, 3):
        q, kp, vp, pt, lens = _inputs(W)
        # kernel head_dims are 64/128: tile the 16-wide test rows up to 64
        q, kp, vp = (np.tile(a, 4) for a in (q, kp, vp))
        for dtype, atol in (("float32", 1e-5), ("bfloat16", 2e-2)):
            tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            t = [torch.from_numpy(a).to("cuda", tdt) for a in (q, kp, vp)]
            ptc = torch.from_numpy(pt).cuda()
            lc = torch.from_numpy(lens).cuda()
            kw = dict(rep=REP, scale=0.125)
            before = pa.paged_attention.launches
            got = pa.paged_attention(*t, ptc, lc, **kw)
            torch.cuda.synchronize()
            assert pa.paged_attention.launches == before + 1
            want = pa.paged_attention_plain(*t, ptc, lc, **kw)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=atol, rtol=0)


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 1, 4, 64), device="meta")
    kp = torch.empty((2, 8, 2, 64), device="meta")
    pt = torch.empty((1, 1), dtype=torch.int32, device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    before = pa.paged_attention.launches
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_attention(q, kp, kp, pt, lens, rep=2, scale=0.125)
    assert pa.paged_attention.launches == before


def test_build_library_name_tracks_source_and_flags(tmp_path, monkeypatch):
    """The built library is named by a hash of its source and the nvcc
    flags, in the (overridable) git-ignored build directory: an edited
    source or a flag change never loads a stale library."""
    from paddlepaddle_tpu_torch.ops.kernels import _build

    assert "paged_attention" in _build.sources()
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    first = _build.library_path("paged_attention")
    assert first.parent == tmp_path and first.suffix == ".so"
    assert first == _build.library_path("paged_attention")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("paged_attention") != first
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "paged_attention.cu").write_text("// edited\n")
    assert _build.library_path("paged_attention").name != first.name
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
