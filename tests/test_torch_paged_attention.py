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


# -- the context split: host planner and merge arithmetic (CPU) --------------

@pytest.mark.parametrize("S,kvh,P,sm", [(8, 8, 32, 132), (1, 1, 1, 132),
                                        (3, 2, 3, 132), (64, 8, 32, 132),
                                        (8, 8, 33, 132), (2, 4, 100, 16),
                                        (4, 2, 7, 1)])
def test_split_plan_covers_pages_once_in_order(S, kvh, P, sm):
    n, pps = pa.split_plan(S, kvh, P, sm)
    assert n >= 1 and pps >= 1
    pages = [j for i in range(n) for j in range(i * pps, min((i + 1) * pps, P))]
    assert pages == list(range(P))                  # once each, in order
    assert (n - 1) * pps < P                        # no split wholly empty
    assert pa.split_plan(S, kvh, P, sm) == (n, pps)  # stable across calls


def test_split_plan_main_shape_and_independent_of_lens():
    """At the Llama-3-8B decode shape (8 slots, 8 KV heads, 32 pages, 132
    SMs) the plan is 8 splits of 4 pages, 512 CTAs. It reads no lens: the
    wrapper computes it from shapes only, so two steps with different lens
    give the same plan and the same scratch shapes."""
    assert pa.split_plan(8, 8, 32, 132) == (8, 4)
    import inspect

    assert "lens" not in inspect.signature(pa.split_plan).parameters
    seen = []
    real = pa.split_plan

    def spy(*args):
        seen.append(args)
        return real(*args)

    q, kp, vp, pt, _ = _inputs(1)
    for lens in ([5, 13, 0, 20], [23, 0, 9, 1]):
        plan = spy(q.shape[0], kp.shape[2], pt.shape[1], 132)
        parts = pa.paged_attention_partials_plain(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(pt), torch.tensor(lens, dtype=torch.int32),
            rep=REP, scale=0.25, n_split=plan[0], pages_per_split=plan[1])
        seen.append(tuple(t.shape for t in parts))
    assert seen[0] == seen[2] and seen[1] == seen[3]


def _merge_case(W, hd, lens, n_split, pps, quant, zero_row=None, ps=PS,
                P=P, seed=3):
    rng = np.random.default_rng(seed)
    pages = 1 + S * P
    kp = rng.standard_normal((pages, ps, KVH, hd)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, KVH, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, pages))[: S * P].reshape(S, P)
    pt = pt.astype(np.int32)
    if zero_row is not None:
        pt[zero_row] = 0
    q = torch.from_numpy(rng.standard_normal((S, W, H, hd)).astype(np.float32))
    kw = dict(rep=REP, scale=hd ** -0.5)
    kt, vt = torch.from_numpy(kp), torch.from_numpy(vp)
    if quant:
        from paddlepaddle_tpu_torch.inference.decode_engine import \
            _kv_quant_pages

        kt, ks = _kv_quant_pages(kt)
        vt, vs = _kv_quant_pages(vt)
        kw.update(k_scale=ks, v_scale=vs)
    args = (q, kt, vt, torch.from_numpy(pt),
            torch.tensor(lens, dtype=torch.int32))
    o, m, l = pa.paged_attention_partials_plain(
        *args, n_split=n_split, pages_per_split=pps, **kw)
    return args, kw, o, m, l


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_merged_partials_equal_plain(W, quant):
    """Partials over page ranges, merged, equal the one-pass plain version:
    lens 0, lens on a page boundary (16 = 2 pages of 8), a mid-page tail,
    a zeroed table row, and splits past each slot's end (3 splits of 1
    page over lens that see 1-3 pages)."""
    lens = [0, 2 * PS, 5, 3 * PS - W]
    args, kw, o, m, l = _merge_case(W, 32, lens, 3, 1, quant, zero_row=3)
    got = pa.merge_partials_plain(o, m, l, torch.float32)
    want = pa.paged_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_split,pps", [(1, 8), (2, 4), (4, 2), (8, 1),
                                         (3, 3)])
def test_merge_across_split_boundaries(n_split, pps):
    """P 8 pages of 8: lens straddling each split boundary, W 2."""
    lens = [7, 8 * 2 - 2, 8 * 4 + 3, 62]
    args, kw, o, m, l = _merge_case(2, 64, lens, n_split, pps, False, P=8,
                                    seed=5)
    got = pa.merge_partials_plain(o, m, l, torch.float32)
    want = pa.paged_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_empty_split_partial_is_neutral():
    """A split with no visible page writes m = -1e30, l = 0, o = 0, and
    leaves the merge unchanged."""
    args, kw, o, m, l = _merge_case(1, 32, [3, 0, 5, 1], 3, 1, False)
    assert (m[1:] == pa.NEG_INF).all() and (l[1:] == 0).all()
    assert (o[1:] == 0).all()
    one = pa.merge_partials_plain(o[:1], m[:1], l[:1], torch.float32)
    torch.testing.assert_close(pa.merge_partials_plain(o, m, l,
                                                       torch.float32),
                               one, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("Sc,h,kvh", [(6, 8, 2), (8, 32, 8)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_split_kernel_matches_plain_on_card(W, hd, Sc, h, kvh):
    """The split kernel at P 32 (ps 16), with lens across split boundaries,
    0, a page boundary and a zeroed row, against the plain version: f32
    and bf16 pools, and int8 pools (f32 and bf16 q), at 1e-5 / 2e-2; int8
    at f32 bit-equal to kernel 1 over the dequantized pools. 6 slots x 2 KV
    heads plan splits of one page, 8 x 8 the decode shape's splits of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (Hopper) and nvcc")
    from paddlepaddle_tpu_torch.inference.decode_engine import \
        _kv_quant_pages

    Pc, psc = 32, 16
    n, pps = pa.split_plan(Sc, kvh, Pc, pa._sm_count(torch.device("cuda")))
    rng = np.random.default_rng(W * hd + Sc)
    bounds = [pps * psc * i for i in range(1, n)] or [psc]
    lens = ([0, bounds[0] - W, bounds[0], bounds[-1] + 1, 2 * psc,
             Pc * psc - W] * 2)[:Sc]
    pages = 1 + Sc * Pc
    kp = torch.from_numpy(rng.standard_normal((pages, psc, kvh, hd),
                                              dtype=np.float32)).cuda()
    vp = torch.from_numpy(rng.standard_normal((pages, psc, kvh, hd),
                                              dtype=np.float32)).cuda()
    pt = rng.permutation(np.arange(1, pages))[: Sc * Pc].reshape(Sc, Pc)
    pt = pt.astype(np.int32)
    pt[4] = 0
    ptc = torch.from_numpy(pt).cuda()
    lc = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.from_numpy(rng.standard_normal((Sc, W, h, hd),
                                             dtype=np.float32)).cuda()
    kw = dict(rep=h // kvh, scale=hd ** -0.5)
    kq, ks = _kv_quant_pages(kp)
    vq, vs = _kv_quant_pages(vp)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        qd, kd, vd = q.to(dtype), kp.to(dtype), vp.to(dtype)
        got = pa.paged_attention(qd, kd, vd, ptc, lc, **kw)
        want = pa.paged_attention_plain(qd, kd, vd, ptc, lc, **kw)
        got8 = pa.paged_attention(qd, kq, vq, ptc, lc, k_scale=ks,
                                  v_scale=vs, **kw)
        want8 = pa.paged_attention_plain(qd, kq, vq, ptc, lc, k_scale=ks,
                                         v_scale=vs, **kw)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= atol
        assert float((got8.float() - want8.float()).abs().max()) <= atol
        if dtype == torch.float32:
            one = pa.paged_attention(
                qd, (kq.float() * ks[:, None, :, None]).contiguous(),
                (vq.float() * vs[:, None, :, None]).contiguous(), ptc, lc,
                **kw)
            torch.cuda.synchronize()
            assert torch.equal(got8, one)
