"""Port varlen flash attention (paddlepaddle_tpu_torch/ops/kernels/flash_varlen.py
and its callers) against the JAX package on the same numpy inputs:

(a) the Pallas kernels, ``_varlen_pallas_fwd`` / ``_varlen_pallas_bwd``, run
    in interpret mode (``pl.pallas_call`` patched with ``interpret=True``
    inside the test; nothing in ``paddlepaddle_tpu/`` changes), against the
    port's plain versions of the three kernels;
(b) the public ``flash_attn_unpadded`` with autograd against the JAX public
    function and ``jax.vjp`` of ``_varlen_xla``;
(c) ``flash_attn_varlen_qkvpacked``, ``flash_attn_qkvpacked`` and
    ``variable_length_memory_efficient_attention`` against their JAX
    counterparts.

Layouts cover causal and full, equal and unequal ``cu_seqlens``, empty
segments first, in the middle and last, a padding tail, and causal segments
with ``len_q > len_k`` (rows that see no key). Dtypes are pinned on both
sides (the JAX package turns x64 on). Tolerances, each with its reason:

* f32 2e-6: online softmax (Pallas) or another summation order against one
  torch softmax differ by a few f32 ulps at values of order 1;
* bf16 2e-2 absolute plus 1e-2 relative: outputs and gradients are rounded
  to bf16 on both sides, and the port's plain forward (as ``_varlen_xla``)
  rounds the probabilities to bf16 before P.V where the Pallas kernel keeps
  them f32; one bf16 ulp is 2^-7 relative at the bottom of a binade;
* rows that see no key (padding, ``len_q > len_k`` under causal masking)
  are held exactly: output and dq 0 on both sides.

JAX is imported inside the comparisons only, so the card tests also run
where JAX is not installed:
``python -m pytest tests/test_torch_flash_varlen.py -m cuda --noconftest``.
"""

import functools

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.incubate.nn import functional as incF
from paddlepaddle_tpu_torch.nn import functional as tF
from paddlepaddle_tpu_torch.nn import long_tail as tLT
from paddlepaddle_tpu_torch.ops.kernels import _build
from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv

H, D = 2, 64
TOL = {"float32": (2e-6, 0.0), "bfloat16": (2e-2, 1e-2)}   # (atol, rtol)

# (lens_q, lens_k, t_q, t_k): t past the sums is a padding tail
LAYOUTS = {
    # empty segments first, in the middle and last, padding tail in both
    "equal": ([0, 5, 9, 0, 3, 20, 0], None, 48, 48),
    # chunked-prefill shape: short q chunks against longer contexts
    "prefill": ([4, 6, 8, 3], [11, 6, 20, 9], 24, 48),
    # len_q > len_k: under causal masking the first rows see no key; one
    # segment has queries and no key at all
    "qlong": ([0, 12, 5, 6], [0, 5, 0, 9], 24, 16),
}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _layout(name):
    lens_q, lens_k, tq, tk = LAYOUTS[name]
    cu_q = _cu(lens_q)
    cu_k = cu_q if lens_k is None else _cu(lens_k)
    return cu_q, cu_k, tq, tk


def _inputs(tq, tk, seed=0, d=D, h=H):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, h, d)).astype(np.float32)
    k = rng.standard_normal((tk, h, d)).astype(np.float32)
    v = rng.standard_normal((tk, h, d)).astype(np.float32)
    do = rng.standard_normal((tq, h, d)).astype(np.float32)
    return q, k, v, do


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _np(t):
    return t.detach().float().numpy()


def _row_ok(cu_q, cu_k, tq, tk, causal):
    return fv.varlen_mask(torch.from_numpy(cu_q), torch.from_numpy(cu_k), tq,
                          tk, causal).any(-1).numpy()


def _port_kernel_plain(q, k, v, do, cu_q, cu_k, causal, dtype):
    """The plain versions of the three kernels, chained as the kernels are
    in training: lse from the forward, delta from its out."""
    tq_, tk_, tv_, tdo = (torch.from_numpy(a).to(_tdt(dtype))
                          for a in (q, k, v, do))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = fv.varlen_attention_plain(tq_, tk_, tv_, cq, ck, causal, scale)
    delta = fv.varlen_delta(out, tdo)
    dq, dk, dv = fv.varlen_bwd_plain(tq_, tk_, tv_, tdo, lse, delta, cq, ck,
                                     causal, scale)
    assert out.dtype == _tdt(dtype) and lse.dtype == torch.float32
    assert tuple(lse.shape) == (q.shape[1], q.shape[0])
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(monkeypatch, dtype, causal, layout):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from paddlepaddle_tpu.ops.kernels import flash_varlen as jfv

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    cu_q, cu_k, tq, tk = _layout(layout)
    q, k, v, do = _inputs(tq, tk)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # the Pallas kernels' layout is [h, t, d]
    jq, jk, jv, jdo = (jnp.asarray(np.swapaxes(a, 0, 1), jdt)
                       for a in (q, k, v, do))
    jcq, jck = jnp.asarray(cu_q, jnp.int32), jnp.asarray(cu_k, jnp.int32)
    scale = 1.0 / np.sqrt(D)
    res = jfv._varlen_pallas_fwd(jq, jk, jv, jcq, jck, causal, scale)
    assert res is not None
    jout, jlse = res
    jdq, jdk, jdv = jfv._varlen_pallas_bwd(jq, jk, jv, jcq, jck, jout, jlse,
                                           jdo, causal, scale)

    def back(x):
        return np.swapaxes(np.asarray(jnp.asarray(x, jnp.float32)), 0, 1)

    want = {"out": back(jout), "lse": np.asarray(jlse, np.float32)[:, :, 0],
            "dq": back(jdq), "dk": back(jdk), "dv": back(jdv)}
    got = _port_kernel_plain(q, k, v, do, cu_q, cu_k, causal, dtype)
    ok = _row_ok(cu_q, cu_k, tq, tk, causal)
    assert not ok.all()                 # every layout has keyless rows
    atol, rtol = TOL[dtype]
    for name, ref in want.items():
        g = _np(got[name])
        if name == "lse":
            np.testing.assert_allclose(g[:, ok], ref[:, ok], atol=atol,
                                       rtol=rtol, err_msg=name)
            # the Pallas kernel's lse on keyless rows is -1e30 too
            np.testing.assert_array_equal(g[:, ~ok], np.float32(-1e30))
            np.testing.assert_allclose(ref[:, ~ok], -1e30, rtol=1e-6)
            continue
        np.testing.assert_allclose(g, ref, atol=atol, rtol=rtol,
                                   err_msg=name)
    for name in ("out", "dq"):
        assert (_np(got[name])[~ok] == 0).all(), name
        assert (want[name][~ok] == 0).all(), name


def _port_public(q, k, v, do, cu_q, cu_k, causal, dtype, cu_kind="numpy"):
    tq_, tk_, tv_ = (torch.from_numpy(a).to(_tdt(dtype)).requires_grad_(True)
                     for a in (q, k, v))
    conv = {"numpy": lambda c: c, "list": lambda c: c.tolist(),
            "int64": lambda c: torch.from_numpy(c.astype(np.int64)),
            "int32": torch.from_numpy}[cu_kind]
    out, none = tF.flash_attn_unpadded(tq_, tk_, tv_, conv(cu_q), conv(cu_k),
                                       max_seqlen_q=7, max_seqlen_k=7,
                                       causal=causal)
    assert none is None and out.dtype == _tdt(dtype)
    grads = torch.autograd.grad(out, (tq_, tk_, tv_),
                                torch.from_numpy(do).to(_tdt(dtype)))
    return [out] + list(grads)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_public_matches_jax_public_and_vjp(dtype, causal, layout):
    import jax
    import jax.numpy as jnp

    from paddlepaddle_tpu.ops.kernels import flash_varlen as jfv

    cu_q, cu_k, tq, tk = _layout(layout)
    q, k, v, do = _inputs(tq, tk, seed=1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jcq, jck = jnp.asarray(cu_q, jnp.int32), jnp.asarray(cu_k, jnp.int32)
    scale = 1.0 / np.sqrt(D)
    jpub, _ = jfv.flash_attn_unpadded(jq, jk, jv, jcq, jck, causal=causal)
    jout, vjp = jax.vjp(
        lambda a, b_, c: jfv._varlen_xla(a, b_, c, jcq, jck, causal, scale),
        jq, jk, jv)
    want = [jout] + list(vjp(jdo))
    got = _port_public(q, k, v, do, cu_q, cu_k, causal, dtype)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(_np(got[0]),
                               np.asarray(jnp.asarray(jpub.numpy(),
                                                      jnp.float32)),
                               atol=atol, rtol=rtol, err_msg="public out")
    for name, a, ref in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a),
                                   np.asarray(jnp.asarray(ref, jnp.float32)),
                                   atol=atol, rtol=rtol, err_msg=name)
    ok = _row_ok(cu_q, cu_k, tq, tk, causal)
    assert (_np(got[0])[~ok] == 0).all() and (_np(got[1])[~ok] == 0).all()


@pytest.mark.parametrize("cu_kind", ["list", "int64", "int32"])
def test_cu_seqlens_forms_agree(cu_kind):
    cu_q, cu_k, tq, tk = _layout("prefill")
    q, k, v, do = _inputs(tq, tk, seed=2)
    want = _port_public(q, k, v, do, cu_q, cu_k, True, "float32")
    got = _port_public(q, k, v, do, cu_q, cu_k, True, "float32", cu_kind)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, atol=0, rtol=0)


@pytest.mark.parametrize("cu_q,cu_k,match", [
    ([1, 4, 8], [0, 4, 8], "start at 0"),
    ([0, 6, 4], [0, 4, 8], "not decrease"),
    ([0, 4, 20], [0, 4, 8], "end at"),
    ([0, 4, 8], [0, 8], "len"),
    ([[0, 4]], [[0, 4]], "1-D"),
])
def test_cu_seqlens_validated(cu_q, cu_k, match):
    q = torch.zeros(8, H, D)
    with pytest.raises(ValueError, match=match):
        tF.flash_attn_unpadded(q, q, q, cu_q, cu_k)


@pytest.mark.parametrize("layout,causal", [("equal", True), ("prefill", True),
                                           ("qlong", True), ("qlong", False)])
def test_varlen_core_cpu_route_matches_autograd(layout, causal):
    """``_VarlenCore`` on CPU tensors runs the wrappers' plain versions: the
    saved residual, the f32 ``delta`` and the recompute backward give
    autograd's gradients of the plain forward, and no kernel is counted."""
    cu_q, cu_k, tq, tk = _layout(layout)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(tq, tk, seed=4))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    scale = 1.0 / np.sqrt(D)
    before = (fv.varlen_fwd.launches, fv.varlen_bwd_dq.launches,
              fv.varlen_bwd_dkv.launches)
    qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fv._VarlenCore.apply(qa, ka, va, cq, ck, causal, scale)
    got = torch.autograd.grad(out, (qa, ka, va), do)
    qb, kb, vb = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref_out, _ = fv.varlen_attention_plain(qb, kb, vb, cq, ck, causal, scale)
    want = torch.autograd.grad(ref_out, (qb, kb, vb), do)
    np.testing.assert_allclose(_np(out), _np(ref_out), atol=2e-6, rtol=0)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(b_), atol=2e-6, rtol=0,
                                   err_msg=name)
    assert (fv.varlen_fwd.launches, fv.varlen_bwd_dq.launches,
            fv.varlen_bwd_dkv.launches) == before


def test_plain_head_chunks_agree(monkeypatch):
    """The plain versions split heads into chunks to bound memory; a chunk of
    one head gives what one chunk of all heads gives."""
    cu_q, cu_k, tq, tk = _layout("prefill")
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(tq, tk, seed=5, h=3))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    whole = fv.varlen_attention_plain(q, k, v, cq, ck, True, 0.125)
    bwd = fv.varlen_bwd_plain(q, k, v, do, whole[1],
                              fv.varlen_delta(whole[0], do), cq, ck, True,
                              0.125)
    monkeypatch.setattr(fv, "PLAIN_CHUNK_ELEMS", 1)
    assert len(fv._head_chunks(3, tq, tk)) == 3
    split = fv.varlen_attention_plain(q, k, v, cq, ck, True, 0.125)
    bwd_split = fv.varlen_bwd_plain(q, k, v, do, split[1],
                                    fv.varlen_delta(split[0], do), cq, ck,
                                    True, 0.125)
    for a, b_ in zip(split + bwd_split, whole + bwd):
        torch.testing.assert_close(a, b_, atol=0, rtol=0)


def test_dropout():
    """Dropout computes the plain version with inverted scaling: off when
    ``training=False`` or the rate is 0, deterministic under
    ``fixed_seed_offset``, different for two seeds, unbiased over seeds,
    gradients flow; ``return_softmax`` raises."""
    cu = np.array([0, 20, 48], np.int32)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(48, 48, seed=6))
    base, _ = tF.flash_attn_unpadded(q, k, v, cu, cu, causal=True)
    for kw in ({"dropout": 0.5, "training": False}, {"dropout": 0.0}):
        same, _ = tF.flash_attn_unpadded(q, k, v, cu, cu, causal=True, **kw)
        torch.testing.assert_close(same, base, atol=0, rtol=0)

    def run(seed, **kw):
        return tF.flash_attn_unpadded(q, k, v, cu, cu, causal=True,
                                      dropout=0.4, fixed_seed_offset=seed,
                                      **kw)[0]

    outs = [run(s) for s in (0, 1)]
    assert not torch.allclose(outs[0], outs[1])
    torch.testing.assert_close(run(0), outs[0], atol=0, rtol=0)
    mean = sum(run(s) for s in range(24)) / 24
    err = float((mean - base).abs().mean())
    assert err < 0.25, err
    qa = q.clone().requires_grad_(True)
    dropped, _ = tF.flash_attn_unpadded(qa, k, v, cu, cu, causal=True,
                                        dropout=0.4, fixed_seed_offset=3)
    g, = torch.autograd.grad(dropped.sum(), (qa,))
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    with pytest.raises(ValueError, match="return_softmax"):
        tF.flash_attn_unpadded(q, k, v, cu, cu, return_softmax=True)


def test_dropout_follows_port_seed():
    """Without ``fixed_seed_offset`` the mask draws from the port's seeded
    stream (core/random.py), not from torch's global generator."""
    from paddlepaddle_tpu_torch.core import random as prandom

    cu = np.array([0, 20, 48], np.int32)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(48, 48, seed=7))

    def run():
        return tF.flash_attn_unpadded(q, k, v, cu, cu, causal=True,
                                      dropout=0.3)[0]

    prandom.seed(11)
    first = run()
    prandom.seed(11)
    torch.manual_seed(123)
    torch.testing.assert_close(run(), first, atol=0, rtol=0)
    assert not torch.equal(run(), first)     # the stream moved on


@pytest.mark.parametrize("causal", [True, False])
def test_varlen_qkvpacked_matches_jax(causal):
    import jax.numpy as jnp

    from paddlepaddle_tpu.nn import long_tail as jLT

    cu_q, cu_k, tq, _ = _layout("equal")
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((tq, 3, H, D)).astype(np.float32)
    want, _ = jLT.flash_attn_varlen_qkvpacked(
        jnp.asarray(qkv, jnp.float32), cu_q, cu_q, 20, 20, causal=causal)
    got, none = tLT.flash_attn_varlen_qkvpacked(torch.from_numpy(qkv), cu_q,
                                                cu_q, 20, 20, causal=causal)
    assert none is None
    np.testing.assert_allclose(_np(got), np.asarray(want.numpy(), np.float32),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_qkvpacked_matches_jax(causal):
    import jax.numpy as jnp

    from paddlepaddle_tpu.nn import long_tail as jLT

    rng = np.random.default_rng(9)
    qkv = rng.standard_normal((2, 24, 3, H, D)).astype(np.float32)
    want, _ = jLT.flash_attn_qkvpacked(jnp.asarray(qkv, jnp.float32),
                                       causal=causal)
    got, none = tLT.flash_attn_qkvpacked(torch.from_numpy(qkv), causal=causal)
    assert none is None
    np.testing.assert_allclose(_np(got), np.asarray(want.numpy(), np.float32),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_variable_length_attention_matches_jax(causal):
    import jax.numpy as jnp

    from paddlepaddle_tpu.incubate.nn import functional as jinc

    rng = np.random.default_rng(10)
    b, s = 3, 16
    q = rng.standard_normal((b, H, s, D)).astype(np.float32)
    k = rng.standard_normal((b, H, s, D)).astype(np.float32)
    v = rng.standard_normal((b, H, s, D)).astype(np.float32)
    lens = np.array([16, 5, 0], np.int32)
    kv_lens = np.array([16, 9, 4], np.int32)
    want = jinc.variable_length_memory_efficient_attention(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)), lens, kv_lens,
        causal=causal)
    got = incF.variable_length_memory_efficient_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(lens),
        kv_lens, causal=causal)
    assert tuple(got.shape) == (b, H, s, D)
    np.testing.assert_allclose(_np(got), np.asarray(want.numpy(), np.float32),
                               atol=2e-6, rtol=0)
    assert (_np(got)[1, :, 5:] == 0).all() and (_np(got)[2] == 0).all()


def test_variable_length_attention_refuses_mask_and_cache():
    q = torch.zeros(1, H, 8, D)
    lens = np.array([8], np.int32)
    with pytest.raises(NotImplementedError, match="mask"):
        incF.variable_length_memory_efficient_attention(
            q, q, q, lens, lens, mask=torch.ones(1, 1, 8, 8, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="pre_cache_length"):
        incF.variable_length_memory_efficient_attention(
            q, q, q, lens, lens, pre_cache_length=4)


@pytest.mark.parametrize("args,ok,why", [
    ((128, torch.bfloat16), True, "ok"),
    ((64, torch.float32), True, "ok"),
    ((256, torch.bfloat16), False, "head_dim"),
    ((96, torch.float32), False, "head_dim"),
    ((128, torch.float16), False, "dtype"),
])
def test_support_check(args, ok, why):
    got, reason = fv.varlen_supported(*args)
    assert got is ok and why in reason


@pytest.mark.parametrize("kind,dtype,library", [
    ("fwd", torch.bfloat16, "flash_varlen_sm90"),
    ("dkv", torch.bfloat16, "flash_varlen_sm90"),
    ("dq", torch.bfloat16, "flash_varlen"),
    ("fwd", torch.float32, "flash_varlen"),
    ("dq", torch.float32, "flash_varlen"),
    ("dkv", torch.float32, "flash_varlen"),
])
def test_kernel_dispatch_by_dtype(kind, dtype, library):
    """bf16 forward and dK/dV go to the TMA/``wgmma`` kernels of
    ``csrc/flash_varlen_sm90.cu``; the bf16 dQ and every f32 kernel stay on
    ``csrc/flash_varlen.cu``; both sources are built from the checkout."""
    name, entry, _ = fv._ENTRIES[(kind, dtype)]
    assert name == library
    assert entry.endswith("_sm90_launch") == (library == "flash_varlen_sm90")
    assert name in _build.sources()
    assert name in fv._ERROR_STRING


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises, never falls back."""
    q = torch.empty(8, 2, D, device="meta")
    rows = torch.empty(2, 8, device="meta")
    cu = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fv.varlen_fwd(q, q, q, cu, cu, True, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fv.varlen_bwd_dq(q, q, q, q, rows, rows, cu, cu, True, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fv.varlen_bwd_dkv(q, q, q, q, rows, rows, cu, cu, True, 0.125)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_LAYOUTS = dict(LAYOUTS, **{
    # 64 segments of one token, ragged t
    "ones": ([1] * 64, None, 67, 67),
    # a tile spanning five segments, one shorter than a tile, t not a
    # multiple of 8
    "mixed": ([3, 40, 7, 0, 5, 9, 100], [3, 40, 7, 2, 5, 9, 100], 171, 173),
    # only the sm90 kernels' 128-row tiles reach these: a tile over three
    # segments and a segment longer than 3 stages of 128 keys; len_k > len_q
    # over several key tiles with t_q % 4 != 0
    "tile128": ([100, 156, 1, 300, 0, 211], None, 800, 800),
    "prefill128": ([130, 7, 260], [900, 7, 700], 397, 1607),
})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_on_card(dtype, atol):
    """The three kernels through ``flash_attn_unpadded`` against the plain
    forward and its autograd backward on the card: every layout, causal and
    full, d 64 and 128; keyless rows exactly 0. The prefix sums go in as
    int64 tensors already on the card (taken without a host read-back)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) to run the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    for d in (64, 128):
        for causal in (True, False):
            for name in sorted(CARD_LAYOUTS):
                lens_q, lens_k, tq, tk = CARD_LAYOUTS[name]
                cu_q = _cu(lens_q)
                cu_k = cu_q if lens_k is None else _cu(lens_k)
                q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                               for a in _inputs(tq, tk, seed=11, d=d))
                counts = (fv.varlen_fwd.launches, fv.varlen_bwd_dq.launches,
                          fv.varlen_bwd_dkv.launches)
                qa, ka, va = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                out, _ = tF.flash_attn_unpadded(
                    qa, ka, va, torch.from_numpy(cu_q).to("cuda", torch.int64),
                    torch.from_numpy(cu_k).to("cuda", torch.int64),
                    causal=causal)
                got = torch.autograd.grad(out, (qa, ka, va), do)
                assert (fv.varlen_fwd.launches, fv.varlen_bwd_dq.launches,
                        fv.varlen_bwd_dkv.launches) == tuple(
                            c + 1 for c in counts)
                qb, kb, vb = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                ref, _ = fv.varlen_attention_plain(
                    qb, kb, vb, torch.from_numpy(cu_q).cuda(),
                    torch.from_numpy(cu_k).cuda(), causal, d ** -0.5)
                want = torch.autograd.grad(ref, (qb, kb, vb), do)
                torch.cuda.synchronize()
                for a, b_ in zip((out,) + got, (ref,) + want):
                    err = float((a.float() - b_.float()).abs().max())
                    assert err <= atol, (d, causal, name, err)
                ok = torch.from_numpy(_row_ok(cu_q, cu_k, tq, tk,
                                              causal)).cuda()
                assert (out[~ok] == 0).all() and (got[0][~ok] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_sm90_matches_dense_on_card(d, causal):
    """One segment over the whole buffer is dense attention at [1, s, h, d]:
    the bf16 varlen forward and dK/dV (``csrc/flash_varlen_sm90.cu``)
    against the dense sm90 kernels at s 1000 (not a multiple of the 128-row
    tile), within 2e-2 (both round p to bf16 in other tile orders). Each
    wrapper launches once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) to run the CUDA kernels")
    s, h, scale = 1000, 4, d ** -0.5
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   for a in _inputs(s, s, seed=d + causal, d=d, h=h))
    cu = torch.tensor([0, s], dtype=torch.int32, device="cuda")
    counts = (fv.varlen_fwd.launches, fv.varlen_bwd_dkv.launches)
    out, lse = fv.varlen_fwd(q, k, v, cu, cu, causal, scale)
    delta = fv.varlen_delta(out, do)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, cu, cu, causal, scale)
    assert (fv.varlen_fwd.launches,
            fv.varlen_bwd_dkv.launches) == (counts[0] + 1, counts[1] + 1)
    b4 = [x.unsqueeze(0) for x in (q, k, v, do)]
    out_d, lse_d = fa.flash_fwd(*b4[:3], causal, scale)
    delta_d = fa.flash_delta(out_d, b4[3])
    dk_d, dv_d = fa.flash_bwd_dkv(*b4, lse_d, delta_d, causal, scale)
    torch.cuda.synchronize()
    for name, a, b_ in (("out", out, out_d[0]), ("lse", lse, lse_d),
                        ("dk", dk, dk_d[0]), ("dv", dv, dv_d[0])):
        err = float((a.float() - b_.float()).abs().max())
        assert err <= 2e-2, (name, d, causal, err)


@pytest.mark.cuda
def test_bf16_dkv_sm90_deterministic_on_card():
    """One writer per key row and no atomics: two launches of the bf16
    varlen dK/dV give the same bits (causal, segments over tile ends)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) to run the CUDA kernels")
    lens_q, lens_k, tq, tk = CARD_LAYOUTS["tile128"]
    cu = torch.from_numpy(_cu(lens_q)).cuda()
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   for a in _inputs(tq, tk, seed=5, d=128, h=4))
    scale = 128 ** -0.5
    out, lse = fv.varlen_fwd(q, k, v, cu, cu, True, scale)
    delta = fv.varlen_delta(out, do)
    first = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, cu, cu, True, scale)
    again = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, cu, cu, True, scale)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dk", "dv"), first, again):
        assert torch.equal(a, b_), name
