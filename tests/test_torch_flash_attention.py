"""Port flash attention (paddlepaddle_tpu_torch/ops/kernels/flash_attention.py)
against the JAX package on the same numpy inputs, in two ways:

(a) the Pallas kernels themselves, ``_pallas_forward`` / ``_pallas_backward``,
    run in interpret mode (``pl.pallas_call`` patched with
    ``interpret=True`` inside the test; nothing in ``paddlepaddle_tpu/``
    changes);
(b) ``_xla_attention`` and its ``jax.vjp``, the JAX package's plain path.

out, lse, dq, dk and dv are compared, at f32 and bf16, causal and full, and
``s_q < s_k``. Dtypes are pinned on both sides (the JAX package turns x64
on). Tolerances, each with its reason:

* f32 2e-6: the online softmax of the Pallas kernels against one torch
  softmax, and another summation order in the products, differ by a few
  f32 ulps at values of order 1 (measured: 6e-7 forward, 7e-7 gradients);
* bf16 2e-2 absolute plus 1e-2 relative: outputs and gradients are rounded
  to bf16 on both sides, and the port's plain path (as ``_xla_attention``)
  rounds the probabilities to bf16 before P.V where the Pallas kernel keeps
  them f32; one bf16 ulp is 2^-7 relative at the bottom of a binade, so a
  gradient of magnitude 4 may differ by 0.031 (one ulp) on rounding
  alone;
* the CPU route of the kernel wrappers (``_FlashCore`` through the plain
  versions of the three kernels) against autograd of the plain forward:
  2e-6 at f32, the same two orders of summation.

JAX is imported inside the comparisons only, so the card test also runs
where JAX is not installed:
``python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest``.
"""

import functools

import numpy as np
import pytest
import torch

from paddlepaddle_tpu_torch.nn import functional as tF
from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

B, H, D = 2, 2, 64
TOL = {"float32": (2e-6, 0.0), "bfloat16": (2e-2, 1e-2)}   # (atol, rtol)


def _inputs(sq, sk, seed=0, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, d)).astype(np.float32)
    k = rng.standard_normal((B, sk, H, d)).astype(np.float32)
    v = rng.standard_normal((B, sk, H, d)).astype(np.float32)
    do = rng.standard_normal((B, sq, H, d)).astype(np.float32)
    return q, k, v, do


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _port(q, k, v, do, causal, dtype):
    """The port's plain forward and its autograd backward (CPU)."""
    tq, tk, tv = (torch.from_numpy(a).to(_tdt(dtype)).requires_grad_(True)
                  for a in (q, k, v))
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal, scale)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(do).to(_tdt(dtype)))
    assert out.dtype == _tdt(dtype) and lse.dtype == torch.float32
    return {"out": out, "lse": lse, "dq": grads[0], "dk": grads[1],
            "dv": grads[2]}


def _np(t):
    return t.detach().float().numpy()


def _flat(x):
    """[b, s, h, d] -> the Pallas kernels' [b*h, s, d]."""
    b, s, h, d = x.shape
    return np.swapaxes(x, 1, 2).reshape(b * h, s, d)


def _unflat(x, b, h):
    bh, s, d = x.shape
    return np.swapaxes(np.asarray(x).reshape(b, h, s, d), 1, 2)


@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(monkeypatch, dtype, causal, sq, sk):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from paddlepaddle_tpu.ops.kernels import flash_attention as jfa

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    q, k, v, do = _inputs(sq, sk)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(_flat(a), jdt) for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(D)
    res = jfa._pallas_forward(jq, jk, jv, causal, scale)
    assert res is not None
    jout, jlse = res
    jdq, jdk, jdv = jfa._pallas_backward(jq, jk, jv, jout, jlse, jdo, causal,
                                         scale)
    want = {"out": _unflat(jnp.asarray(jout, jnp.float32), B, H),
            "lse": np.asarray(jlse, np.float32)[:, :, 0],
            "dq": _unflat(jnp.asarray(jdq, jnp.float32), B, H),
            "dk": _unflat(jnp.asarray(jdk, jnp.float32), B, H),
            "dv": _unflat(jnp.asarray(jdv, jnp.float32), B, H)}
    got = _port(q, k, v, do, causal, dtype)
    for name, ref in want.items():
        atol, rtol = TOL[dtype]
        np.testing.assert_allclose(_np(got[name]), ref, atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 64), (37, 50)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_attention_and_vjp(dtype, causal, sq, sk):
    import jax
    import jax.numpy as jnp

    from paddlepaddle_tpu.ops.kernels import flash_attention as jfa

    q, k, v, do = _inputs(sq, sk, seed=1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(D)
    jout, vjp = jax.vjp(
        lambda a, b_, c: jfa._xla_attention(a, b_, c, causal, None, scale),
        jq, jk, jv)
    jgrads = vjp(jdo)
    got = _port(q, k, v, do, causal, dtype)
    want = {"out": jout, "dq": jgrads[0], "dk": jgrads[1], "dv": jgrads[2]}
    atol, rtol = TOL[dtype]
    for name, ref in want.items():
        np.testing.assert_allclose(_np(got[name]),
                                   np.asarray(jnp.asarray(ref, jnp.float32)),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("mask_kind", ["bool", "float"])
def test_masked_attention_matches_xla(mask_kind):
    """The ``mask=`` branch computes in plain PyTorch, as the JAX package
    computes it outside Pallas."""
    import jax.numpy as jnp

    from paddlepaddle_tpu.ops.kernels import flash_attention as jfa

    q, k, v, _ = _inputs(16, 24, seed=2)
    rng = np.random.default_rng(3)
    if mask_kind == "bool":
        mask = rng.random((B, H, 16, 24)) > 0.3
        mask[..., 0] = True
    else:
        mask = rng.standard_normal((B, 1, 16, 24)).astype(np.float32)
    want = jfa._xla_attention(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                              True, jnp.asarray(mask), 1.0 / np.sqrt(D))
    got = fa.flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("sq,sk,causal", [(64, 64, True), (40, 100, True),
                                          (100, 100, False), (80, 30, False)])
def test_flash_core_cpu_route_matches_autograd(sq, sk, causal):
    """``_FlashCore`` on CPU tensors runs the wrappers' plain versions: the
    compact residual, the f32 ``delta`` and the recompute backward must give
    autograd's gradients, and no kernel is counted."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(sq, sk, seed=4))
    scale = 1.0 / np.sqrt(D)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fa._FlashCore.apply(qa, ka, va, causal, scale)
    got = torch.autograd.grad(out, (qa, ka, va), do)
    qb, kb, vb = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref_out, _ = fa.flash_attention_plain(qb, kb, vb, causal, scale)
    want = torch.autograd.grad(ref_out, (qb, kb, vb), do)
    np.testing.assert_allclose(_np(out), _np(ref_out), atol=2e-6, rtol=0)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(b_), atol=2e-6, rtol=0,
                                   err_msg=name)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before


def test_functional_routes():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(16, 16, seed=5))
    out, none = tF.flash_attention(q, k, v, causal=True)
    assert none is None and tuple(out.shape) == (B, 16, H, D)
    ref = fa.flash_attention_bshd(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    sdpa = tF.scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.testing.assert_close(sdpa, ref, atol=0, rtol=0)
    # dropout: kept entries scaled by 1/(1-p), the rest zero
    torch.manual_seed(0)
    dropped = tF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                              is_causal=True)
    kept = dropped != 0
    assert 0.3 < kept.float().mean() < 0.7
    torch.testing.assert_close(dropped[kept], 2 * ref[kept])
    # training=False turns dropout off
    torch.testing.assert_close(
        tF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                        is_causal=True, training=False), ref)


@pytest.mark.parametrize("args,ok,why", [
    ((128, torch.bfloat16, True, 2048, 2048), True, "ok"),
    ((64, torch.float32, False, 100, 37), True, "ok"),
    ((64, torch.float32, True, 37, 100), True, "ok"),
    ((256, torch.bfloat16, True, 64, 64), False, "head_dim"),
    ((96, torch.bfloat16, True, 64, 64), False, "head_dim"),
    ((128, torch.float16, True, 64, 64), False, "dtype"),
    ((128, torch.bfloat16, True, 100, 37), False, "no visible key"),
    ((128, torch.bfloat16, False, 0, 37), False, "empty"),
])
def test_support_check(args, ok, why):
    got, reason = fa.flash_attention_supported(*args)
    assert got is ok and why in reason


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_on_card(dtype, atol):
    """The three kernels against the plain forward and its autograd backward
    on the card (ragged lengths, s_q < s_k, causal and full, d 64 and 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) to run the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    for d in (64, 128):
        for causal in (True, False):
            for sq, sk in ((100, 100), (64, 192)):
                q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                               for a in _inputs(sq, sk, seed=6, d=d))
                scale = d ** -0.5
                counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
                          fa.flash_bwd_dkv.launches)
                qa, ka, va = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                out = fa.flash_attention_bshd(qa, ka, va, causal=causal)
                got = torch.autograd.grad(out, (qa, ka, va), do)
                assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
                        fa.flash_bwd_dkv.launches) == tuple(
                            c + 1 for c in counts)
                qb, kb, vb = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                ref, _ = fa.flash_attention_plain(qb, kb, vb, causal, scale)
                want = torch.autograd.grad(ref, (qb, kb, vb), do)
                torch.cuda.synchronize()
                for a, b_ in zip((out,) + got, (ref,) + want):
                    err = float((a.float() - b_.float()).abs().max())
                    assert err <= atol, (d, causal, sq, sk, err)


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises, never falls back."""
    q = torch.empty(1, 8, 2, D, device="meta")
    rows = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(q, q, q, True, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_bwd_dq(q, q, q, q, rows, rows, True, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.125)
