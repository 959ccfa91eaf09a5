"""Ring attention's kernel path on the card
(``paddlepaddle_tpu_torch/ops/kernels/ring_attention.py``), held against
the plain dense attention on the same inputs. No JAX here (the card's
machine has none).

* The SPMD form: four gloo ranks that share the card (one ``spawn`` for
  every case), each passing its sequence block of CUDA tensors: kernels
  2-4 once per visible K/V block (``r + 1`` under ``causal``, else 4), the
  K/V point to point; each rank's output block and its q, k, v gradient
  blocks against the dense attention's.
* The one-process form (a mesh of four ``sp`` ranks and no group): one
  call over the whole arrays, kernels 2-4 once each.

    python -m pytest tests/test_torch_ring_attention_card.py -m cuda --noconftest
"""

import functools
import math

import pytest
import torch

pytestmark = pytest.mark.cuda

# (dtype, head dim, atol): f32 runs the FMA kernels, bf16 the wgmma ones
CASES = [(torch.float32, 64, 1e-4), (torch.bfloat16, 128, 3e-2)]
N, B, S, H, KVH = 4, 2, 512, 8, 2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the flash kernels)")


def _inputs(dtype, d):
    g = torch.Generator().manual_seed(3)
    q, k, v, cot = (torch.randn((B, S, hh, d), generator=g).to(dtype)
                    for hh in (H, KVH, KVH, H))
    return q, k, v, cot


def _launches(fa):
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches)


def _ring_rank(cases):
    """One of four SPMD ranks: every case's blocks through
    ``ring_attention`` on the card, forward and backward. Inputs and
    results cross the process boundary as f32 numpy arrays (the bf16
    inputs' values are exact in f32)."""
    from paddlepaddle_tpu_torch.distributed import (ProcessMesh, get_rank,
                                                    get_world_size,
                                                    init_parallel_env)
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels.ring_attention import \
        ring_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    init_parallel_env(backend="gloo")
    n, r = get_world_size(), get_rank()
    mesh = ProcessMesh(shape=[n], dim_names=["sp"])
    out = {}
    for key, (arrays, dtype, causal) in cases.items():
        q, k, v, cot = (torch.from_numpy(a).chunk(n, dim=1)[r].cuda()
                        .to(getattr(torch, dtype)).contiguous()
                        for a in arrays)
        ts = [t.requires_grad_() for t in (q, k, v)]
        for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
            w.launches = 0
        o = ring_attention(*ts, mesh, causal=causal)
        (o.float() * cot.float()).sum().backward()
        out[key] = {"out": o.detach().float().cpu().numpy(),
                    "grads": [t.grad.float().cpu().numpy() for t in ts],
                    "launches": _launches(fa)}
    return out


@functools.lru_cache(maxsize=None)
def _ring_runs():
    from paddlepaddle_tpu_torch.distributed import spawn

    cases = {f"{dtype} {causal}": (
        [t.float().numpy() for t in _inputs(dtype, d)],
        str(dtype).split(".")[-1], causal)
        for dtype, d, _ in CASES for causal in (True, False)}
    return spawn(_ring_rank, args=(cases,), nprocs=N, timeout=600,
                 pg_timeout=300)


def _dense(q, k, v, cot, causal):
    """The plain dense attention on the card in f32: output and q, k, v
    gradients of ``sum(out * cot)``."""
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    ts = [t.detach().cuda().float().requires_grad_() for t in (q, k, v)]
    rep = H // KVH
    out = fa.flash_attention_plain(
        ts[0], ts[1].repeat_interleave(rep, 2),
        ts[2].repeat_interleave(rep, 2), causal,
        1.0 / math.sqrt(q.shape[-1]))[0]
    (out * cot.cuda().float()).sum().backward()
    return out.detach(), [t.grad for t in ts]


def _close(got, want, atol, name):
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cuda().float(), want,
                               atol=atol * max(scale, 1.0), rtol=0, msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,d,atol", CASES)
def test_ring_kernel_path_matches_dense_on_card(dtype, d, atol, causal):
    _need_card()
    ranks = _ring_runs()
    want, want_grads = _dense(*_inputs(dtype, d), causal)
    for r, got in enumerate(ranks):
        run = got[f"{dtype} {causal}"]
        blocks = r + 1 if causal else N
        assert run["launches"] == (blocks, blocks, blocks), (r, run)
        torch.testing.assert_close(torch.from_numpy(run["out"]).cuda(),
                                   want.chunk(N, dim=1)[r], atol=atol,
                                   rtol=0)
        for g, w, name in zip(run["grads"], want_grads, "qkv"):
            _close(torch.from_numpy(g), w.chunk(N, dim=1)[r], atol,
                   f"rank {r} d{name}")


@pytest.mark.parametrize("dtype,d,atol", CASES)
def test_one_process_form_is_one_flash_call_on_card(dtype, d, atol):
    _need_card()
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels.ring_attention import \
        ring_attention

    q, k, v, cot = _inputs(dtype, d)
    ts = [t.cuda().requires_grad_() for t in (q, k, v)]
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = 0
    out = ring_attention(*ts, ProcessMesh(shape=[N], dim_names=["sp"]),
                         causal=True)
    (out.float() * cot.cuda().float()).sum().backward()
    assert _launches(fa) == (1, 1, 1)
    want, want_grads = _dense(q, k, v, cot, True)
    torch.testing.assert_close(out.float(), want, atol=atol, rtol=0)
    for t, w, name in zip(ts, want_grads, "qkv"):
        _close(t.grad, w, atol, f"d{name}")
