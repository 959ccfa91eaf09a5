"""Ring attention: context parallelism over a sequence mesh axis
(counterpart of ``paddlepaddle_tpu/ops/kernels/ring_attention.py``).

The sequence dim of Q/K/V is sharded over a mesh axis (``sp``). Each rank
keeps its Q block and the K/V blocks travel around the ring; the rank
merges each block's partial attention into a running online-softmax
state. The reference is a ``lax.scan`` of :func:`_block_attn_update` and
``ppermute`` inside ``shard_map`` (no Pallas); ``jax.grad`` gives its
backward ring.

Two forms, by what the process has:

* **SPMD** (a process group, or a plan bound to ranks of its own): each
  rank passes its LOCAL blocks ``[b, s_loc, h, d]`` and gets its local
  output. The K/V blocks move point to point over the ``sp`` group
  (``collective._send_to`` / ``_recv_from``: one message a step to the
  next rank, posted before the step's block is computed). Their bytes and
  seconds land in ``collective_stats()`` as ``p2p_send`` / ``p2p_recv``.
* **One process** (a mesh of ``n`` ranks along ``sp`` and no group, the
  reference's single-controller call): the caller passes the GLOBAL
  arrays and gets attention over the whole sequences, one call (the flash
  kernels on the card, the plain version on the CPU), with no collective.
  The reference's ring over ``n`` shards computes the same values.

K/V arrive with their own (possibly fewer, GQA) heads and are repeated to
q's heads after each block is received, so the ring moves the un-repeated
heads: a quarter of the bytes at Llama-3-8B's 32 q / 8 KV heads. The
reference repeats before the ring (its ``models/llama.py:246-249``); the
values are the same.

The math, by device:

* CPU tensors (and a head dim the JAX flash gate refuses, on either
  device) run the plain version: the reference's loop of
  :func:`_block_attn_update` in f32, K/V shifted by a differentiable
  point-to-point shift (:class:`_Shift`), autograd for the backward.
* CUDA tensors run :class:`_RingFlash`, whose blocks are the flash kernels
  (rows 2-4 of the kernel table): at ring step ``t`` rank ``r`` holds the
  block of rank ``j = (r - t) mod n``; a past block (``j < r``) is one
  ``flash_fwd(causal=False)``, the diagonal block ``causal=True``, a
  future block under ``causal`` no launch (without ``causal`` every block
  is ``causal=False``). The blocks' ``(out, lse)`` merge in f32 by
  ``logaddexp``. The backward forms ``delta = rowsum(dO * O)`` once and
  sends the K/V around a second ring with f32 dK/dV accumulators that
  travel with their block and are home after ``n`` shifts; each visible
  block runs ``flash_bwd_dq`` and ``flash_bwd_dkv`` with the GLOBAL
  ``lse`` and ``delta``, so each gives that block's exact share. A kernel
  that does not build or launch raises; there is no plain fallback on
  this path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ...amp import amp_cast
from ...distributed import collective as C
from .flash_attention import (_FlashCore, flash_attention_plain,
                              flash_bwd_dkv, flash_bwd_dq, flash_delta,
                              flash_fwd, routes_to_plain)

NEG_INF = -1e30


def _block_attn_update(q, k, v, m, l, acc, q_off, k_off, causal, scale):
    """Online-softmax update of ``(m, l, acc)`` with one K/V block
    (reference :35).

    q: ``[b, sq, h, d]``; k/v: ``[b, sk, h, d]``; m/l: ``[b, h, sq, 1]``;
    acc ``[b, h, sq, d]`` (f32). ``q_off`` / ``k_off``: the blocks' global
    sequence offsets."""
    qf = q.transpose(1, 2).float() * scale
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if causal:
        q_pos = q_off + torch.arange(s.shape[2], device=s.device)[:, None]
        k_pos = k_off + torch.arange(s.shape[3], device=s.device)[None, :]
        s = s.masked_fill(~(q_pos >= k_pos), NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.matmul(p, vf)
    return m_new, l_new, acc_new


# -- where this rank sits on the ring -----------------------------------------


def _active_mesh():
    from ...distributed.mesh import get_mesh

    return C._mesh_stack[-1] if C._mesh_stack else get_mesh()


def _axis_sizes(mesh) -> dict:
    if hasattr(mesh, "axes"):
        return dict(mesh.axes)
    if hasattr(mesh, "dim_names"):
        return dict(zip(mesh.dim_names, mesh.shape))
    return dict(mesh.shape)


class _Ring:
    """Rank ``r`` of ``n`` along the sequence axis. ``pg`` is the axis's
    group in the SPMD form (None for an axis of one rank); ``local`` marks
    the one-process form, where the caller holds every shard."""

    def __init__(self, n: int, r: int, pg=None, local: bool = False):
        self.n, self.r, self.pg, self.local = int(n), int(r), pg, local


def ring_of(mesh, sp_axis: str) -> _Ring:
    """This process's place on the ``sp_axis`` ring of ``mesh`` (a
    :class:`~...distributed.shard_plan.ShardingPlan`, a ``ProcessMesh``, or
    None for the active one). SPMD when the plan is bound to ranks of its
    own or a default group exists; else the one-process form."""
    if mesh is None:
        mesh = _active_mesh()
        if mesh is None:
            raise ValueError("ring_flash_attention needs a mesh (set_mesh/"
                             "fleet.init, or an active ShardingPlan)")
    sizes = _axis_sizes(mesh)
    if sp_axis not in sizes:
        raise ValueError(f"sequence axis {sp_axis!r} is not in the mesh "
                         f"{sizes}")
    n = int(sizes[sp_axis])
    if getattr(mesh, "bound", False) or dist.is_initialized():
        if n == 1:
            return _Ring(1, 0)
        pg = (mesh.axis_group(sp_axis) if hasattr(mesh, "axis_group")
              else mesh.group(sp_axis))
        return _Ring(n, C._grank(pg), pg)
    return _Ring(n, 0, None, local=True)


# -- point-to-point transport over the ring -----------------------------------


def _exchange(t: torch.Tensor, pg, forward: bool, tag: int):
    """Post the send of ``t`` to the next rank (``forward``; else the
    previous one) and the receive of the other neighbour's tensor of the
    same shape. Returns ``(received, tasks)``; ``received`` is whole once
    every task has been waited on."""
    n, r = C._size(pg), C._grank(pg)
    to, frm = ((r + 1) % n, (r - 1) % n) if forward else \
        ((r - 1) % n, (r + 1) % n)
    got = torch.empty_like(t)
    tasks = [C._send_to(t.contiguous(), to, pg, tag),
             C._recv_from(got, frm, pg, tag)]
    return got, tasks


def _wait(tasks) -> None:
    for task in tasks:
        task.wait()


class _Shift(torch.autograd.Function):
    """The plain ring's K/V rotation: rank ``r`` receives rank ``r - 1``'s
    tensor; the backward sends the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        got, tasks = _exchange(x, pg, True, 0)
        _wait(tasks)
        return got

    @staticmethod
    def backward(ctx, g):
        got, tasks = _exchange(g.contiguous(), ctx.pg, False, 0)
        _wait(tasks)
        return got, None


def _repeat(t: torch.Tensor, rep: int) -> torch.Tensor:
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


def _fold(t: torch.Tensor, rep: int) -> torch.Tensor:
    """The gradient of :func:`_repeat`: the repeated heads summed."""
    if rep == 1:
        return t
    b, s, h, d = t.shape
    return t.reshape(b, s, h // rep, rep, d).sum(3)


# -- the plain version 


def _ring_plain(q, k, v, ring: _Ring, causal: bool, scale: float):
    """The reference's per-shard loop (``_ring_body`` :55-92) in plain
    PyTorch, differentiable: ``q``/``k``/``v`` ``[b, s_loc, h, d]`` this
    shard's blocks; K/V travel by :class:`_Shift`."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    n, r = ring.n, ring.r
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for t in range(n):
        j = (r - t) % n
        m2, l2, a2 = _block_attn_update(q, _repeat(kb, rep),
                                        _repeat(vb, rep), m, l, acc, r * s,
                                        j * s, causal, scale)
        if causal and j > r:
            # a future block keeps the previous state; selected (as the
            # reference selects) rather than skipped, so every rank's
            # shifted blocks stay in the graph and its backward shifts run
            # in step with its neighbours'
            skip = torch.ones((), dtype=torch.bool, device=q.device)
            m2, l2, a2 = (torch.where(skip, m, m2), torch.where(skip, l, l2),
                          torch.where(skip, acc, a2))
        m, l, acc = m2, l2, a2
        if t < n - 1:
            kb, vb = _Shift.apply(kb, ring.pg), _Shift.apply(vb, ring.pg)
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


# -- the kernel path 


def _visible(causal: bool, j: int, r: int) -> Optional[bool]:
    """The flash call block ``j`` takes on rank ``r``: its ``causal`` flag,
    or None for no launch (a future block under ``causal``)."""
    if not causal:
        return False
    if j > r:
        return None
    return j == r


def _merge(o, lse, o_j, lse_j):
    """Two partial attentions over disjoint key sets merged by their
    ``lse`` (f32 ``[b, s, h, d]`` and ``[b*h, s]``)."""
    if o is None:
        return o_j.float(), lse_j
    b, s, h, _ = o_j.shape
    new = torch.logaddexp(lse, lse_j)

    def weight(x):
        return torch.exp(x - new).reshape(b, h, s).transpose(1, 2)[..., None]

    return o * weight(lse) + o_j.float() * weight(lse_j), new


class _RingFlash(torch.autograd.Function):
    """One shard's ring attention whose blocks are the flash kernels
    (module docstring); ``q``/``k``/``v`` are this shard's blocks."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        q = q.contiguous()
        rep = q.shape[2] // k.shape[2]
        n, r = ring.n, ring.r
        o = lse = None
        kv = torch.stack([k, v]).contiguous()
        for t in range(n):
            j = (r - t) % n
            tasks = []
            if t < n - 1:
                nxt, tasks = _exchange(kv, ring.pg, True, 0)
            c = _visible(causal, j, r)
            if c is not None:
                o_j, lse_j = flash_fwd(q, _repeat(kv[0], rep).contiguous(),
                                       _repeat(kv[1], rep).contiguous(), c,
                                       scale)
                o, lse = _merge(o, lse, o_j, lse_j)
            if tasks:
                _wait(tasks)
                kv = nxt
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        rep = q.shape[2] // k.shape[2]
        n, r = ring.n, ring.r
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v]).contiguous()
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=k.device)
        for t in range(n):
            j = (r - t) % n
            tasks = []
            if t < n - 1:
                nxt, tasks = _exchange(kv, ring.pg, True, 0)
            c = _visible(causal, j, r)
            if c is not None:
                kr = _repeat(kv[0], rep).contiguous()
                vr = _repeat(kv[1], rep).contiguous()
                dq += flash_bwd_dq(q, kr, vr, dout, lse, delta, c,
                                   scale).float()
                dk, dv = flash_bwd_dkv(q, kr, vr, dout, lse, delta, c, scale)
                dkv[0] += _fold(dk.float(), rep)
                dkv[1] += _fold(dv.float(), rep)
            # the accumulators follow their block: n shifts bring each home
            if n > 1:
                home, more = _exchange(dkv, ring.pg, True, 1)
                tasks += more
            _wait(tasks)
            if t < n - 1:
                kv = nxt
            if n > 1:
                dkv = home
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


# -- the public functions 


def _kernel_path(q) -> bool:
    """CUDA tensors take the kernels unless the JAX package's flash gate
    refuses the head dim (then neither package has a kernel for it)."""
    return q.device.type == "cuda" and not routes_to_plain(
        q.shape[-1], False, q.shape[1], q.shape[1])


def _whole(q, k, v, causal, scale, kernels):
    """The one-process form: attention over the whole sequences, K/V
    repeated to q's heads; through the flash kernels' autograd function
    when ``kernels`` (on CPU tensors their wrappers run the plain
    versions), else the plain version."""
    rep = q.shape[2] // k.shape[2]
    k, v = _repeat(k, rep), _repeat(v, rep)
    if kernels:
        return _FlashCore.apply(q, k, v, causal, scale)
    return flash_attention_plain(q, k, v, causal, scale)[0]


def ring_attention(q, k, v, mesh, sp_axis: str = "sp", causal: bool = True,
                   scale: float = None, data_axis: str = None):
    """Context-parallel attention over ``[b, s, h, d]`` arrays whose
    sequence dim is sharded over ``sp_axis`` (reference :95): each rank's
    local blocks in the SPMD form, the whole arrays in the one-process form
    (module docstring). K/V may carry fewer heads than q (GQA: ``h``
    divisible by theirs). ``data_axis`` names the batch's data axis as the
    reference's does; each rank holds its own rows already, so it changes
    no value. Returns the output in q's layout and dtype."""
    ring = ring_of(mesh, sp_axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not repeat over "
                         f"{k.shape[2]} key/value heads")
    if ring.local:
        if q.shape[1] % ring.n:
            raise ValueError(f"seq {q.shape[1]} not divisible by "
                             f"{sp_axis}={ring.n}")
        return _whole(q, k, v, causal, scale, _kernel_path(q))
    if _kernel_path(q):
        return _RingFlash.apply(q, k, v, ring, causal, scale)
    return _ring_plain(q, k, v, ring, causal, scale)


def ring_flash_attention(query, key, value, mesh=None, sp_axis="sp",
                         causal=True, data_axis=None):
    """The tensor-level op (reference :118): :func:`ring_attention` over
    ``mesh``, by default the active plan's or the global mesh (raises
    without one). Under AMP the inputs pass the cast hook as the
    reference's ``ring_flash_attention`` op."""
    if mesh is None and _active_mesh() is None:
        raise ValueError("ring_flash_attention needs a mesh (set_mesh/"
                         "fleet.init)")
    query, key, value = amp_cast("ring_flash_attention", query, key, value)
    return ring_attention(query, key, value, mesh, sp_axis=sp_axis,
                          causal=causal, data_axis=data_axis)
