"""The pipeline executor: pipeline parallelism over a ``pp`` mesh axis
(counterpart of ``paddlepaddle_tpu/parallel/pipeline_spmd.py``).

The reference runs every stage as one program inside ``shard_map``: one
``lax.scan`` over schedule slots, each stage taking its opcode under
``lax.switch`` and two ``ppermute`` rings moving the activations. The port
is SPMD per rank, the port's A10 design: every rank of the mesh runs
:func:`spmd_pipeline_train` with the reference's whole arguments, cuts its
own shards (its ``pp`` stage, and the ``tp`` / ``fsdp`` / ``ep`` blocks the
specs name), walks its own column of the schedule's ``[T, S]`` table and
moves activations and cotangents point to point over its ``pp`` group:

* a transfer is posted exactly where :func:`~.schedules._arrival_tables`
  says one arrives (the receiver at slot t, the sender at slot t-1, one
  tag per slot and direction), sends non-blocking, with no barrier per
  slot. A rank waits only for what arrives in its current slot, which its
  neighbour sent a slot earlier, so the walk cannot deadlock;
* ``F`` stashes its input and runs ``block_fn`` without autograd (not at
  the last virtual stage, whose output the reference only feeds into a
  ring slot nobody reads: its backward recomputes it); ``B`` / ``B_LAST``
  / ``BX`` / ``BW`` / ``BX_LAST`` / ``BW_LAST`` recompute the block from
  the stash under autograd (``torch.autograd.grad``, as the reference's
  ``jax.vjp``); ``BX`` takes the input gradient only, ``BW`` the weight
  gradient only; the loss cotangent is seeded with ``1/M``;
* the buffers are the schedule's (``stash_cap``, ``inbox_f_cap``,
  ``inbox_b_cap``, ``gstash_entries`` entries per chunk, addressed
  ``m % cap``), so :meth:`~.schedules.PipelineSchedule.memory_estimate`
  is what a rank allocates;
* the collectives inside ``block_fn`` (the hybrid's tp / fsdp / ep) run on
  groups within one stage coordinate, whose members walk the same column:
  they meet in the same order. They resolve their axis names through the
  plan the executor makes active (``use_mesh(plan)``).

After the walk, as the reference (:346-378): the loss, the head's
gradients and the input cotangents ``dacts`` are summed over ``pp``; over
the data axes a gradient whose spec names a data axis (it arrives
reduce-scattered by the block's gather) is divided by that axis's size and
averaged over the others, and ``dacts`` is divided by each data axis's
size. With ``seq_axis`` (context parallelism, :346-355) each rank holds
its block of the sequence (dim 1 of ``acts`` and ``labels``, after the
batch rows), and the stage and head gradients, partial sums over its
tokens, are summed over ``seq_axis`` first; the head's loss is already the
global mean on every block. Then every value is gathered whole: loss,
stage grads ``[S, ...]``
or ``[V, S, ...]``, head grads, ``dacts [B, ...]``. :func:`last_stats`
holds the last call's seconds (the walk, the sums, the gathers) and its
transfers.

Two forms, as :class:`~.sharded.ShardedTrainStep`: under a process group
spanning the mesh every rank calls the function (SPMD); in a process with
no group and a mesh of several ranks the caller is rank 0 and starts ranks
1..n-1 for the one call (:mod:`..distributed.worker_ranks`, ``block_fn``
and ``head_loss_fn`` shipped by value, :mod:`..distributed.ship`); rank 0
returns the whole values and the workers are gone when it returns.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .schedules import (OP_B, OP_B_LAST, OP_BW, OP_BW_LAST, OP_BX,
                        OP_BX_LAST, OP_F, OP_IDLE, PipelineSchedule,
                        _arrival_tables, build_schedule)

def _specs_like(tree, specs) -> list:
    """The placement tuple of each leaf of ``tree`` (in ``tree_flatten``'s
    order) from ``specs``, a tree of the same structure whose leaves are
    tuples (None: every leaf replicated)."""
    if specs is None:
        return [()] * len(pytree.tree_leaves(tree))
    if isinstance(tree, dict):
        if set(tree) != set(specs):
            raise ValueError(f"specs keys {sorted(specs)} do not match the "
                             f"params' {sorted(tree)}")
        return [x for k in tree for x in _specs_like(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, sp in zip(tree, specs, strict=True)
                for x in _specs_like(t, sp)]
    return [tuple(specs or ())]


def stack_stage_params(per_stage_params: Sequence[dict]) -> dict:
    """[S trees with same structure] -> one tree with leading stage dim
    (the ``pp`` axis cuts it)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs, dim=0),
                           *per_stage_params)


def stack_virtual_stage_params(per_stage_params: Sequence[dict],
                               n_devices: int) -> dict:
    """[V*S trees] -> tree with leading dims [V, S, ...] for the interleaved
    (VPP) schedule: global stage g = v*S + s lives on pp rank s as chunk v
    (the reference's virtual-pipeline layer assignment, pp_layers.py VPP)."""
    total = len(per_stage_params)
    if total % n_devices:
        raise ValueError(
            f"{total} stages not divisible by {n_devices} devices")
    v = total // n_devices
    return pytree.tree_map(lambda a: a.reshape((v, n_devices) + a.shape[1:]),
                           stack_stage_params(per_stage_params))


# this rank's place -----------------------------------------------------------


def _data_axes(data_axis) -> tuple:
    if data_axis is None:
        return ()
    return (data_axis,) if isinstance(data_axis, str) else tuple(data_axis)


def _spec_axes(spec) -> set:
    """Mesh-axis names a placement tuple mentions."""
    names = set()
    for e in spec or ():
        if e is None:
            continue
        names.update(e if isinstance(e, (tuple, list)) else (e,))
    return names


class _Place:
    """This rank of ``plan``: its coordinates, its groups, the sizes."""

    def __init__(self, plan, pp_axis: str, data_axes: tuple):
        if pp_axis not in plan.axes:
            raise ValueError(f"the mesh has no pipeline axis {pp_axis!r}: "
                             f"{plan.process_mesh!r}")
        import torch.distributed as dist

        if not plan.bound and dist.is_initialized():
            # collective: every rank makes every axis's groups, in order
            plan.process_mesh.init_groups()
        self.plan = plan
        self.sizes = dict(plan.axes)
        self.coords = plan.coords()
        self.S = self.sizes[pp_axis]
        self.s = self.coords[pp_axis]
        self.pp = plan.group(pp_axis) if self.S > 1 else None
        for a in data_axes:
            if a not in self.sizes:
                raise ValueError(f"data axis {a!r} is not in "
                                 f"{plan.process_mesh!r}")
        # the batch's data axes of size > 1, majorest first as given
        self.data = tuple(a for a in data_axes if self.sizes[a] > 1)

    def size(self, axes) -> int:
        return int(np.prod([self.sizes.get(a, 1) for a in axes]))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (first majorest)."""
        i = 0
        for a in axes:
            i = i * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return i

    def groups(self, axes) -> list:
        return [self.plan.group(a) for a in axes if self.sizes.get(a, 1) > 1]

    def cut(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``t`` under the placement tuple ``spec``."""
        for dim, entry in enumerate(spec or ()):
            if entry is None:
                continue
            axes = tuple(a for a in (entry if isinstance(entry, (tuple, list))
                                     else (entry,))
                         if self.sizes.get(a, 1) > 1)
            n = self.size(axes)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                                 f"split over {axes} ({n} ranks)")
            t = t.chunk(n, dim=dim)[self.index(axes)]
        return t.contiguous()

    def whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The inverse of :meth:`cut`: ``t`` gathered along its sharded
        dims (every rank ends with the whole)."""
        from ..distributed.collective import _all_gather

        for dim, entry in enumerate(spec or ()):
            if entry is None:
                continue
            axes = (entry if isinstance(entry, (tuple, list)) else (entry,))
            gs = self.groups(axes)
            if gs:
                t = _all_gather(t.contiguous(), gs, dim)
        return t


def _plan_for(mesh, data_axes):
    from ..distributed.shard_plan import ShardingPlan

    return ShardingPlan(mesh, rules=[], data_axes=data_axes)


# transfers -------------------------------------------------------------------


class _Wire:
    """Point-to-point moves over the ``pp`` group with their counts: the
    activations to the right neighbour, the cotangents to the left. With
    one stage a rank is its own neighbour: what it sends it keeps."""

    def __init__(self, place: _Place):
        self.pg = place.pp
        self.left = (place.s - 1) % place.S
        self.right = (place.s + 1) % place.S
        self.sends: list = []
        self.loop: Dict[int, torch.Tensor] = {}
        self.calls = 0
        self.bytes = 0
        self.post_s = 0.0
        self.wait_s = 0.0

    def send(self, t: torch.Tensor, up: bool, slot: int) -> None:
        tag = 2 * slot + (0 if up else 1)
        if self.pg is None:
            self.loop[tag] = t.detach().clone()
            return
        from ..distributed.collective import _send_to

        t0 = time.perf_counter()
        self.sends.append(_send_to(t, self.right if up else self.left,
                                   self.pg, tag))
        self.post_s += time.perf_counter() - t0
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def recv(self, into: torch.Tensor, up: bool, slot: int):
        """Post the receive of what a neighbour sent at ``slot``."""
        tag = 2 * slot + (0 if up else 1)
        if self.pg is None:
            into.copy_(self.loop.pop(tag))
            return None
        from ..distributed.collective import _recv_from

        t0 = time.perf_counter()
        task = _recv_from(into, self.left if up else self.right, self.pg,
                          tag)
        self.post_s += time.perf_counter() - t0
        self.calls += 1
        self.bytes += into.numel() * into.element_size()
        return task

    def wait(self, tasks) -> None:
        t0 = time.perf_counter()
        for task in tasks:
            if task is not None:
                task.wait()
        self.wait_s += time.perf_counter() - t0

    def drain(self) -> None:
        self.wait(self.sends)
        self.sends = []


# the training executor ---------------------------------------------------------

_LAST: Dict[str, object] = {}


def last_stats() -> Dict[str, object]:
    """This process's last :func:`spmd_pipeline_train` call: seconds of the
    schedule walk (``walk_s``), the sums over ``pp`` and the data axes
    (``reduce_s``; ``head_sum`` and ``dacts_sum`` apart, with their bytes)
    and the final gathers (``gather_s``), and its point-to-point transfers
    (``p2p``: calls, bytes, seconds posting and seconds waiting, the waits
    including a neighbour's compute). Each wall time is taken after a
    device sync."""
    return dict(_LAST)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _grad(root, inputs, seed):
    """``d root / d inputs`` against the cotangent ``seed``; an input the
    root does not reach gets zeros."""
    got = torch.autograd.grad(root, inputs, grad_outputs=seed,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, got)]


def _train_rank(plan, sched: PipelineSchedule, stacked_params, head_params,
                acts, labels, block_fn, head_loss_fn, pp_axis, data_axes,
                param_specs, head_specs, seq_axis=None):
    from ..distributed.collective import _all_gather, _all_reduce_, use_mesh

    place = _Place(plan, pp_axis, data_axes)
    n_sp = place.sizes[seq_axis] if seq_axis is not None else 1
    sp_pg = plan.group(seq_axis) if n_sp > 1 else None
    if n_sp > 1 and acts.shape[1] % n_sp:
        raise ValueError(f"sequence {acts.shape[1]} does not split over "
                         f"{seq_axis}={n_sp}")
    S, s = place.S, place.s
    if sched.S != S:
        raise ValueError(f"schedule built for S={sched.S}, mesh has {S}")
    M, V = sched.M, sched.V
    G = V * S
    B = acts.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    D = place.size(place.data)
    if mb % D:
        raise ValueError(f"microbatch {mb} does not split over the data "
                         f"axes {place.data} ({D} ranks)")
    dev, dtype = acts.device, acts.dtype

    st_leaves, st_struct = pytree.tree_flatten(stacked_params)
    hd_leaves, hd_struct = pytree.tree_flatten(head_params)
    st_specs = _specs_like(stacked_params, param_specs)
    hd_specs = _specs_like(head_params, head_specs)
    added_v = V == 1
    # this rank's leaves, chunk by chunk: [V, S, ...] -> [c][i] local block
    chunks = []
    for c in range(V):
        chunks.append([place.cut(a[s] if added_v else a[c, s], sp).detach()
                       .requires_grad_(True)
                       for a, sp in zip(st_leaves, st_specs)])
    heads = [place.cut(a, sp).detach().requires_grad_(True)
             for a, sp in zip(hd_leaves, hd_specs)]
    p_of = [pytree.tree_unflatten(ch, st_struct) for ch in chunks]
    hp = pytree.tree_unflatten(heads, hd_struct)

    rows = place.index(place.data)
    x_l = acts.reshape(M, mb, *acts.shape[1:]).chunk(D, dim=1)[rows]
    y_l = labels.reshape(M, mb, *labels.shape[1:]).chunk(D, dim=1)[rows]
    if sp_pg is not None:
        # this rank's block of the sequence (dim 2 of [M, mb, s, ...])
        cols = place.coords[seq_axis]
        x_l = x_l.chunk(n_sp, dim=2)[cols].contiguous()
        if y_l.dim() >= 3:
            y_l = y_l.chunk(n_sp, dim=2)[cols].contiguous()
    a_shape = tuple(x_l.shape[1:])
    Cs, Cf, Cb = sched.stash_cap, sched.inbox_f_cap, sched.inbox_b_cap
    Cg = sched.gstash_entries
    stash = torch.zeros((V, Cs) + a_shape, dtype=dtype, device=dev)
    gstash = torch.zeros((V, Cg) + a_shape, dtype=dtype, device=dev)
    inf = torch.zeros((V, Cf) + a_shape, dtype=dtype, device=dev)
    inb = torch.zeros((V, Cb) + a_shape, dtype=dtype, device=dev)
    dacts = torch.zeros((M,) + a_shape, dtype=dtype, device=dev)
    gacc = [[torch.zeros_like(p) for p in ch] for ch in chunks]
    hg = [torch.zeros_like(h) for h in heads]
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    seed = 1.0 / M

    fin_v, fin_m, fin_c, bin_v, bin_m, bin_c = _arrival_tables(sched)
    wire = _Wire(place)

    def add(acc, grads):
        for a, g in zip(acc, grads):
            a.add_(g)

    def vjp(c, m, a_in, want_a, want_p, want_h, g_in=None):
        """Recompute chunk ``c``'s block (and, with ``g_in`` None, the
        head's loss) from the stashed input; gradients of what is wanted."""
        with torch.enable_grad():
            a = a_in.detach().requires_grad_(want_a)
            out = block_fn(p_of[c], a)
            if g_in is None:
                root = head_loss_fn(hp, out, y_l[m])
                cot = torch.full_like(root, seed)
            else:
                root, cot = out, g_in.to(out.dtype)
            inputs = (([a] if want_a else []) + (chunks[c] if want_p else [])
                      + (heads if want_h else []))
            grads = _grad(root, inputs, cot)
        da = grads.pop(0).to(dtype) if want_a else None
        dp = [grads.pop(0) for _ in chunks[c]] if want_p else None
        dh = grads if want_h else None
        return root.detach(), da, dp, dh

    _sync(dev)
    t_walk = time.perf_counter()
    with use_mesh(plan):
        for t in range(sched.T):
            tasks = []
            if fin_v[t, s]:
                c_, m_ = int(fin_c[t, s]), int(fin_m[t, s])
                tasks.append(wire.recv(inf[c_, m_ % Cf], True, t - 1))
            if bin_v[t, s]:
                c_, m_ = int(bin_c[t, s]), int(bin_m[t, s])
                tasks.append(wire.recv(inb[c_, m_ % Cb], False, t - 1))
            wire.wait(tasks)
            op = int(sched.ops[t, s])
            if op == OP_IDLE:
                continue
            m, c = int(sched.mbs[t, s]), int(sched.chunks[t, s])
            g = c * S + s
            a_st = stash[c, m % Cs]
            da = None
            if op == OP_F:
                a_st.copy_(x_l[m] if g == 0 else inf[c, m % Cf])
                if g + 1 < G:
                    with torch.no_grad():
                        out = block_fn(p_of[c], a_st)
                    wire.send(out.to(dtype), True, t)
                continue
            if op == OP_B:
                _, da, dp, _ = vjp(c, m, a_st, True, True, False,
                                   inb[c, m % Cb])
                add(gacc[c], dp)
            elif op == OP_B_LAST:
                lm, da, dp, dh = vjp(c, m, a_st, True, True, True)
                add(gacc[c], dp)
                add(hg, dh)
                loss += lm.float()
            elif op == OP_BX:
                g_in = inb[c, m % Cb]
                _, da, _, _ = vjp(c, m, a_st, True, False, False, g_in)
                gstash[c, m % Cg].copy_(g_in)
            elif op == OP_BW:
                _, _, dp, _ = vjp(c, m, a_st, False, True, False,
                                  gstash[c, m % Cg])
                add(gacc[c], dp)
            elif op == OP_BX_LAST:
                lm, da, _, _ = vjp(c, m, a_st, True, False, False)
                loss += lm.float()
            elif op == OP_BW_LAST:
                _, _, dp, dh = vjp(c, m, a_st, False, True, True)
                add(gacc[c], dp)
                add(hg, dh)
            else:
                raise ValueError(f"slot {t} rank {s}: unknown opcode {op}")
            if da is not None:
                if g == 0:
                    dacts[m].add_(da)
                else:
                    wire.send(da, False, t)
        wire.drain()
        _sync(dev)
        t_red = time.perf_counter()

        # the sums over pp and the data-axis reductions (reference :346-378)
        pp = place.pp
        loss = _all_reduce_(loss, "sum", pp) / M
        hsum = _sum_over(hg, pp, dev)
        dsum = _sum_over([dacts], pp, dev)
        for a in place.data:
            loss = _all_reduce_(loss, "avg", plan.group(a))

        def reduce_grad(gr, spec):
            # the sequence blocks hold other tokens of the same rows
            _all_reduce_(gr, "sum", sp_pg)
            inside = [a for a in place.data if a in _spec_axes(spec)]
            for a in place.data:
                if a not in inside:
                    _all_reduce_(gr, "avg", plan.group(a))
            for a in inside:
                gr.div_(place.sizes[a])

        for c in range(V):
            for gr, sp in zip(gacc[c], st_specs):
                reduce_grad(gr, sp)
        for gr, sp in zip(hg, hd_specs):
            reduce_grad(gr, sp)
        for a in place.data:
            dacts.div_(place.sizes[a])
        _sync(dev)
        t_gather = time.perf_counter()

        # every value whole
        st_out = []
        for i, sp in enumerate(st_specs):
            per_chunk = torch.stack([place.whole(gacc[c][i], sp)
                                     for c in range(V)])      # [V, ...]
            full = (_all_gather(per_chunk.unsqueeze(1).contiguous(), pp, 1)
                    if pp is not None else per_chunk.unsqueeze(1))
            st_out.append(full[0] if added_v else full)
        hd_out = [place.whole(gr, sp) for gr, sp in zip(hg, hd_specs)]
        d_whole = (_all_gather(dacts, sp_pg, 2) if sp_pg is not None
                   else dacts)
        d_whole = _all_gather(d_whole, place.groups(place.data), 1) \
            if place.data else d_whole
        _sync(dev)
    t_end = time.perf_counter()
    _LAST.clear()
    _LAST.update(
        walk_s=t_red - t_walk, reduce_s=t_gather - t_red,
        gather_s=t_end - t_gather, head_sum=hsum, dacts_sum=dsum,
        p2p={"calls": wire.calls, "bytes": wire.bytes,
             "post_s": wire.post_s, "wait_s": wire.wait_s},
        rank_in_pp=s, stash_bytes=int(stash.numel() * stash.element_size()),
        buffer_bytes=int(sum(b.numel() * b.element_size()
                             for b in (stash, gstash, inf, inb, dacts))))
    return (loss, pytree.tree_unflatten(st_out, st_struct),
            pytree.tree_unflatten(hd_out, hd_struct),
            d_whole.reshape((B,) + tuple(acts.shape[1:])))


def _sum_over(ts, pg, dev) -> Dict[str, float]:
    """Sum each tensor of ``ts`` over ``pg`` in place: bytes and seconds
    (after a device sync)."""
    from ..distributed.collective import _all_reduce_

    _sync(dev)
    t0 = time.perf_counter()
    for t in ts:
        _all_reduce_(t, "sum", pg)
    _sync(dev)
    return {"bytes": int(sum(t.numel() * t.element_size() for t in ts))
            if pg is not None else 0,
            "s": time.perf_counter() - t0}


def spmd_pipeline_train(stacked_params, head_params, acts, labels,
                        block_fn: Callable, head_loss_fn: Callable, mesh,
                        schedule="1f1b", n_microbatches: Optional[int] = None,
                        num_virtual: int = 1, pp_axis: str = "pp",
                        data_axis=None, param_specs=None, head_specs=None,
                        seq_axis=None):
    """Schedule-driven pipeline training step: forward AND backward of all
    microbatches, each rank walking its column of the schedule (module
    docstring).

    Args:
        stacked_params: tree, leaves [S, ...] (num_virtual=1) or
            [V, S, ...] stage-stacked, whole (every rank gets the same).
        head_params: tree for the head/loss; may be empty.
        acts: [B, ...] activations entering virtual stage 0.
        labels: [B, ...] targets, consumed by ``head_loss_fn`` per
            microbatch.
        block_fn: (params_one_stage, acts_mb) -> acts_mb.
        head_loss_fn: (head_params, acts_mb, labels_mb) -> scalar mean loss.
        mesh: a :class:`~..distributed.mesh.ProcessMesh` (or a mesh spec
            string) with the ``pp_axis``.
        schedule: a PipelineSchedule, or a name ('1f1b' | 'gpipe' |
            'interleaved' | 'zbh1' | 'zbvpp'); names need
            ``n_microbatches`` (and ``num_virtual`` for V > 1).
        data_axis: mesh axis name (or tuple of names, majorest first) the
            batch's rows shard over.
        param_specs / head_specs: trees (matching the stage / head params)
            of placement tuples for the per-stage leaf dims: how each weight
            is sharded over tp / fsdp / ep inside a stage
            (:func:`~.hybrid.llama_stage_specs`); the block and head make
            the matching collectives.
        seq_axis: the mesh axis the sequence dim (dim 1 of ``acts`` and
            ``labels``) shards over: context parallelism inside the stages
            (the hybrid's ``sp_axis`` blocks and head).
    Returns:
        (loss, grads_stacked, grads_head, dacts), whole: the loss is the
        mean over the batch; the grads match their params' structure;
        dacts [B, ...] is the cotangent of ``acts``.
    """
    data_axes = _data_axes(data_axis)
    plan = _plan_for(mesh, data_axes)
    S = plan.axes.get(pp_axis)
    if S is None:
        raise ValueError(f"the mesh has no pipeline axis {pp_axis!r}")
    if seq_axis is not None:
        if seq_axis not in plan.axes:
            raise ValueError(f"seq_axis {seq_axis!r} is not in the mesh "
                             f"{plan.axes}")
        if acts.dim() < 3:
            raise ValueError(f"seq_axis={seq_axis!r} needs activations "
                             f"[B, seq, ...]; got rank {acts.dim()}")
    if isinstance(schedule, str):
        if n_microbatches is None:
            raise ValueError("n_microbatches required with a schedule name")
        schedule = build_schedule(schedule, S, int(n_microbatches),
                                  V=num_virtual)
    kw = dict(sched=schedule, block_fn=block_fn, head_loss_fn=head_loss_fn,
              pp_axis=pp_axis, data_axes=data_axes, param_specs=param_specs,
              head_specs=head_specs, seq_axis=seq_axis)
    trees = dict(stacked_params=stacked_params, head_params=head_params,
                 acts=acts, labels=labels)
    return _run(plan, "train", trees, kw)


# the forward-only pipelines ----------------------------------------------------


def _forward_rank(plan, stacked_params, acts, block_fn, n_microbatches,
                  pp_axis, data_axes):
    """GPipe forward on this rank: stage s runs microbatch m at step m+s,
    receiving from stage s-1 and sending to s+1; the last stage's outputs
    are summed over ``pp`` (so every stage has them) and gathered over the
    data axes."""
    from ..distributed.collective import _all_gather, _all_reduce_, use_mesh

    place = _Place(plan, pp_axis, data_axes)
    S, s = place.S, place.s
    M = int(n_microbatches)
    B = acts.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    D = place.size(place.data)
    leaves, struct = pytree.tree_flatten(stacked_params)
    p = pytree.tree_unflatten([a[s] for a in leaves], struct)
    x_l = acts.reshape(M, mb, *acts.shape[1:]).chunk(D, dim=1)[
        place.index(place.data)]
    outs = torch.zeros_like(x_l)
    wire = _Wire(place)
    with torch.no_grad(), use_mesh(plan):
        buf = torch.empty_like(x_l[0])
        for m in range(M):
            if s == 0:
                a = x_l[m]
            else:
                wire.wait([wire.recv(buf, True, m)])
                a = buf
            out = block_fn(p, a)
            if out.shape != a.shape:
                raise ValueError(
                    f"pipeline block must preserve activation shape, got "
                    f"{tuple(a.shape)} -> {tuple(out.shape)}")
            if s < S - 1:
                wire.send(out, True, m)
            else:
                outs[m].copy_(out)
        wire.drain()
        if s < S - 1:
            outs.zero_()
        _all_reduce_(outs, "sum", place.pp)
        if place.data:
            outs = _all_gather(outs, place.groups(place.data), 1)
    return outs.reshape((B,) + tuple(acts.shape[1:]))


def spmd_pipeline(stacked_params, acts, block_fn: Callable, mesh,
                  n_microbatches: int, pp_axis: str = "pp",
                  data_axis=None):
    """Run ``block_fn(stage_params, activations)`` through the S pipeline
    stages (a GPipe forward; no autograd through it: training is
    :func:`spmd_pipeline_train`).

    Args:
        stacked_params: tree, each leaf [S, ...] (stage-major), whole.
        acts: [B, ...] activations entering stage 0.
        block_fn: (params_one_stage, acts_mb) -> acts_mb.
        n_microbatches: M; B must divide by M.
        data_axis: optional mesh axis name the batch dim is sharded over.
    Returns [B, ...] activations leaving the last stage, on every rank.
    """
    data_axes = _data_axes(data_axis)
    kw = dict(block_fn=block_fn, n_microbatches=int(n_microbatches),
              pp_axis=pp_axis, data_axes=data_axes)
    trees = dict(stacked_params=stacked_params, acts=acts)
    return _run(_plan_for(mesh, data_axes), "forward", trees, kw)


def spmd_pipeline_interleaved(stacked_params, acts, block_fn: Callable,
                              mesh, n_microbatches: int, pp_axis: str = "pp",
                              data_axis=None):
    """Forward-only virtual-stage placement: VPP *stage assignment*
    semantics (global stage g = v*S + s on rank s as chunk v) with a
    GPipe pass per lap; the V laps run in turn, so this does NOT reproduce
    VPP's bubble reduction (that is ``spmd_pipeline_train(...,
    schedule="interleaved")``).

    stacked_params leaves: [V, S, ...] (see stack_virtual_stage_params).
    """
    for lap in range(pytree.tree_leaves(stacked_params)[0].shape[0]):
        acts = spmd_pipeline(pytree.tree_map(lambda a: a[lap],
                                             stacked_params),
                             acts, block_fn, mesh, n_microbatches,
                             pp_axis=pp_axis, data_axis=data_axis)
    return acts


# the two forms -------------------------------------------------------------------

_ENTRIES = {"train": _train_rank, "forward": _forward_rank}


def _run(plan, entry: str, trees: dict, kw: dict):
    """Run ``entry`` on this rank (SPMD), or, in a process with no group
    and a plan of several ranks, as rank 0 of ranks it starts for the one
    call."""
    if not plan.single_process:
        plan.require_group()
        return _ENTRIES[entry](plan, **trees, **kw)
    from ..distributed.ship import ship
    from ..distributed.worker_ranks import start_workers

    leaves, struct = pytree.tree_flatten(trees)
    for k in ("block_fn", "head_loss_fn"):
        if k in kw:
            kw[k] = ship(kw[k], k)
    held = [{str(i): t for i, t in enumerate(leaves)}
            for _ in range(1, plan.n_devices)]
    device = trees["acts"].device
    bound, ranks = start_workers(
        plan, held, _build_rank,
        {"entry": entry, "struct": pytree.treespec_dumps(struct), "kw": kw},
        device, what="pipeline rank")
    try:
        out = _ENTRIES[entry](bound, **trees, **kw)
    except BaseException as e:
        ranks.close(timeout_s=5.0)
        lost = [(r, p.exitcode) for r, p in enumerate(ranks.procs, start=1)
                if p.exitcode not in (None, 0)]
        if lost:
            raise RuntimeError(f"pipeline rank {lost[0][0]} exited with code "
                               f"{lost[0][1]}") from e
        raise
    ranks.close()                    # the workers exit once their part ends
    bad = [(r, p.exitcode) for r, p in enumerate(ranks.procs, start=1)
           if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"pipeline rank {bad[0][0]} ended with code "
                           f"{bad[0][1]}")
    return out


class _RankCall:
    """A worker rank's part of one pipeline call: :meth:`follow` runs it
    (the worker exits when it returns)."""

    def __init__(self, plan, entry, trees, kw):
        self.plan, self.entry, self.trees, self.kw = plan, entry, trees, kw

    def follow(self) -> int:
        _ENTRIES[self.entry](self.plan, **self.trees, **self.kw)
        return 1


def _build_rank(held, plan, device, entry, struct, kw):
    leaves = [held[str(i)] for i in range(len(held))]
    return _RankCall(plan, entry, pytree.tree_unflatten(
        leaves, pytree.treespec_loads(struct)), kw)
