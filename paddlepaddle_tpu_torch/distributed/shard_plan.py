"""Sharding plans: named mesh axes and per-layer partition rules
(counterpart of ``paddlepaddle_tpu/distributed/shard_plan.py`` :51-391).

The reference is single-controller: one process places a pytree on a
device mesh with ``NamedSharding`` and XLA inserts the collectives. The
port is SPMD: every rank of a ``torch.distributed`` job builds the same
plan and makes the calls the reference makes in its one process; each
rank holds its own shard, and the collectives are explicit.

* ``parse_mesh_spec`` / ``mesh_from_spec``: ``"dp2mp4"`` -> a
  :class:`~.mesh.ProcessMesh` over ranks (axis order = string order);
* the rule tables verbatim (:func:`tp_decode_rules`,
  :func:`dp_tp_train_rules` = ``models.llama.llama_sharding_rules``) and
  first-match resolution, axes the mesh lacks or that do not divide a dim
  fitting away (``parallel.sharded._fit_spec``);
* ``plan.shard(model or state)``: THIS RANK's shard of each parameter, the
  fitted spec recorded in ``plan.specs``. A state dict gives a dict of
  local tensors (a ``QuantizedWeight``'s ``q`` and scales shard together,
  reference :238-256). A module gives a view of it (the model is left as
  it was) whose sharded matrices are Megatron column- or row-parallel
  (:mod:`..parallel.mpu`): a column-parallel projection's input passes
  ``c_identity`` (all-reduce in backward); a row-parallel projection's
  output is all-reduced (``mp_allreduce``), exactly where the reference's
  specs make XLA insert one (after ``o_proj`` and ``down_proj``); the
  vocab-sharded LM head is gathered (``c_concat``) before sampling or the
  loss; a hidden-sharded embedding is gathered after the lookup. The
  collectives run whenever the mesh has the model axis, at size 1 too;
* an axis's role comes from the plan, not from its name (the reference
  decides by the rules and ``data_axes`` alike): the DATA axes are the
  members of ``data_axes`` the mesh has at a size above 1 (the batch
  shards over them, majorest first, and :attr:`ShardingPlan.data_group`
  spans their product); the MODEL (Megatron) axis is ``model_axis`` when
  the rules name it, else the one axis the rules name that is neither a
  data axis, ``ep``, nor a parameter-sharding name (``fsdp``,
  ``sharding``), so ``tp`` and ``mp`` both work; ``ep`` is expert
  parallelism (:func:`moe_train_rules` puts the MoE banks on it; the
  ranks of one ``ep`` group hold the same tokens, :mod:`..parallel.moe`);
  any other axis a parameter is sharded over is a PARAMETER-SHARDING
  (ZeRO-3) axis, ``fsdp`` the usual one: the parameter is gathered over it
  where its module uses it (:mod:`..parallel.mpu`). Axes of size 1 drop
  out everywhere. A ``pp`` axis is a pipeline axis, as in the reference:
  no rule names it, so every parameter is replicated over it, and it is no
  data axis (:mod:`..parallel.pipeline_spmd` runs the stages over it; a
  serving plan refuses it). An ``sp`` axis is the sequence (context
  parallel) axis, as in the reference: no rule names it, every parameter
  is replicated over it and it is no data axis; a context-parallel
  ``ShardedTrainStep(seq_axis="sp")`` shards the batch's columns over it
  and ring attention runs over its group (``axis_group("sp")``, as the
  pipeline runs over ``pp``'s; a serving plan refuses it). ``ep`` beside a parameter-sharding axis
  composes: the trunk is gathered over ``fsdp`` and its gradient
  reduce-scattered over the data axes, the banks live on ``ep`` alone and
  their gradients are summed over the data group (:mod:`..parallel.moe`
  names each collective's group);
* ``compile`` / ``compile_path``: the port has ONE path, per-rank eager or
  CUDA-graph-captured code with explicit collectives (``"spmd"``), where
  the reference chooses pjit or shard_map (ROADMAP, recorded deviations).
  ``compile`` returns the function itself; ``constrain`` is the identity
  on local shards.

A plan is built and its rules resolved without any process group (the CPU
tests resolve rules against the JAX plan). What needs ranks (``shard``,
the collectives) needs this rank, the plan's size, its backend, one
process group per mesh axis (the slice through the rank) and a CPU gloo
control group. Under the launcher (or ``spawn``) they come from the job's
default group, which must span exactly the mesh. A single-process decode
engine or train step (the reference's one-controller form) builds its own
:class:`RankContext`: :meth:`RankContext.from_store` makes the groups over
a store it owns, registered nowhere, and :meth:`ShardingPlan.bind` gives it
a copy of the plan over them (:mod:`.worker_ranks` starts the other
ranks). With more than one rank, no default group and no bound context,
:meth:`ShardingPlan.require_group` raises.
"""

from __future__ import annotations

import copy
import datetime
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.errors import not_ported
from .mesh import ProcessMesh

_SPEC_TOKEN = re.compile(r"([a-z_]+?)(\d+)")

# the names a parameter-sharding (ZeRO-3) axis usually goes by: never taken
# for the model axis
_ZERO_NAMES = ("fsdp", "sharding")
_CONTROL_TIMEOUT = datetime.timedelta(days=1)

LAUNCH_HINT = ("launch one process per rank: python -m "
               "paddlepaddle_tpu_torch.distributed.launch --nproc_per_node N "
               "script.py, then init_parallel_env() in the script")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"dp2mp4"`` (optionally ``"dp2xmp4"``) -> ``{"dp": 2, "mp": 4}``.

    Axis order in the string IS the mesh axis order (majorest first: put
    ``mp`` last so tensor-parallel peers are neighbouring ranks)."""
    # 'x' separates a size from the next axis name only ("dp2xmp4"); a
    # typo like "dp2x4" must not parse as another mesh
    s = re.sub(r"(?<=\d)x(?=[a-z])", "", spec.strip().lower())
    out: Dict[str, int] = {}
    pos = 0
    for m in _SPEC_TOKEN.finditer(s):
        if m.start() != pos:
            break
        name, size = m.group(1), int(m.group(2))
        if name == "x":
            raise ValueError(
                f"mesh spec {spec!r}: 'x' is the axis separator, not an "
                "axis name — did you drop an axis name after it?")
        if name in out:
            raise ValueError(f"mesh spec {spec!r}: duplicate axis {name!r}")
        if size < 1:
            raise ValueError(f"mesh spec {spec!r}: axis {name!r} size must "
                             f"be >= 1, got {size}")
        out[name] = size
        pos = m.end()
    if not out or pos != len(s):
        raise ValueError(
            f"mesh spec {spec!r} is not of the form '<axis><n>…' "
            "(e.g. 'dp2mp4', 'dp2ep4', 'mp2')")
    return out


def mesh_from_spec(spec) -> ProcessMesh:
    """A ProcessMesh from a ``"dp2mp4"`` string (a ProcessMesh passes
    through). In a job with a process group the mesh must cover exactly its
    ranks (one device each); without one the mesh is only described, and
    using it across ranks raises."""
    if isinstance(spec, ProcessMesh):
        return spec
    axes = parse_mesh_spec(spec)
    n = int(np.prod(list(axes.values())))
    if dist.is_initialized() and n != dist.get_world_size():
        raise ValueError(
            f"mesh {spec!r} needs {n} ranks (one device each), the job has "
            f"{dist.get_world_size()} devices")
    return ProcessMesh(shape=list(axes.values()),
                       dim_names=list(axes.keys()))


# -- rule tables -------------------------------------------------------------

def tp_decode_rules(mp_axis: str = "mp") -> List[Tuple[str, tuple]]:
    """Serving (tensor-parallel decode) placement table for llama-family
    names: attention q/k/v and MLP gate/up column-parallel on ``mp``, o/down
    row-parallel, lm_head vocab-sharded, embeddings and norms explicitly
    replicated."""
    return [
        (r".*embed_tokens\.weight$", ()),               # replicated: policy
        (r".*(q|k|v)_proj\.weight$", (None, mp_axis)),  # column (heads)
        (r".*o_proj\.weight$", (mp_axis, None)),        # row (heads in)
        (r".*(gate|up)_proj\.weight$", (None, mp_axis)),
        (r".*down_proj\.weight$", (mp_axis, None)),
        (r".*lm_head\.weight$", (None, mp_axis)),       # vocab-sharded logits
        (r".*(input_layernorm|post_attention_layernorm|\.norm)\.weight$",
         ()),                                           # norms: replicated
        (r".*", ()),
    ]


def dp_tp_train_rules(mp_axis: str = "mp",
                      fsdp_axis: Optional[str] = None):
    """Training placement: the llama 2D table with ``tp`` spelled
    ``mp_axis``; with no ``fsdp`` axis in the mesh those entries fit away
    and the plan is plain DP x TP."""
    from ..models.llama import llama_sharding_rules

    return llama_sharding_rules(tp_axis=mp_axis,
                                fsdp_axis=fsdp_axis or "fsdp")


def moe_train_rules(ep_axis: str = "ep", mp_axis: str = "mp"):
    """MoE placement (reference :139-144): expert banks sharded on
    ``ep_axis`` (expert parallelism), the dense trunk as Llama on
    ``mp_axis``."""
    from ..parallel.moe import moe_sharding_rules

    return moe_sharding_rules(ep_axis=ep_axis, tp_axis=mp_axis)


def _is_quantized_weight(v) -> bool:
    return (hasattr(v, "q") and hasattr(v, "scale")
            and hasattr(v, "group_size") and hasattr(v, "out_dtype"))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _rule_axes(rules) -> List[str]:
    """The mesh axes the rules name, in order of first appearance."""
    out: List[str] = []
    for _, spec in rules:
        for entry in spec:
            out.extend(a for a in _axes_of(entry) if a not in out)
    return out


def _resolve_model_axis(rules, model_axis: str, data_axes) -> str:
    """``model_axis`` when the rules name it; else the one axis they name
    that is no data axis, not ``ep`` and no parameter-sharding name (the
    Llama table's ``tp``); else ``model_axis`` (absent: no model axis)."""
    named = _rule_axes(rules)
    if model_axis in named:
        return model_axis
    left = [a for a in named if a not in data_axes and a != "ep"
            and a not in _ZERO_NAMES]
    if len(left) > 1:
        raise ValueError(
            f"the rules name {left} besides the data axes: which is the "
            f"tensor-parallel axis? Pass model_axis= (or mp_axis=)")
    return left[0] if left else model_axis


class RankContext:
    """The ranks a bound plan runs on, as one process sees them: ``rank``
    (in the mesh), ``size``, ``backend``, ``groups`` (mesh axis -> the
    process group of this rank's slice along it) and ``control`` (a CPU
    gloo group over every rank, for host-side control messages). Every
    collective on the decode engine's path asks a group object for its
    rank and size, so groups that nobody registered with
    ``torch.distributed`` work as well as the default group's."""

    def __init__(self, rank: int, size: int, backend: str,
                 groups: Dict[str, object], control):
        self.rank = int(rank)
        self.size = int(size)
        self.backend = backend
        self.groups = dict(groups)
        self.control = control

    @classmethod
    def from_store(cls, mesh: ProcessMesh, store, rank: int, backend: str,
                   timeout_s: float, products=()) -> "RankContext":
        """Groups of rank ``rank`` over ``store`` (the caller's own
        ``TCPStore``), one ``PrefixStore`` each: every axis slice through
        the rank, in the mesh's axis order, the slice of each tuple of
        axes in ``products`` (a plan's data group over several axes:
        :meth:`ShardingPlan.product_axes`), then the control group. Each
        constructor returns once every member of its group has connected,
        so every rank builds its groups in the same order. ``backend`` is
        ``"gloo"`` or ``"nccl"`` (the caller has set this rank's card); a
        backend that fails to initialise raises."""
        td = datetime.timedelta(seconds=float(timeout_s))

        def make(tag, ranks, kind, timeout):
            me, n = ranks.index(rank), len(ranks)
            sub = dist.PrefixStore(f"{tag}/" + "-".join(map(str, ranks)),
                                   store)
            if kind == "gloo":
                return dist.ProcessGroupGloo(sub, me, n, timeout)
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            return dist.ProcessGroupNCCL(sub, me, n, opts)

        groups = {name: make(f"axis/{name}", mesh.slice_ranks(name, rank),
                             backend, td)
                  for name in mesh.dim_names}
        for axes in products:
            groups[tuple(axes)] = make("axes/" + "+".join(axes),
                                       mesh.slice_ranks(axes, rank), backend,
                                       td)
        control = make("control", mesh.process_ids, "gloo",
                       _CONTROL_TIMEOUT)
        return cls(rank, len(mesh.process_ids), backend, groups, control)


class ShardingPlan:
    """Named mesh + per-layer partition rules (reference :154).

    Args:
        mesh: ``"dp2mp4"`` spec string or a ProcessMesh.
        rules: ``[(name_regex, spec_tuple)]``; default
            :func:`tp_decode_rules` over ``model_axis``.
        data_axes: mesh axes the batch dim shards over; those the mesh has
            at a size above 1 are kept, in the mesh's order.
        model_axis: the tensor-parallel axis (``tp_degree`` is its size)
            when the rules name it; otherwise the rules decide (module
            docstring), so the Llama table's ``tp`` works as it is.
        path: accepted for the reference's signature and recorded; the
            port has one execution path (``compile_path == "spmd"``).
    """

    def __init__(self, mesh, rules=None, data_axes: Sequence[str] = ("dp",),
                 model_axis: str = "mp", path: str = "auto"):
        if path not in ("auto", "pjit", "shard_map"):
            raise ValueError(
                f"path must be 'auto'|'pjit'|'shard_map', got {path!r}")
        self.process_mesh = mesh_from_spec(mesh)
        shape = dict(zip(self.process_mesh.dim_names,
                         self.process_mesh.shape))
        self._shape = shape
        self.rules = list(rules) if rules is not None \
            else tp_decode_rules(model_axis)
        self.model_axis = _resolve_model_axis(self.rules, model_axis,
                                              tuple(data_axes))
        self.data_axes = tuple(a for a in shape
                               if a in tuple(data_axes) and shape[a] > 1)
        self._path = path
        self.specs: Dict[str, tuple] = {}
        self._control = None
        self._ctx: Optional[RankContext] = None

    # -- mesh facts ----------------------------------------------------------
    @property
    def mesh(self) -> ProcessMesh:
        return self.process_mesh

    @property
    def axes(self) -> Dict[str, int]:
        return dict(self._shape)

    @property
    def n_devices(self) -> int:
        return int(np.prod(list(self._shape.values()))) if self._shape else 1

    @property
    def tp_degree(self) -> int:
        return int(self._shape.get(self.model_axis, 1))

    @property
    def dp_degree(self) -> int:
        """The size of the data group (the product of the data axes)."""
        d = 1
        for a in self.data_axes:
            d *= int(self._shape[a])
        return d

    def is_zero_axis(self, axis: str) -> bool:
        """Whether a parameter sharded over ``axis`` is sharded for memory
        (ZeRO-3: gathered where it is used): an axis of the mesh of size >
        1 that is neither the model axis, ``ep``, the pipeline axis ``pp``
        nor the sequence axis ``sp`` (every parameter is replicated over
        ``sp``, whose ranks hold other tokens of the same rows)."""
        return (self._shape.get(axis, 1) > 1 and axis != self.model_axis
                and axis not in ("ep", "pp", "sp"))

    def zero_dims(self, spec) -> tuple:
        """``((dim, axes), ...)``: the parameter-sharding axes of each dim
        of a fitted ``spec`` (majorest first), which a module gathers the
        parameter over where it uses it. Within a dim they must follow
        the model or ``ep`` axes, so that what is left after the gather is
        the block the Megatron wiring expects."""
        out = []
        for dim, entry in enumerate(spec):
            axes = _axes_of(entry)
            zero = tuple(a for a in axes if self.is_zero_axis(a))
            if not zero:
                continue
            if axes[len(axes) - len(zero):] != zero:
                raise not_ported(f"dim {dim} sharded over {axes}: a "
                                 f"parameter-sharding axis ahead of the "
                                 f"model axis", "A10")
            out.append((dim, zero))
        return tuple(out)

    def __repr__(self):
        axes = "x".join(f"{a}{s}" for a, s in self._shape.items())
        return f"ShardingPlan({axes}, path={self.compile_path!r})"

    def __enter__(self):
        from .collective import use_mesh

        self._use = use_mesh(self)
        self._use.__enter__()
        return self

    def __exit__(self, *exc):
        return self._use.__exit__(*exc)

    # -- ranks and groups ----------------------------------------------------
    def bind(self, ctx: RankContext) -> "ShardingPlan":
        """A copy of this plan over ``ctx``: what a single-process engine
        and each of its worker ranks run under. The plan given by the
        caller is left unbound, so one plan can build several engines."""
        if ctx.size != self.n_devices:
            raise ValueError(f"{self!r} spans {self.n_devices} ranks, the "
                             f"context {ctx.size}")
        out = copy.copy(self)
        out.specs = dict(self.specs)
        out._control = None
        out._ctx = ctx
        return out

    @property
    def bound(self) -> bool:
        """True for a plan over a context of its own (:meth:`bind`)."""
        return self._ctx is not None

    @property
    def single_process(self) -> bool:
        """True when this process must start the plan's other ranks itself
        (the reference's one-controller form): more than one rank, no
        default process group and no bound context."""
        return (self._ctx is None and self.n_devices > 1
                and not dist.is_initialized())

    def refuse_in_serving(self) -> None:
        """Raise ``not_ported`` if this plan has an ``ep``, ``pp`` or ``sp``
        axis of size > 1 (expert-, pipeline- and sequence-parallel serving
        are later A10 items: training only) or a parameter-sharding axis of
        size > 1 (the rules shard a parameter over it, or it is named
        ``fsdp`` / ``sharding``)."""
        if self._shape.get("ep", 1) > 1:
            raise not_ported("an expert-parallel (ep) axis in a serving "
                             "plan", "A10: expert-parallel serving")
        if self._shape.get("pp", 1) > 1:
            raise not_ported("a pipeline (pp) axis in a serving plan",
                             "A10: pipeline-parallel serving")
        if self._shape.get("sp", 1) > 1:
            raise not_ported("a sequence-parallel (sp) axis in a serving "
                             "plan", "A10: sequence-parallel serving")
        zero = [a for a in self._shape if self.is_zero_axis(a)
                and (a in _ZERO_NAMES or a in _rule_axes(self.rules))]
        if zero:
            raise not_ported(f"a parameter-sharding axis ({zero[0]}) in a "
                             "serving plan", "A10: fsdp in serving plans")

    def require_group(self) -> None:
        """Raise unless this process can act as one rank of the plan: a
        bound context, a default group of exactly ``n_devices`` ranks, or
        one rank without a group. The decode engine and
        ``ShardedTrainStep`` bind a plan of several ranks in a process with
        no group themselves; anything else raises here."""
        if self._ctx is not None:
            return
        if dist.is_initialized():
            if dist.get_world_size() != self.n_devices:
                raise ValueError(
                    f"{self!r} spans {self.n_devices} ranks, the job has "
                    f"{dist.get_world_size()}")
            return
        if self.n_devices > 1:
            raise RuntimeError(
                f"a {self.n_devices}-rank plan in a process with no "
                f"initialized process group: build the decode engine or "
                f"ShardedTrainStep over it (each starts its ranks), or "
                f"{LAUNCH_HINT}")

    @property
    def rank(self) -> int:
        if self._ctx is not None:
            return self._ctx.rank
        self.require_group()
        return dist.get_rank() if dist.is_initialized() else 0

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        return self.process_mesh.coords(self.rank if rank is None else rank)

    def group(self, axis):
        """This rank's process group along ``axis`` (a mesh axis, or a
        tuple of them: their product; None in a one-rank process without a
        group)."""
        if self._ctx is not None:
            return self._ctx.groups[axis]
        self.require_group()
        if not dist.is_initialized():
            return None
        return self.process_mesh.group(axis)

    def axis_group(self, axis: str):
        """The group the ``f_*`` collectives run over along ``axis`` while
        this plan is the active mesh (``use_mesh(plan)``): this rank's
        slice, or None for an axis of size 1 (a collective over one rank
        is the identity)."""
        if axis not in self._shape:
            raise ValueError(f"axis {axis!r} is not in {self!r}")
        return self.group(axis) if self._shape[axis] > 1 else None

    @property
    def mp_group(self):
        return (self.group(self.model_axis)
                if self.model_axis in self._shape else None)

    def product_axes(self) -> List[Tuple[str, ...]]:
        """The tuples of axes that need a group of their own: the data
        axes, when there are several."""
        return [self.data_axes] if len(self.data_axes) > 1 else []

    @property
    def data_group(self):
        """One group over the product of the data axes (the reference's dp
        x sharding product group): the batch's rows, the token count and
        the gradients of replicated parameters are summed over it. None
        without a data axis."""
        if not self.data_axes:
            return None
        return self.group(self.data_axes if len(self.data_axes) > 1
                          else self.data_axes[0])

    @property
    def ep_group(self):
        """The expert-parallel group (None without an ``ep`` axis)."""
        return self.group("ep") if "ep" in self._shape else None

    def zero_groups(self) -> Dict[str, tuple]:
        """``{axis: (group, is a data axis)}`` for each parameter-sharding
        axis of the mesh: what a parameter's gather-on-use runs over, and
        whether its backward sums the ranks' gradients (a data axis: each
        rank's is a partial sum) or takes this rank's slice (the ranks
        along it hold the same batch and compute equal gradients)."""
        return {a: (self.group(a), a in self.data_axes)
                for a in self._shape if self.is_zero_axis(a)}

    def backend(self) -> Optional[str]:
        if self._ctx is not None:
            return self._ctx.backend
        return dist.get_backend() if dist.is_initialized() else None

    def capturable(self) -> bool:
        """Whether code running this plan's collectives can be captured in
        a CUDA graph: NCCL (world size 1 included) can be, gloo cannot."""
        return self.backend() == "nccl"

    def control_group(self):
        """A CPU gloo group over every rank for host-side control messages
        (the decode engine's admissions). Its timeout is a fixed day: a
        follower waits on it while the driver sits idle between requests,
        and the timeout is not what catches a fault there, since a dead
        rank fails the group at once (its sockets close). Under the
        default group it is collective on first call; a bound context
        holds its own."""
        if self._ctx is not None:
            return self._ctx.control
        if self._control is None and dist.is_initialized():
            self._control = dist.new_group(backend="gloo",
                                           timeout=_CONTROL_TIMEOUT)
        return self._control

    # -- spec resolution -----------------------------------------------------
    def spec_for(self, name: str, shape) -> tuple:
        """First matching rule, fitted to the mesh and ``shape``."""
        from ..parallel.sharded import match_sharding_rules

        return match_sharding_rules(name, tuple(shape), self.rules,
                                    self._shape)

    def raw_spec_for(self, name: str) -> tuple:
        for pattern, spec in self.rules:
            if re.match(pattern, name):
                return tuple(spec)
        return ()

    def uses_model_axis(self) -> bool:
        for _, spec in self.rules:
            for entry in spec:
                if self.model_axis in _axes_of(entry):
                    return self.model_axis in self._shape
        return False

    def role_for(self, name: str, shape, own=None) -> Optional[str]:
        """Megatron role of a 2-D ``[in, out]`` matmul weight:
        ``"column"`` (out dim on the model axis), ``"row"`` (in dim) or
        None (replicated). The parameter's own placement ``own`` (a
        ``dist_spec``, as ``parallelize``'s plans set) wins over the rules,
        as it does for the weight's shard. At model-axis size 1 the raw
        placement decides, so the collectives still run over the one-rank
        group."""
        from ..parallel.sharded import _fit_spec

        if self.model_axis not in self._shape or len(shape) != 2:
            return None
        if own is not None:
            spec = (_fit_spec(own, tuple(shape), self._shape)
                    if self.tp_degree > 1 else tuple(own))
        else:
            spec = (self.spec_for(name, shape) if self.tp_degree > 1
                    else self.raw_spec_for(name))
        spec = tuple(spec) + (None,) * (2 - len(spec))
        if self.model_axis in _axes_of(spec[1]):
            return "column"
        if self.model_axis in _axes_of(spec[0]):
            return "row"
        return None

    # -- local shards ----------------------------------------------------------
    def local(self, t: torch.Tensor, spec, rank: Optional[int] = None
              ) -> torch.Tensor:
        """Rank ``rank``'s (default: this rank's) block of the full tensor
        ``t`` under a fitted ``spec``: along each sharded dim the block at
        the rank's mesh coordinate (row-major over a tuple of axes)."""
        coords = self.coords(rank)
        out = t
        for dim, entry in enumerate(spec):
            axes = _axes_of(entry)
            if not axes:
                continue
            n, idx = 1, 0
            for a in axes:
                idx = idx * self._shape[a] + coords[a]
                n *= self._shape[a]
            out = out.chunk(n, dim=dim)[idx]
        return out

    def _shard_quantized(self, name: str, w, rank=None):
        """The int8 ``q`` takes the rule for its ``[in, out]`` layout; the
        scales ride with it (per-channel ``[out]`` on q's out-dim axes,
        group-wise ``[in // g, out]`` on both)."""
        from ..parallel.sharded import _fit_spec

        qspec = self.spec_for(name, w.q.shape)
        ent = list(qspec) + [None] * (2 - len(qspec))
        if w.group_size == -1:
            sspec = _fit_spec((ent[1],), w.scale.shape, self._shape)
        else:
            sspec = _fit_spec((ent[0], ent[1]), w.scale.shape, self._shape)
        self.specs[name] = qspec
        return type(w)(self.local(w.q, qspec, rank).contiguous(),
                       self.local(w.scale, sspec, rank).contiguous(),
                       group_size=w.group_size, out_dtype=w.out_dtype)

    def shard(self, params, rank: Optional[int] = None):
        """This rank's shard of a flat ``{name: tensor or QuantizedWeight}``
        state (a dict back), or a sharded view of a module (see the module
        docstring). ``rank`` names another rank's shard (state dicts
        only)."""
        if isinstance(params, torch.nn.Module):
            if rank is not None:
                raise ValueError("shard(module) builds this rank's view")
            return self.shard_module(params, share=True)
        out = {}
        for name, v in params.items():
            if _is_quantized_weight(v):
                out[name] = self._shard_quantized(name, v, rank)
            else:
                spec = self.spec_for(name, tuple(v.shape))
                self.specs[name] = spec
                out[name] = self.local(v, spec, rank).contiguous() \
                    if spec else v
        return out

    def shard_module(self, model: torch.nn.Module, share: bool = True
                     ) -> torch.nn.Module:
        """A view of ``model`` holding this rank's shards, its sharded
        projections wired column- or row-parallel (:mod:`..parallel.mpu`).
        ``share``: replicated tensors are the model's own (serving); with
        False every parameter is a copy (training, whose step owns its
        parameters)."""
        from ..parallel import mpu

        self.require_group()
        self._check_tied(model)
        mp = self.mp_group
        return mpu.parallel_view(model, self, mp, share=share)

    def cut_module(self, model: torch.nn.Module, rank: int,
                   share: bool = True) -> torch.nn.Module:
        """Rank ``rank``'s view of ``model`` with no collective attached
        (:func:`..parallel.mpu.cut_view`; with ``share`` replicated tensors
        are the model's own, else copies): what a single-process engine or
        train step hands each worker rank, which wires it to its groups
        (:meth:`wire_module`)."""
        from ..parallel import mpu

        self._check_tied(model)
        return mpu.cut_view(model, self, share=share, rank=rank)

    def wire_module(self, view: torch.nn.Module) -> torch.nn.Module:
        """Attach this rank's collectives (model axis, the gathers of
        parameters sharded over a parameter-sharding axis, and an MoE
        layer's data and expert-parallel groups) to a view that
        :meth:`cut_module` cut for this rank."""
        from ..parallel import mpu

        return mpu.wire_view(view, self.mp_group, dp=self.data_group,
                             ep=self.ep_group, zero=self.zero_groups())

    def _check_tied(self, model) -> None:
        cfg = getattr(model, "config", None)
        if (getattr(cfg, "tie_word_embeddings", False)
                and self.tp_degree > 1):
            raise not_ported("tied word embeddings under a tensor-parallel "
                             "plan", "A10")

    def shard_batch(self, arr, rank: Optional[int] = None):
        """This rank's rows of a global batch: dim 0 over the data axes,
        majorest first (the whole batch when they do not divide it, as
        ``_fit_spec`` fits the axes away)."""
        from ..parallel.sharded import _fit_spec

        spec = self.data_axes if len(self.data_axes) > 1 else (
            self.data_axes[0] if self.data_axes else None)
        fitted = _fit_spec((spec,), tuple(arr.shape), self._shape)
        return self.local(arr, fitted, rank) if fitted else arr

    def kv_spec(self, shape, heads_axis: int = 2) -> tuple:
        """KV pool placement: kv heads over the model axis (axis 2 of the
        paged ``[pages, ps, kvh, hd]`` and contiguous layouts)."""
        from ..parallel.sharded import _fit_spec

        spec = [None] * len(shape)
        spec[heads_axis] = self.model_axis
        return _fit_spec(spec, tuple(shape), self._shape)

    def shard_kv(self, arr, heads_axis: int = 2, rank: Optional[int] = None):
        return self.local(arr, self.kv_spec(tuple(arr.shape), heads_axis),
                          rank)

    def constrain(self, x, *spec):
        """Identity: a rank's tensors are already its local shards."""
        return x

    def validate_divisible(self, **dims) -> None:
        """Loud divisibility check for dims that MUST shard (a decode
        engine's heads): a non-dividing dim would fit away to a full copy
        on every rank."""
        tp = self.tp_degree
        bad = {k: v for k, v in dims.items() if int(v) % tp != 0}
        if bad:
            raise ValueError(
                f"tensor-parallel degree {self.model_axis}={tp} does not "
                f"divide " + ", ".join(f"{k}={v}" for k, v in bad.items())
                + " — pick a tp that divides the head/hidden counts")

    # -- compile path --------------------------------------------------------
    @property
    def compile_path(self) -> str:
        """``"spmd"``: the port's one path (per-rank code, explicit
        collectives), whatever ``path`` was given."""
        return "spmd"

    def compile(self, fn, in_specs=None, out_specs=None,
                donate_argnums=(), static_argnums=()):
        """``fn`` itself: each rank runs it on its local shards; the specs
        are the caller's record of what is local (no partitioner)."""
        return fn

    # -- observability -------------------------------------------------------
    def describe(self) -> Dict[str, object]:
        """The ``mesh`` block of ``health()``, and the source of the
        ``paddle_mesh_*`` gauges."""
        return {
            "enabled": True,
            "axes": {a: int(s) for a, s in self._shape.items()},
            "devices": self.n_devices,
            "tp": self.tp_degree,
            "dp": self.dp_degree,
            "path": self.compile_path,
        }


def decode_plan(mesh, mp_axis: str = "mp") -> ShardingPlan:
    """Serving plan: tensor-parallel decode rules over ``mesh`` (commonly
    ``"mp2"`` / ``"mp4"``: every rank serves every request, holding 1/tp of
    the weights and KV heads). An ``ep`` or ``pp`` axis of size > 1
    raises: expert and pipeline parallelism are ported for training
    only."""
    plan = ShardingPlan(mesh, rules=tp_decode_rules(mp_axis),
                        data_axes=(), model_axis=mp_axis)
    plan.refuse_in_serving()
    return plan


def train_plan(mesh, rules=None, data_axes=("dp", "fsdp"),
               mp_axis: str = "mp") -> ShardingPlan:
    """Training plan: llama DP x TP rules by default; pass
    :func:`moe_train_rules` for expert-parallel MoE meshes."""
    return ShardingPlan(
        mesh, rules=rules if rules is not None else dp_tp_train_rules(mp_axis),
        data_axes=data_axes, model_axis=mp_axis)
