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
* the mesh axes this slice takes are ``dp`` and ``mp``. An ``fsdp``,
  ``ep``, ``sp`` or ``pp`` axis of size > 1 raises ``not_ported`` naming
  the later A10 slice; ``seq_axis`` likewise;
* ``compile`` / ``compile_path``: the port has ONE path, per-rank eager or
  CUDA-graph-captured code with explicit collectives (``"spmd"``), where
  the reference chooses pjit or shard_map (ROADMAP, recorded deviations).
  ``compile`` returns the function itself; ``constrain`` is the identity
  on local shards.

A plan is built and its rules resolved without any process group (the CPU
tests resolve rules against the JAX plan). What needs ranks (``shard``,
the collectives) needs the job's group, of exactly the mesh's size; with
more than one rank and no initialized group it raises ``not_ported`` with
the launch command (the reference's single-process form waits for a later
A10 slice).
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.errors import not_ported
from .mesh import ProcessMesh

_SPEC_TOKEN = re.compile(r"([a-z_]+?)(\d+)")

# the later A10 slice that ports each axis this slice refuses
_LATER_AXES = {
    "fsdp": "A10 slice 3: the fsdp axis and distributed/sharding",
    "ep": "A10 slice 2: expert parallelism",
    "sp": "A10 slice 5: sequence parallel and ring attention",
    "pp": "A10 slice 4: pipeline and the 4D hybrid",
}
_SUPPORTED_AXES = ("dp", "mp")
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
    """MoE placement (expert banks on ``ep``): expert parallelism is a
    later A10 slice."""
    raise not_ported("moe_train_rules (expert-parallel placement)",
                     _LATER_AXES["ep"])


def _is_quantized_weight(v) -> bool:
    return (hasattr(v, "q") and hasattr(v, "scale")
            and hasattr(v, "group_size") and hasattr(v, "out_dtype"))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class ShardingPlan:
    """Named mesh + per-layer partition rules (reference :154).

    Args:
        mesh: ``"dp2mp4"`` spec string or a ProcessMesh.
        rules: ``[(name_regex, spec_tuple)]``; default
            :func:`tp_decode_rules` over ``model_axis``.
        data_axes: mesh axes the batch dim shards over (present ones only).
        model_axis: the tensor-parallel axis (``tp_degree`` is its size).
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
        for name, size in shape.items():
            if size > 1 and name not in _SUPPORTED_AXES:
                raise not_ported(f"mesh axis {name!r} of size {size}",
                                 _LATER_AXES.get(name, "A10"))
        self._shape = shape
        self.model_axis = model_axis
        self.data_axes = tuple(a for a in data_axes if a in shape)
        self.rules = list(rules) if rules is not None \
            else tp_decode_rules(model_axis)
        self._path = path
        self.specs: Dict[str, tuple] = {}
        self._control = None

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
        d = 1
        for a in self.data_axes:
            d *= int(self._shape[a])
        return d

    def __repr__(self):
        axes = "x".join(f"{a}{s}" for a, s in self._shape.items())
        return f"ShardingPlan({axes}, path={self.compile_path!r})"

    def __enter__(self):
        from .collective import use_mesh

        self._use = use_mesh(self.process_mesh)
        self._use.__enter__()
        return self

    def __exit__(self, *exc):
        return self._use.__exit__(*exc)

    # -- ranks and groups ----------------------------------------------------
    def require_group(self) -> None:
        """Raise unless this process can act as one rank of the plan: a
        group of exactly ``n_devices`` ranks, or one rank without a group."""
        if dist.is_initialized():
            if dist.get_world_size() != self.n_devices:
                raise ValueError(
                    f"{self!r} spans {self.n_devices} ranks, the job has "
                    f"{dist.get_world_size()}")
            return
        if self.n_devices > 1:
            raise not_ported(
                f"a {self.n_devices}-rank plan in a process with no "
                f"initialized process group (the single-process form: "
                f"{LAUNCH_HINT})", "A10 slice 1: the single-process TP engine")

    @property
    def rank(self) -> int:
        self.require_group()
        return dist.get_rank() if dist.is_initialized() else 0

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        return self.process_mesh.coords(self.rank if rank is None else rank)

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None in a one-rank
        process without a group)."""
        self.require_group()
        if not dist.is_initialized():
            return None
        return self.process_mesh.group(axis)

    @property
    def mp_group(self):
        return (self.group(self.model_axis)
                if self.model_axis in self._shape else None)

    @property
    def dp_group(self):
        """The data-parallel group (the single data axis this slice
        takes; None without one)."""
        return self.group(self.data_axes[0]) if self.data_axes else None

    def backend(self) -> Optional[str]:
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
        rank fails the group at once (its sockets close). Collective on
        first call."""
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

    def role_for(self, name: str, shape) -> Optional[str]:
        """Megatron role of a 2-D ``[in, out]`` matmul weight:
        ``"column"`` (out dim on the model axis), ``"row"`` (in dim) or
        None (replicated). At model-axis size 1 the raw rule decides, so
        the collectives still run over the one-rank group."""
        if self.model_axis not in self._shape or len(shape) != 2:
            return None
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
        cfg = getattr(model, "config", None)
        if (getattr(cfg, "tie_word_embeddings", False)
                and self.tp_degree > 1):
            raise not_ported("tied word embeddings under a tensor-parallel "
                             "plan", "A10")
        mp = self.mp_group
        return mpu.parallel_view(model, self, mp, share=share)

    def shard_batch(self, arr, rank: Optional[int] = None):
        """This rank's rows of a global batch: dim 0 over the data axes
        (the whole batch when they do not divide it, as ``_fit_spec``
        fits the axis away)."""
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
    the weights and KV heads)."""
    return ShardingPlan(mesh, rules=tp_decode_rules(mp_axis),
                        data_axes=(), model_axis=mp_axis)


def train_plan(mesh, rules=None, data_axes=("dp", "fsdp"),
               mp_axis: str = "mp") -> ShardingPlan:
    """Training plan: llama DP x TP rules by default."""
    return ShardingPlan(
        mesh, rules=rules if rules is not None else dp_tp_train_rules(mp_axis),
        data_axes=data_axes, model_axis=mp_axis)
