"""dygraph_optimizer (counterpart of ``paddlepaddle_tpu/distributed/fleet/
meta_optimizers/dygraph_optimizer/__init__.py``; reference:
fleet/meta_optimizers/dygraph_optimizer/).

``HybridParallelOptimizer`` wraps an optimizer for hybrid runs. The JAX
package's wrapper is the identity: one controller holds every parameter
whole, so its clip norm is already global. In the port each rank holds
its shards, so a ``ClipGradByGlobalNorm`` inside it sums the squared norms
over the hybrid group's ``mp``, ``pp`` and ``sharding`` groups before it
scales (as ``parallel.sharded``'s clip does under a plan): a gradient
sharded over ``mp`` (an mpu layer's, by its ``dist_spec``) or ``sharding``
is summed over that group, every gradient over ``pp`` (each stage holds
its own parameters), and a replicated one is counted once. The loss and
the update then equal the reference's one process.
``HybridParallelGradScaler`` delegates to ``amp.GradScaler``, whose
found-inf is MAXed over the host group.
"""

from .....amp import GradScaler as _GradScaler


def _hybrid_clip(optimizer, hcg):
    """``optimizer``'s global-norm clip over the hybrid group's shards, or
    its clip unchanged where nothing is sharded."""
    from .....nn.clip import ClipGradByGlobalNorm
    from .....parallel.sharded import _PlanClip, _axes_of_spec

    clip = optimizer._grad_clip
    if (hcg is None or not hcg.live or clip is None
            or isinstance(clip, _PlanClip)
            or not isinstance(clip, ClipGradByGlobalNorm)):
        return clip
    sizes = {"mp": hcg.get_model_parallel_world_size(),
             "pp": hcg.get_pipe_parallel_world_size(),
             "sharding": hcg.get_sharding_parallel_world_size()}
    axes = []
    for p in optimizer.parameters:
        spec = _axes_of_spec(getattr(p, "dist_spec", None) or ())
        on = tuple(a for a in ("sharding", "mp")
                   if a in spec and sizes[a] > 1)
        axes.append(on + (("pp",) if sizes["pp"] > 1 else ()))
    if not any(axes):
        return clip
    groups = {"mp": hcg.get_model_parallel_group().pg,
              "pp": hcg.get_pipe_parallel_group().pg,
              "sharding": hcg.get_sharding_parallel_group().pg}
    return _PlanClip(clip, axes, groups)


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        optimizer._grad_clip = _hybrid_clip(optimizer, hcg)

    def __getattr__(self, name):
        if name == "_inner_opt":
            raise AttributeError(name)
        return getattr(self._inner_opt, name)

    def step(self):
        return self._inner_opt.step()


class HybridParallelGradScaler(_GradScaler):
    def __init__(self, scaler=None, hcg=None, **kw):
        if scaler is None:
            super().__init__(**kw)
        elif isinstance(scaler, _GradScaler):
            self.__dict__.update(scaler.__dict__)
        else:
            raise TypeError(
                "scaler must be an amp.GradScaler, got "
                f"{type(scaler).__name__} — wrapping an unknown scaler would "
                "silently replace its loss-scale schedule")
