"""fleet.meta_optimizers namespace (counterpart of
``paddlepaddle_tpu/distributed/fleet/meta_optimizers/__init__.py``): the
dygraph wrappers and LocalSGD. ``DGCMomentumOptimizer``, which the
reference re-exports here, is ROADMAP item 4 (not ported)."""

from . import dygraph_optimizer  # noqa: F401
from ..localsgd import LocalSGD  # noqa: F401
