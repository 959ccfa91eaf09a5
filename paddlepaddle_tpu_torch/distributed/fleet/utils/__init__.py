"""fleet.utils namespace (counterpart of
``paddlepaddle_tpu/distributed/fleet/utils/__init__.py``): recompute and
the sequential helper."""

from ..recompute import recompute, recompute_sequential  # noqa: F401
