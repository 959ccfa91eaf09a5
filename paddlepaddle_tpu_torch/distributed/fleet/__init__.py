from .recompute import recompute, recompute_sequential  # noqa: F401
