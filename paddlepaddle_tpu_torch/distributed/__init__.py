"""Distributed training of the port: only ``fleet.recompute`` so far (the
rest is ROADMAP A10)."""

from .fleet.recompute import recompute, recompute_sequential  # noqa: F401
