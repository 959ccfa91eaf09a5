"""Resilience subset of the port: the preemption handler serving drains
through."""
