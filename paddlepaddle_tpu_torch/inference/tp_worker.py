"""Worker ranks of a single-process tensor-parallel decode engine.

The reference is single-controller: one process calls
``ServingEngine(model, mesh="mp2")`` and serves over every device of the
mesh. Here the caller's process is rank 0 and the engine starts ranks
1..n-1 itself through :mod:`..distributed.worker_ranks` (groups, backend,
hand-over and lifetime are described there). This module holds the
engine's part: :func:`start_engine_workers` hands each worker its view of
the model (cut by rank 0 after quantizing, ``quant=``) and the draft of
speculative decoding (replicated: the whole model), and :func:`_build_engine`
builds the rank's engine, which follows rank 0
(:meth:`.decode_engine.BatchDecodeEngine.follow`) until rank 0's ``stop()``.
On a shared card the worker maps rank 0's memory with no copy, so rank 0
keeps those tensors until the worker has ended; on a card of its own the
worker copies its view there once and rank 0 lets go of it when the worker
reports ready.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..distributed.worker_ranks import start_workers


def _build_engine(held: Dict[str, object], plan, device: torch.device,
                  **engine_kw):
    """Rank r's engine over its view (``held["net"]``) under the bound
    ``plan``, with the replicated draft."""
    from .decode_engine import BatchDecodeEngine

    return BatchDecodeEngine(held.pop("net"), plan=plan,
                             draft=held.pop("draft"), device=device,
                             **engine_kw)


def start_engine_workers(plan, cuts, draft, engine_kw: Dict[str, object],
                         device: torch.device):
    """Start ranks 1..n-1 of ``plan`` for an engine on ``device`` (rank 0,
    the caller): rank r builds its engine on ``cuts[r]`` with
    ``engine_kw`` and the replicated ``draft``. Returns ``(plan bound to
    rank 0's groups, WorkerRanks)`` once every worker has built its engine;
    a worker's construction error raises here."""
    held = [{"net": cuts[r], "draft": draft}
            for r in range(1, plan.n_devices)]
    return start_workers(plan, held, _build_engine, engine_kw, device,
                         what="tensor-parallel worker")
