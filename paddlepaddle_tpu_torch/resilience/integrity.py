"""Checkpoint integrity: CRC validation, newest-valid discovery, keep-K GC
(the port's own copy of the jax-free ``paddlepaddle_tpu/resilience/
integrity.py``; same names, same rules, same metric names).

Checkpoint format v3 (written by ``distributed.checkpoint.save_state_dict``)
records a ``crc32`` per shard file in ``metadata.json``. This module is the
read-side contract around it:

* :func:`validate_checkpoint` — a directory is a COMMITTED checkpoint iff
  ``metadata.json`` exists, every shard file it names exists, and (v3) every
  shard file's CRC matches. Anything else raises
  :class:`CheckpointCorruptionError` naming the first offending file. It
  checks several files at once (``zlib.crc32`` releases the GIL), so a
  checkpoint of tens of GB validates at the disk's or the page cache's
  speed rather than one core's.
* :class:`CheckpointManager` — step-numbered checkpoints under one root:
  ``save`` writes ``<root>/<prefix>-<step>`` (atomic commit happens inside
  ``save_state_dict``), ``restore`` loads the NEWEST VALID checkpoint,
  silently skipping corrupted/torn ones (each skip increments
  ``paddle_ckpt_fallbacks_total``), and ``gc`` keeps only the newest K
  committed checkpoints.

Validation is torch-free (json + zlib over files), so tooling and
launcher-side checks can run it without a device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib
from typing import Dict, List, Optional, Tuple

__all__ = [
    "CheckpointCorruptionError", "file_crc32", "validate_checkpoint",
    "list_checkpoints", "find_latest_valid_checkpoint", "CheckpointManager",
]

_META_NAME = "metadata.json"
# files a validation (and a checkpoint load) CRC-checks at once
CRC_WORKERS = 8


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint directory is torn, truncated, or bit-flipped."""


def _verify_default() -> bool:
    """Resolve ``verify_crc=None`` against FLAGS_ckpt_verify_crc /
    PADDLE_CKPT_VERIFY, so the documented opt-out governs every validation
    path, not just the loader."""
    try:
        from ..core import flags as _flags

        return bool(_flags.flag_value("ckpt_verify_crc"))
    except Exception:
        return True


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _shard_files(meta: dict) -> List[Tuple[str, Optional[int]]]:
    """(relative file, crc-or-None) for every shard the metadata names."""
    out = []
    for key, rec in meta.get("tensors", {}).items():
        if "shards" in rec:  # v2/v3
            for s in rec["shards"]:
                out.append((s["file"], s.get("crc32")))
        elif "file" in rec:  # v1
            out.append((rec["file"], rec.get("crc32")))
    return out


def validate_checkpoint(path: str, verify_crc: Optional[bool] = None) -> dict:
    """Return the parsed metadata of a committed, intact checkpoint at
    ``path``; raise :class:`CheckpointCorruptionError` otherwise.
    ``verify_crc=None`` follows FLAGS_ckpt_verify_crc (default on)."""
    if verify_crc is None:
        verify_crc = _verify_default()
    meta_path = os.path.join(path, _META_NAME)
    if not os.path.isdir(path):
        raise CheckpointCorruptionError(f"{path}: not a directory")
    if not os.path.exists(meta_path):
        raise CheckpointCorruptionError(
            f"{path}: no {_META_NAME} (uncommitted or torn checkpoint)")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptionError(
            f"{path}: unreadable {_META_NAME}: {e}") from e
    files = _shard_files(meta)
    for fname, _crc in files:
        if not os.path.exists(os.path.join(path, fname)):
            raise CheckpointCorruptionError(
                f"{path}: shard file {fname} missing")
    if verify_crc:
        checked = [(f, c) for f, c in files if c is not None]
        actual = _crcs([os.path.join(path, f) for f, _ in checked])
        for (fname, crc), got in zip(checked, actual):
            if got != crc:
                _count_corruption(fname)
                raise CheckpointCorruptionError(
                    f"{path}: shard file {fname} CRC mismatch "
                    f"(recorded {crc:#010x}, actual {got:#010x})")
    return meta


def _crcs(paths: List[str]) -> List[int]:
    """``file_crc32`` of each path, ``CRC_WORKERS`` at a time."""
    if len(paths) <= 1:
        return [file_crc32(p) for p in paths]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(CRC_WORKERS, len(paths))) as ex:
        return list(ex.map(file_crc32, paths))


def _count_corruption(fname: str) -> None:
    try:
        from ..observability import safe_inc
    except Exception:
        return
    safe_inc("paddle_ckpt_corruption_detected_total",
             "checkpoint shard files that failed CRC/existence validation")


def _count_fallback() -> None:
    try:
        from ..observability import safe_inc
    except Exception:
        return
    safe_inc("paddle_ckpt_fallbacks_total",
             "restores that skipped a corrupt/torn checkpoint and fell back "
             "to an older one")


def list_checkpoints(root: str, prefix: str = "step") -> List[Tuple[int, str]]:
    """(step, path) under ``root`` matching ``<prefix>-<n>``, newest first.

    ``<prefix>-<n>.__old__.<pid>`` crash-recovery dirs (an overwrite commit
    killed between its two renames leaves the previous good checkpoint
    there) are included AFTER their canonical sibling, so restore can still
    find the state instead of silently skipping a step. Staging/temp
    directories (``.`` prefix) never match."""
    pat = re.compile(re.escape(prefix) + r"-(\d+)(\.__old__\.\d+)?$")
    out = []
    if not os.path.isdir(root):
        return []
    for name in os.listdir(root):
        m = pat.match(name)
        if m and not name.startswith("."):
            out.append((int(m.group(1)), m.group(2) is None,
                        os.path.join(root, name)))
    # newest first; within one step the canonical dir before its __old__ twin
    out.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return [(step, path) for step, _canonical, path in out]


def find_latest_valid_checkpoint(root: str, prefix: str = "step",
                                 verify_crc: Optional[bool] = None
                                 ) -> Optional[Tuple[int, str]]:
    """Newest (step, path) that validates; corrupt ones are skipped (and
    counted as fallbacks when a newer-but-broken candidate was passed over)."""
    skipped = False
    for step, path in list_checkpoints(root, prefix):
        try:
            validate_checkpoint(path, verify_crc=verify_crc)
        except CheckpointCorruptionError:
            skipped = True
            continue
        if skipped:
            _count_fallback()
        return step, path
    return None


class CheckpointManager:
    """Step-numbered checkpoints with integrity-aware restore and keep-K GC.

    ::

        mgr = CheckpointManager("/ckpts/run1", keep_last_k=3)
        start = mgr.restore(state_dict)           # newest VALID, or None
        for step in range(start or 0, total):
            ...train...
            mgr.save(state_dict, step + 1)        # atomic commit + GC
    """

    def __init__(self, root: str, keep_last_k: int = 3, prefix: str = "step",
                 verify_crc: Optional[bool] = None):
        if keep_last_k < 1:
            raise ValueError("keep_last_k must be >= 1")
        self.root = root
        self.keep_last_k = keep_last_k
        self.prefix = prefix
        self.verify_crc = verify_crc

    def step_path(self, step: int) -> str:
        return os.path.join(self.root, f"{self.prefix}-{int(step)}")

    def save(self, state_dict: Dict[str, object], step: int,
             async_save: bool = False, **kwargs) -> str:
        from ..distributed import checkpoint as dist_ckpt

        os.makedirs(self.root, exist_ok=True)
        path = self.step_path(step)
        dist_ckpt.save_state_dict(state_dict, path, async_save=async_save,
                                  **kwargs)
        self.gc()
        return path

    def latest_valid(self) -> Optional[Tuple[int, str]]:
        return find_latest_valid_checkpoint(self.root, self.prefix,
                                            verify_crc=self.verify_crc)

    def restore(self, state_dict: Dict[str, object]) -> Optional[int]:
        """Load the newest valid checkpoint into ``state_dict``; falls back
        across corrupt candidates. Returns its step, or None if no valid
        checkpoint exists."""
        from ..distributed import checkpoint as dist_ckpt

        for step, path in list_checkpoints(self.root, self.prefix):
            try:
                # structural validation only: the loader CRC-checks every
                # shard file it actually opens (FLAGS_ckpt_verify_crc), so a
                # full pre-pass here would read each shard twice
                validate_checkpoint(path, verify_crc=False)
                dist_ckpt.load_state_dict(state_dict, path)
                return step
            except CheckpointCorruptionError:
                _count_fallback()
                continue
        return None

    def gc(self) -> List[str]:
        """Delete all but the newest ``keep_last_k`` COMMITTED checkpoints
        (uncommitted/corrupt dirs don't count toward K — they are garbage,
        removed too once older than the kept set). ``__old__``
        crash-recovery dirs are deleted as soon as their canonical twin
        exists (a canonical dir only appears via a completed staged rename,
        so the twin is whole). Returns removed paths."""
        entries = list_checkpoints(self.root, self.prefix)
        canonical_steps = {step for step, path in entries
                           if ".__old__." not in os.path.basename(path)}
        kept = 0
        removed = []
        for step, path in entries:
            if (".__old__." in os.path.basename(path)
                    and step in canonical_steps):
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
                continue
            committed = os.path.exists(os.path.join(path, _META_NAME))
            if committed and kept < self.keep_last_k:
                kept += 1
                continue
            if not committed and self._maybe_in_flight(path):
                # an uncommitted dir may be an async save still writing
                # (possibly LAGGING behind newer committed saves) — never
                # delete under a live writer
                continue
            if not committed and kept < self.keep_last_k:
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        return removed

    @staticmethod
    def _maybe_in_flight(path: str, grace: float = 600.0) -> bool:
        """True when an uncommitted dir might still be receiving writes:
        a writer thread in THIS process is registered for it, or (another
        process may own it) it was modified within ``grace`` seconds."""
        try:
            from ..distributed.checkpoint import _path_last_save

            if path in _path_last_save:
                return True
        except Exception:
            pass
        try:
            return time.time() - os.path.getmtime(path) < grace
        except OSError:
            return True  # can't tell — err on the side of keeping it
