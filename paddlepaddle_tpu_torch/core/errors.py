"""The error every not-yet-ported option raises, naming the ROADMAP item
that will port it."""

from __future__ import annotations


def not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to paddlepaddle_tpu_torch yet "
        f"(ROADMAP {item})")
