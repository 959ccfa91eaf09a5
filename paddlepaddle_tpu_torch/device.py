"""Default-device resolution for the port's entry points.

Every entry point (model construction, the decode engine, the serving
engine) takes ``device=``. ``None`` means the card: ``cuda`` when PyTorch
sees one, otherwise an error. Nothing here ever drifts to the CPU on its
own; the CPU is used only when the caller asks for it, as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is missing); ``"cpu"`` /
    ``"cuda"`` / ``"cuda:N"`` / a ``torch.device`` pass through after the
    same availability check."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given: the port "
                "runs on the card by default; pass device='cpu' to run its "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
