"""Device peak specs — the denominators of every roofline number.

Port of ``paddlepaddle_tpu/observability/perf/device.py``. The table holds
the one card the port is built for and nothing else: the NVIDIA H100 SXM
(NVIDIA's data sheet, dense rates without sparsity): 989e12 bf16 FLOP/s on
the tensor cores and 3.35e12 B/s of HBM3, the figures this repository's
MFU and kernel bounds already use. A card is matched on
``torch.cuda.get_device_name()``. The reference's unknown-accelerator
default (a guessed peak) is deliberately not kept: an unknown card gets no
peaks, so no MFU, bandwidth share or roofline class is derived for it,
where a guess would publish a wrong one. The CPU keeps the reference's
tiny figures, so CPU runs still derive finite, obviously-not-a-card
numbers.
"""

from __future__ import annotations

from typing import Optional

# (device-name substring, peak bf16 dense FLOP/s, peak HBM bytes/s)
_TABLE = [
    ("H100", 989e12, 3.35e12),
]
_DEFAULT_CPU = (1e12, 100e9)        # CPU: keeps ratios finite


def _lookup(name: str, platform: str) -> tuple:
    """``(peak_flops, peak_bytes_per_s)``; ``(None, None)`` for a card the
    table does not hold."""
    for key, flops, bw in _TABLE:
        if key in name:
            return flops, bw
    if platform == "cpu":
        return _DEFAULT_CPU
    return None, None


def _describe(device) -> dict:
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        return {"device": name, "platform": "gpu",
                "capability": list(torch.cuda.get_device_capability(dev))}
    return {"device": "cpu", "platform": "cpu"}


def peak_flops(device=None) -> Optional[float]:
    """Peak bf16 tensor-core FLOP/s of ``device`` (default: the current
    card, else the CPU); None for a card the table does not hold."""
    return specs(device)["peak_flops"]


def peak_hbm_bytes_per_s(device=None) -> Optional[float]:
    """Peak HBM bandwidth in bytes/s; None for an unknown card."""
    return specs(device)["peak_hbm_bytes_per_s"]


_specs: Optional[dict] = None


def specs(device=None) -> dict:
    """Resolved peak-spec dict for the process's default device (cached —
    the registry derives every roofline number from it). Passing a device
    bypasses the cache."""
    global _specs
    if device is None and _specs is not None:
        return _specs
    out = _describe(device)
    flops, bw = _lookup(out["device"], out["platform"])
    out.update(peak_flops=flops, peak_hbm_bytes_per_s=bw,
               ridge_flops_per_byte=(None if flops is None else flops / bw))
    if device is None:
        _specs = out
    return out


def reset_cache() -> None:
    global _specs
    _specs = None
