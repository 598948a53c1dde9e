"""Device resolution for the port's entry points.

The port serves on an NVIDIA GPU. The CPU is taken only when the caller asks
for it by name (the tests do); a missing GPU is an error, never a silent
fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises when no GPU
    is visible); ``"cpu"`` -> the CPU; ``"cuda:N"`` -> that GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
