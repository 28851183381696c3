"""Device resolution: an explicit device everywhere, no silent fallback."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cpu"``/``"cuda"``/``"cuda:N"`` -> ``torch.device``; a CUDA device
    on a machine without a usable GPU raises instead of running on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False (no GPU, or a CPU-only PyTorch build)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
