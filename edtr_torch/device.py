"""Where the port runs: the card unless the caller names another device."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[torch.device | str] = None) -> torch.device:
    """``device`` as given, else the current CUDA device; raises when no
    device is given and no card is present (never a quiet CPU run)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("edtr_torch runs on a CUDA device and none is "
                               "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
