"""Device rule of the port's entry points: CUDA unless the caller asks for another."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """None means CUDA; without a card that raises rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on "
                               "the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
