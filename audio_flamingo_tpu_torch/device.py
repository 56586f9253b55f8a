"""Device rule of the port's entry points: CUDA unless the caller asks for another."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """None means CUDA; without a card that raises rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on "
                               "the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (its current one when unindexed),
    which the kernel wrappers size their grids by."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())
