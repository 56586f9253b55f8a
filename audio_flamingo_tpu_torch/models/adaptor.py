"""Audio adaptor: encoder features -> LM embedding space (2-layer MLP, exact GELU), as
``audio_flamingo_tpu/models/adaptor.py``. A 1-layer (single Linear) adaptor, the
Qwen2-Audio projector, is also taken."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Adaptor(nn.Module):
    def __init__(self, d_in: int, d_out: int, num_layers: int = 2, **factory):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_out, **factory)
        self.fc2 = nn.Linear(d_out, d_out, **factory) if num_layers == 2 else None


@torch.no_grad()
def init_(ada: Adaptor, generator: torch.Generator) -> None:
    """Normal(0, 0.5 / sqrt(fan_in)) weights, zero biases (the JAX init)."""
    for lin in (ada.fc1, ada.fc2):
        if lin is not None:
            lin.weight.normal_(0.0, 0.5 * lin.in_features ** -0.5, generator=generator)
            lin.bias.zero_()


def apply(ada: Adaptor, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x, ada.fc1.weight) + ada.fc1.bias
    if ada.fc2 is not None:
        y = F.linear(F.gelu(y), ada.fc2.weight) + ada.fc2.bias
    return y
