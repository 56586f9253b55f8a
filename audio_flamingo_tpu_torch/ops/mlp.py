"""Feed-forward blocks on torch Linear-layout weights ([out, in]).

SwiGLU (Qwen2): down(silu(gate(x)) * up(x)), no biases. GELU MLP (Whisper): exact GELU,
biased. Each product is rounded to x.dtype before the bias add, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu_mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
               down: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def gelu_mlp(x: torch.Tensor, fc1: torch.Tensor, fc1_b: torch.Tensor, fc2: torch.Tensor,
             fc2_b: torch.Tensor, activation: str = "gelu") -> torch.Tensor:
    h = F.linear(x, fc1) + fc1_b.to(x.dtype)
    if activation == "gelu":
        h = F.gelu(h)
    elif activation == "relu":
        h = F.relu(h)
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return F.linear(h, fc2) + fc2_b.to(x.dtype)
