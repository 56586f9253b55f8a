"""The GELU / ReLU feed-forward block on torch Linear-layout weights ([out, in]).

Exact GELU, biased (Whisper, CLAP, the Flamingo LM). Each product is rounded to x.dtype
before the bias add, as in the JAX package. Qwen2's SwiGLU is ``models/qwen2.mlp_forward``,
where each linear can carry LoRA adapters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
