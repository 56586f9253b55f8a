"""Normalization ops: RMSNorm (Qwen2) and LayerNorm (Whisper), f32 statistics.

Same rounding points as ``audio_flamingo_tpu/ops/norms.py``.
"""

from __future__ import annotations

import torch
from torch import nn


class Norm(nn.Module):
    """Weight (and optional bias) of a LayerNorm / RMSNorm."""

    def __init__(self, dim: int, bias: bool = True, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **factory))
        self.bias = nn.Parameter(torch.empty(dim, **factory)) if bias else None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * weight; variance in f32, scale applied in x.dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return xf.to(dtype) * weight.to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics and affine, output in x.dtype."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps)) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)
