"""Rotary position embeddings, Qwen2 semantics (rotate_half, halves not interleaved)."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 1_000_000.0,
                 dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., seq] int positions -> cos/sin tables [..., seq, head_dim] (halves duplicated)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    # theta as a CPU scalar: no host-to-device copy (and no sync) in a decode step
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q [b, s, h, d], k [b, s, hkv, d]; cos/sin [b, s, d] or [s, d]."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    q_rot = q * cos.to(q.dtype) + _rotate_half(q) * sin.to(q.dtype)
    k_rot = k * cos.to(k.dtype) + _rotate_half(k) * sin.to(k.dtype)
    return q_rot, k_rot
