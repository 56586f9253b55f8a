"""Flamingo-style gated cross-attention block (AF1/AF2 fusion), as
``audio_flamingo_tpu/ops/xattn.py``.

A block before an LM layer: text queries attend over the media (the audio-transform
output); each residual is scaled by tanh(alpha) with zero-init alphas, so a fresh block is
an identity (HF modeling_idefics.py:691-815). Media masking follows Flamingo: each text
token attends to the most recent preceding media item ('last') or to all preceding items
('all_previous'); rows that may attend to no media get a zero attention output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.mlp import gelu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm


class XAttnBlock(nn.Module):
    """ln_q / ln_kv / ln_ffn (LayerNorms), bias-free q (d -> d), k, v (d_media -> d) and
    o, a biased GELU MLP of ffn_mult * d, and the two gates."""

    def __init__(self, d_model: int, d_media: int, num_heads: int, ffn_mult: int = 4,
                 **factory):
        super().__init__()
        f = ffn_mult * d_model
        self.num_heads = num_heads
        self.ln_q = Norm(d_model, **factory)
        self.ln_kv = Norm(d_media, **factory)
        self.q = nn.Linear(d_model, d_model, bias=False, **factory)
        self.k = nn.Linear(d_media, d_model, bias=False, **factory)
        self.v = nn.Linear(d_media, d_model, bias=False, **factory)
        self.o = nn.Linear(d_model, d_model, bias=False, **factory)
        self.ln_ffn = Norm(d_model, **factory)
        self.fc1 = nn.Linear(d_model, f, **factory)
        self.fc2 = nn.Linear(f, d_model, **factory)
        self.alpha_xattn = nn.Parameter(torch.empty((), **factory))
        self.alpha_dense = nn.Parameter(torch.empty((), **factory))


def init(d_model: int, d_media: int, num_heads: int, ffn_mult: int = 4, *,
         generator: torch.Generator, device: torch.device | str = "cpu",
         dtype: torch.dtype = torch.float32) -> XAttnBlock:
    """A block with the JAX init's distributions: Normal(0, 0.5 / sqrt(fan_in)) weights,
    zero biases, unit norms and zero gates."""
    with torch.device("meta"):
        block = XAttnBlock(d_model, d_media, num_heads, ffn_mult, dtype=dtype)
    block = block.to_empty(device=device).requires_grad_(False)
    init_(block, generator)
    return block


@torch.no_grad()
def init_(block: XAttnBlock, generator: torch.Generator) -> None:
    for lin in (block.q, block.k, block.v, block.o, block.fc1, block.fc2):
        lin.weight.normal_(0.0, 0.5 * lin.in_features ** -0.5, generator=generator)
        if lin.bias is not None:
            lin.bias.zero_()
    for norm in (block.ln_q, block.ln_kv, block.ln_ffn):
        norm.weight.fill_(1.0)
        norm.bias.zero_()
    block.alpha_xattn.zero_()
    block.alpha_dense.zero_()


def media_mask(text_media_idx: torch.Tensor, n_media: int, tokens_per_media: int,
               mode: str = "last") -> torch.Tensor:
    """Bool [B, 1, T, n_media * tokens_per_media] cross-attention mask. text_media_idx
    [B, T]: the media items seen so far at each text position (0 = none yet)."""
    media_ids = torch.arange(n_media * tokens_per_media,
                             device=text_media_idx.device) // tokens_per_media
    seen = text_media_idx[:, :, None]
    if mode == "last":
        allowed = media_ids[None, None, :] == (seen - 1)
    elif mode == "all_previous":
        allowed = media_ids[None, None, :] < seen
    else:
        raise ValueError(mode)
    return allowed[:, None, :, :]


def apply(block: XAttnBlock, x: torch.Tensor, media: torch.Tensor,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, D] text hidden, media [B, S, Dm] -> [B, T, D]."""
    b, t, d = x.shape
    nh = block.num_heads
    hd = d // nh
    h = layer_norm(x, block.ln_q.weight, block.ln_q.bias)
    m = layer_norm(media, block.ln_kv.weight, block.ln_kv.bias)
    q = F.linear(h, block.q.weight).reshape(b, t, nh, hd)
    k = F.linear(m, block.k.weight).reshape(b, -1, nh, hd)
    v = F.linear(m, block.v.weight).reshape(b, -1, nh, hd)
    attn = gqa_attention(q, k, v, mask=mask).reshape(b, t, d)
    if mask is not None:
        # rows with no attendable media softmax over masked scores: zero them
        any_media = mask.any(dim=-1).any(dim=1)[..., None]          # [B, T, 1]
        attn = torch.where(any_media, attn, torch.zeros_like(attn))
    attn = F.linear(attn, block.o.weight)
    x = x + torch.tanh(block.alpha_xattn).to(x.dtype) * attn
    h = layer_norm(x, block.ln_ffn.weight, block.ln_ffn.bias)
    ffn = gelu_mlp(h, block.fc1.weight, block.fc1.bias, block.fc2.weight, block.fc2.bias)
    return x + torch.tanh(block.alpha_dense).to(x.dtype) * ffn
