"""AF-Whisper audio tower (Whisper-encoder architecture), as
``audio_flamingo_tpu/models/whisper_encoder.py``.

Conv stem (k=3, strides 1 and 2, exact GELU), sinusoid positions, pre-norm layers with
q pre-scaled after its bias and a bias-free k, strictly 3000 mel frames per window,
then AvgPool (stride 2) BEFORE the final LayerNorm. Each 30 s window is a batch row.
Attention goes to the flash-attention kernel (scale=1.0, q is pre-scaled) when
``cfg.use_flash`` is set, to plain ``gqa_attention`` otherwise. Each layer runs under
``remat_wrap(..., cfg.remat)`` (ops/remat.py), and nothing on the path writes in place,
so the stack is differentiable end to end (flash through its backward kernel).

``WhisperEncoder`` holds the weights in torch layouts (Linear [out, in], Conv1d
[out, in, k]); ``apply`` runs them under a config, as the JAX ``apply`` does, in the
weights' dtype (the JAX ``compute_dtype``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import WhisperEncoderConfig
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.kernels.flash_attention import flash_attention
from audio_flamingo_tpu_torch.ops.mlp import gelu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm
from audio_flamingo_tpu_torch.ops.remat import remat_wrap


def sinusoid_positions(length: int, channels: int, max_timescale: float = 10_000.0) -> np.ndarray:
    """Whisper sinusoid table: concat([sin, cos], axis=1)."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, **factory):
        super().__init__()
        d, f = cfg.d_model, cfg.ffn_dim
        self.self_attn_layer_norm = Norm(d, **factory)
        self.q_proj = nn.Linear(d, d, **factory)
        self.k_proj = nn.Linear(d, d, bias=False, **factory)
        self.v_proj = nn.Linear(d, d, **factory)
        self.out_proj = nn.Linear(d, d, **factory)
        self.final_layer_norm = Norm(d, **factory)
        self.fc1 = nn.Linear(d, f, **factory)
        self.fc2 = nn.Linear(f, d, **factory)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, **factory):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1, **factory)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, **factory)
        self.embed_positions = nn.Parameter(torch.empty(cfg.max_source_positions, d, **factory))
        self.layers = nn.ModuleList(EncoderLayer(cfg, **factory) for _ in range(cfg.num_layers))
        self.layer_norm = Norm(d, **factory)


@torch.no_grad()
def init_(enc: WhisperEncoder, cfg: WhisperEncoderConfig, generator: torch.Generator) -> None:
    """Random weights with the JAX init's distributions (uniform +-1/sqrt(fan_in) linears
    and convs, zero biases, unit norms, sinusoid positions)."""
    def uniform(w, bound):
        w.uniform_(-bound, bound, generator=generator)

    uniform(enc.conv1.weight, (1.0 / (cfg.num_mel_bins * 3)) ** 0.5)
    uniform(enc.conv2.weight, (1.0 / (cfg.d_model * 3)) ** 0.5)
    enc.embed_positions.copy_(torch.from_numpy(
        sinusoid_positions(cfg.max_source_positions, cfg.d_model)))
    for layer in enc.layers:
        for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.out_proj,
                    layer.fc1, layer.fc2):
            uniform(lin.weight, lin.in_features ** -0.5)
    for name, p in enc.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("norm.weight"):
            p.fill_(1.0)


def _layer_forward(x: torch.Tensor, layer: EncoderLayer, cfg: WhisperEncoderConfig) -> torch.Tensor:
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    ln = layer.self_attn_layer_norm
    h = layer_norm(x, ln.weight, ln.bias)
    q = ((F.linear(h, layer.q_proj.weight) + layer.q_proj.bias) * (hd ** -0.5)).reshape(b, s, nh, hd)
    k = F.linear(h, layer.k_proj.weight).reshape(b, s, nh, hd)
    v = (F.linear(h, layer.v_proj.weight) + layer.v_proj.bias).reshape(b, s, nh, hd)
    if cfg.use_flash:
        attn = flash_attention(q, k, v, scale=1.0)
    else:
        attn = gqa_attention(q, k, v, scale=1.0)
    x = x + (F.linear(attn.reshape(b, s, d), layer.out_proj.weight) + layer.out_proj.bias)
    ln = layer.final_layer_norm
    h = layer_norm(x, ln.weight, ln.bias)
    return x + gelu_mlp(h, layer.fc1.weight, layer.fc1.bias, layer.fc2.weight, layer.fc2.bias,
                        activation=cfg.activation)


def pool_output(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool1d(stride, stride) over time."""
    if stride == 1:
        return x
    n, t, d = x.shape
    return x.reshape(n, t // stride, stride, d).mean(dim=2)


def apply(enc: WhisperEncoder, cfg: WhisperEncoderConfig, mels: torch.Tensor) -> torch.Tensor:
    """[num_windows, 2 * max_source_positions, num_mel_bins] -> [num_windows, T/pool, d],
    computed in the weights' dtype."""
    n, frames, n_mels = mels.shape
    if frames != 2 * cfg.max_source_positions or n_mels != cfg.num_mel_bins:
        raise ValueError(f"expected [N, {2 * cfg.max_source_positions}, {cfg.num_mel_bins}] "
                         f"mels, got {tuple(mels.shape)}")
    x = mels.to(enc.conv1.weight.dtype).transpose(1, 2)             # [N, M, frames]
    x = F.gelu(F.conv1d(x, enc.conv1.weight, padding=1) + enc.conv1.bias[:, None])
    x = F.gelu(F.conv1d(x, enc.conv2.weight, stride=2, padding=1) + enc.conv2.bias[:, None])
    x = x.transpose(1, 2) + enc.embed_positions[None]
    layer_fn = remat_wrap(lambda h, layer: _layer_forward(h, layer, cfg), cfg.remat)
    for layer in enc.layers:
        x = layer_fn(x, layer)
    x = pool_output(x, cfg.pool_stride)
    return layer_norm(x, enc.layer_norm.weight, enc.layer_norm.bias)
