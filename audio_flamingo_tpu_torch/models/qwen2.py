"""Qwen2 / Qwen2.5 decoder, as ``audio_flamingo_tpu/models/qwen2.py``.

RMSNorm pre-norm layers, q/k/v biases and a bias-free o_proj, RoPE (rotate_half),
SwiGLU MLP, a fixed-capacity KV cache written at an offset (slot s holds absolute
position s), and the per-layer sliding-window gate (layer i slides iff
``sliding_window`` is set and i >= ``max_window_layers``). ``forward`` takes input
embeddings so audio tokens can be scattered in upstream (models/af3.py).

Attention goes to the flash-attention kernel only on a fresh multi-token prefill with a
purely causal mask (no extra mask, no sliding layer), as in the JAX ``forward``; every
other call (decode, warm cache, masked) uses plain ``gqa_attention``.

Unlike the JAX cache, ``KVCache`` is updated in place: prefill and decode write their
K/V into the preallocated tensors and advance ``index``, so no step copies the cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import Qwen2Config
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.kernels.flash_attention import flash_attention
from audio_flamingo_tpu_torch.ops.mlp import swiglu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, rms_norm
from audio_flamingo_tpu_torch.ops.rope import apply_rope, rope_cos_sin


@dataclass
class KVCache:
    """k, v: [num_layers, batch, capacity, num_kv_heads, head_dim]; index: filled slots."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: Qwen2Config, batch: int, capacity: int, dtype: torch.dtype,
               device: torch.device | str) -> KVCache:
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim())
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config, **factory):
        super().__init__()
        d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.resolved_head_dim()
        bias = cfg.attention_bias
        self.input_layernorm = Norm(d, bias=False, **factory)
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=bias, **factory)
        self.k_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=bias, **factory)
        self.v_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=bias, **factory)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False, **factory)
        self.post_attention_layernorm = Norm(d, bias=False, **factory)
        self.gate_proj = nn.Linear(d, f, bias=False, **factory)
        self.up_proj = nn.Linear(d, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, d, bias=False, **factory)


class Qwen2(nn.Module):
    def __init__(self, cfg: Qwen2Config, **factory):
        super().__init__()
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(DecoderLayer(cfg, **factory) for _ in range(cfg.num_layers))
        self.norm = Norm(cfg.hidden_size, bias=False, **factory)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **factory)))


@torch.no_grad()
def init_(lm: Qwen2, generator: torch.Generator) -> None:
    """The JAX init's distributions: Normal(0, 0.5 / sqrt(fan_in)) linears, zero biases,
    unit norms, Normal(0, 0.02) embedding and head."""
    for layer in lm.layers:
        for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.o_proj,
                    layer.gate_proj, layer.up_proj, layer.down_proj):
            lin.weight.normal_(0.0, 0.5 * lin.in_features ** -0.5, generator=generator)
            if lin.bias is not None:
                lin.bias.zero_()
        layer.input_layernorm.weight.fill_(1.0)
        layer.post_attention_layernorm.weight.fill_(1.0)
    lm.norm.weight.fill_(1.0)
    lm.embed_tokens.normal_(0.0, 0.02, generator=generator)
    if lm.lm_head is not None:
        lm.lm_head.normal_(0.0, 0.02, generator=generator)


def embed(lm: Qwen2, token_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(token_ids, lm.embed_tokens)


def unembed(lm: Qwen2, hidden: torch.Tensor) -> torch.Tensor:
    """hidden -> f32 logits, through lm_head or the tied embedding.

    A bf16 head on the card is multiplied as it is, accumulating and writing f32, so no
    f32 copy of the [vocab, d] head is made per step. bf16 products are exact in f32, so
    this is the reference's upcast-then-multiply up to the order of the sums."""
    head = lm.embed_tokens if lm.lm_head is None else lm.lm_head
    if head.device.type != "cuda" or head.dtype == torch.float32 or hidden.dtype != head.dtype:
        return F.linear(hidden.float(), head.float())
    h = hidden.reshape(-1, hidden.shape[-1])
    logits = torch.mm(h, head.t(), out_dtype=torch.float32)
    return logits.reshape(*hidden.shape[:-1], head.shape[0])


def _layer_forward(x, layer: DecoderLayer, cfg: Qwen2Config, cos, sin, mask,
                   cache: KVCache | None, layer_idx: int, flash_ok: bool) -> torch.Tensor:
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()

    def proj(lin, n):
        y = F.linear(h, lin.weight)
        return (y if lin.bias is None else y + lin.bias).reshape(b, s, n, hd)

    h = rms_norm(x, layer.input_layernorm.weight, cfg.rms_norm_eps)
    q, k, v = proj(layer.q_proj, nh), proj(layer.k_proj, nkv), proj(layer.v_proj, nkv)
    q, k = apply_rope(q, k, cos, sin)
    use_flash = flash_ok and s > 1
    if cache is not None:
        ck, cv = cache.k[layer_idx], cache.v[layer_idx]
        ck[:, cache.index: cache.index + s] = k
        cv[:, cache.index: cache.index + s] = v
        if not use_flash:
            # the block's own K/V is the whole context only on a fresh prefill
            k, v = ck, cv
    attn = flash_attention(q, k, v, causal=True) if use_flash else gqa_attention(q, k, v, mask=mask)
    x = x + F.linear(attn.reshape(b, s, nh * hd), layer.o_proj.weight)
    h = rms_norm(x, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
    return x + swiglu_mlp(h, layer.gate_proj.weight, layer.up_proj.weight,
                          layer.down_proj.weight)


def forward(lm: Qwen2, cfg: Qwen2Config, embeds: torch.Tensor, positions: torch.Tensor,
            cache: KVCache | None = None, extra_mask: torch.Tensor | None = None,
            is_prefill: bool = False) -> tuple[torch.Tensor, KVCache | None]:
    """Run the decoder stack on input embeddings [b, s, d] at absolute positions [b, s].

    With a cache, this step's K/V is written at ``cache.index`` and attention spans the
    cache (causal by absolute position); the cache is advanced by s and returned.
    ``extra_mask`` [b, 1, s, kv_len] is AND-ed onto the causal mask. ``is_prefill``
    certifies cache.index == 0, which lets the flash kernel attend over the block's own
    K/V. Returns (final-normed hidden states, cache).
    """
    b, s, _ = embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim(), cfg.rope_theta)
    sliding = cfg.sliding_window is not None and cfg.max_window_layers < cfg.num_layers
    q_pos = positions[:, None, :, None]
    if cache is not None:
        if cache.index + s > cache.capacity:
            raise ValueError(f"KV cache of {cache.capacity} slots cannot take "
                             f"{cache.index} + {s} positions")
        kv_pos = torch.arange(cache.capacity, device=embeds.device)[None, None, None, :]
    else:
        kv_pos = positions[:, None, None, :]
    mask = kv_pos <= q_pos
    sw_mask = mask & (kv_pos > q_pos - cfg.sliding_window) if sliding else None
    if extra_mask is not None:
        mask = mask & extra_mask
        if sliding:
            sw_mask = sw_mask & extra_mask
    flash_ok = (cfg.use_flash and extra_mask is None and not sliding
                and (cache is None or is_prefill))
    x = embeds
    for i, layer in enumerate(lm.layers):
        layer_mask = sw_mask if sliding and i >= cfg.max_window_layers else mask
        x = _layer_forward(x, layer, cfg, cos, sin, layer_mask, cache, i, flash_ok)
    if cache is not None:
        cache.index += s
    return rms_norm(x, lm.norm.weight, cfg.rms_norm_eps), cache
