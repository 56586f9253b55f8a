"""OPT decoder (AF1's OPT-IML-MAX-1.3B), as ``audio_flamingo_tpu/models/opt.py``.

Learned positions with offset 2, pre-norm (or post-norm when ``do_layer_norm_before`` is
off), q scaled by ``hd ** -0.5`` before the product (which then runs at scale 1), a ReLU
MLP, biased linears and, where ``word_embed_proj_dim`` is set, ``project_in`` /
``project_out`` around the stack. The cache is ``qwen2.KVCache`` (every head its own KV
head), written in place at its device index as the Qwen2 stack writes it. OPT is bf16 or
f32 and plain in JAX too: no kernel of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import OPTConfig
from audio_flamingo_tpu_torch.models.qwen2 import KVCache, _gather_ids
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm
from audio_flamingo_tpu_torch.ops.quant import mm_f32


def init_cache(cfg: OPTConfig, batch: int, capacity: int, dtype: torch.dtype,
               device: torch.device | str) -> KVCache:
    hd = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, batch, capacity, cfg.num_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


class OPTLayer(nn.Module):
    def __init__(self, cfg: OPTConfig, **factory):
        super().__init__()
        d, f = cfg.hidden_size, cfg.ffn_dim
        self.ln1 = Norm(d, **factory)
        self.q = nn.Linear(d, d, **factory)
        self.k = nn.Linear(d, d, **factory)
        self.v = nn.Linear(d, d, **factory)
        self.o = nn.Linear(d, d, **factory)
        self.ln2 = Norm(d, **factory)
        self.fc1 = nn.Linear(d, f, **factory)
        self.fc2 = nn.Linear(f, d, **factory)


class OPT(nn.Module):
    """embed [vocab, emb_dim] (the tied head), pos_embed [max_positions + offset, d],
    the layers, ln_f, and project_in / project_out (bias-free) when emb_dim != d."""

    def __init__(self, cfg: OPTConfig, **factory):
        super().__init__()
        d = cfg.hidden_size
        emb_dim = cfg.word_embed_proj_dim or d
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, emb_dim, **factory))
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.max_position_embeddings + cfg.position_offset, d, **factory))
        self.layers = nn.ModuleList(OPTLayer(cfg, **factory) for _ in range(cfg.num_layers))
        self.ln_f = Norm(d, **factory)
        self.project_in = self.project_out = None
        if cfg.word_embed_proj_dim:
            self.project_in = nn.Linear(emb_dim, d, bias=False, **factory)
            self.project_out = nn.Linear(d, emb_dim, bias=False, **factory)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype


def build(cfg: OPTConfig, device: torch.device | str, dtype: torch.dtype) -> OPT:
    """An OPT's weights (uninitialized) allocated on ``device`` in ``dtype``."""
    with torch.device("meta"):
        lm = OPT(cfg, dtype=dtype)
    return lm.to_empty(device=device).eval().requires_grad_(False)


@torch.no_grad()
def init_(lm: OPT, generator: torch.Generator) -> None:
    """The JAX init's distributions: Normal(0, 0.5 / sqrt(fan_in)) layer linears, zero
    biases, unit norms, Normal(0, 0.02) embeddings and projections."""
    for layer in lm.layers:
        for lin in (layer.q, layer.k, layer.v, layer.o, layer.fc1, layer.fc2):
            lin.weight.normal_(0.0, 0.5 * lin.in_features ** -0.5, generator=generator)
            lin.bias.zero_()
        for norm in (layer.ln1, layer.ln2):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
    lm.ln_f.weight.fill_(1.0)
    lm.ln_f.bias.zero_()
    lm.embed.normal_(0.0, 0.02, generator=generator)
    lm.pos_embed.normal_(0.0, 0.02, generator=generator)
    for proj in (lm.project_in, lm.project_out):
        if proj is not None:
            proj.weight.normal_(0.0, 0.02, generator=generator)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight) + lin.bias.to(x.dtype)


def _layer_forward(x: torch.Tensor, lm: OPT, i: int, cfg: OPTConfig, mask,
                   cache: KVCache | None = None, slots: torch.Tensor | None = None,
                   attend=None):
    """Layer i on x [b, s, d]; with a cache this step's K/V is written at ``slots`` and
    attention spans the whole cache (``mask`` [b, 1, s, capacity]). ``attend(q, k, v)`` ->
    [b, s, nh, hd] replaces both (the engines' caches: q comes scaled, attend at scale 1)."""
    b, s, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    lp = lm.layers[i]
    residual = x
    h = layer_norm(x, lp.ln1.weight, lp.ln1.bias) if cfg.do_layer_norm_before else x
    q = (_linear(h, lp.q) * (hd ** -0.5)).reshape(b, s, nh, hd)
    k = _linear(h, lp.k).reshape(b, s, nh, hd)
    v = _linear(h, lp.v).reshape(b, s, nh, hd)
    if attend is not None:
        attn = attend(q, k, v).to(x.dtype)
    else:
        if cache is not None:
            ck, cv = cache.k[i], cache.v[i]
            ck.index_copy_(1, slots, k.to(ck.dtype))
            cv.index_copy_(1, slots, v.to(cv.dtype))
            k, v = ck.to(q.dtype), cv.to(q.dtype)
        attn = gqa_attention(q, k, v, mask=mask, scale=1.0)
    x = residual + _linear(attn.reshape(b, s, d), lp.o)
    if not cfg.do_layer_norm_before:
        x = layer_norm(x, lp.ln1.weight, lp.ln1.bias)
    residual = x
    h = layer_norm(x, lp.ln2.weight, lp.ln2.bias) if cfg.do_layer_norm_before else x
    x = residual + _linear(F.relu(_linear(h, lp.fc1)), lp.fc2)
    if not cfg.do_layer_norm_before:
        x = layer_norm(x, lp.ln2.weight, lp.ln2.bias)
    return x


def embed(lm: OPT, token_ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings (through project_in), read as JAX's gather reads them (see
    ``qwen2.embed``)."""
    x = F.embedding(_gather_ids(token_ids, lm.embed.shape[0]), lm.embed)
    return x if lm.project_in is None else F.linear(x, lm.project_in.weight)


def unembed(lm: OPT, hidden: torch.Tensor) -> torch.Tensor:
    """hidden -> f32 logits through the tied embedding (after project_out)."""
    h = hidden if lm.project_out is None else F.linear(hidden, lm.project_out.weight)
    logits = mm_f32(h.reshape(-1, h.shape[-1]), lm.embed.t())
    return logits.reshape(*h.shape[:-1], lm.embed.shape[0])


def final_norm(lm: OPT, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, lm.ln_f.weight, lm.ln_f.bias)


def position_embeds(lm: OPT, cfg: OPTConfig, positions: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Learned positions with the offset applied."""
    return lm.pos_embed[positions + cfg.position_offset].to(dtype)


def forward(lm: OPT, cfg: OPTConfig, embeds: torch.Tensor, positions: torch.Tensor,
            cache: KVCache | None = None) -> tuple[torch.Tensor, KVCache | None]:
    """The decoder stack on input embeddings [b, s, d] at absolute positions [b, s]
    (offset applied inside). With a cache, K/V are written at its device index and the
    cache is advanced by s. Returns (final-normed hidden states, cache)."""
    b, s, _ = embeds.shape
    x = embeds + position_embeds(lm, cfg, positions, embeds.dtype)
    if cache is not None:
        if cache.host_index + s > cache.capacity:
            raise ValueError(f"KV cache of {cache.capacity} slots cannot take "
                             f"{cache.host_index} + {s} positions")
        kv_pos = torch.arange(cache.capacity, device=embeds.device)[None, None, None, :]
        slots = cache.index + torch.arange(s, device=embeds.device)
        mask = kv_pos <= positions[:, None, :, None]
    else:
        slots = None
        mask = positions[:, None, :, None] >= positions[:, None, None, :]
    for i in range(cfg.num_layers):
        x = _layer_forward(x, lm, i, cfg, mask, cache, slots)
    if cache is not None:
        cache.advance(s)
    return final_norm(lm, x), cache


@torch.inference_mode()
def logits_from_ids(lm: OPT, cfg: OPTConfig, token_ids: torch.Tensor) -> torch.Tensor:
    b, t = token_ids.shape
    pos = torch.arange(t, device=token_ids.device)[None].expand(b, t)
    h, _ = forward(lm, cfg, embed(lm, token_ids), pos)
    return unembed(lm, h)
