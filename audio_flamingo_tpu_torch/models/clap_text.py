"""CLAP text tower (RoBERTa-style) and the contrastive loss, as
``audio_flamingo_tpu/models/clap_text.py``: AF2 retrains CLAP with stronger text
understanding. Not on the generate path; no kernel of its own.

``encode(tower, cfg, input_ids, attention_mask)`` -> {'pooled', 'embeds'}: RoBERTa
embeddings (pad-offset position ids), a post-LN encoder with exact GELU, a tanh pooler over
the first token, the 2-layer ReLU projection and its L2 normalisation.
``contrastive_loss`` is the symmetric InfoNCE over the two logit matrices. Weights are
torch layouts (linears [out, in]); JAX's tree crosses with
``io/convert.clap_text_params_from_jax`` (and back with ``clap_text_params_to_jax``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm


@dataclass(frozen=True)
class ClapTextConfig:
    vocab_size: int = 50_265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12
    projection_dim: int = 512


class ClapTextLayer(nn.Module):
    def __init__(self, cfg: ClapTextConfig, **factory):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.q, self.k, self.v, self.o = (nn.Linear(d, d, **factory) for _ in range(4))
        self.ln_attn = Norm(d, **factory)
        self.fc1 = nn.Linear(d, f, **factory)
        self.fc2 = nn.Linear(f, d, **factory)
        self.ln_out = Norm(d, **factory)


class ClapTextTower(nn.Module):
    def __init__(self, cfg: ClapTextConfig, **factory):
        super().__init__()
        d = cfg.hidden_size
        self.word_emb = nn.Parameter(torch.empty(cfg.vocab_size, d, **factory))
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_position_embeddings, d, **factory))
        self.type_emb = nn.Parameter(torch.empty(cfg.type_vocab_size, d, **factory))
        self.ln_emb = Norm(d, **factory)
        self.layers = nn.ModuleList(ClapTextLayer(cfg, **factory) for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(d, d, **factory)
        self.proj_fc1 = nn.Linear(d, cfg.projection_dim, **factory)
        self.proj_fc2 = nn.Linear(cfg.projection_dim, cfg.projection_dim, **factory)


def build(cfg: ClapTextConfig, device: torch.device | str, dtype: torch.dtype) -> ClapTextTower:
    """The tower's weights (uninitialized) allocated on ``device`` in ``dtype``."""
    with torch.device("meta"):
        tower = ClapTextTower(cfg, dtype=dtype)
    return tower.to_empty(device=device).eval().requires_grad_(False)


@torch.no_grad()
def init_(tower: ClapTextTower, generator: torch.Generator) -> None:
    """The JAX init's distributions: Normal(0, 0.5 / sqrt(fan_in)) linears, zero biases,
    Normal(0, 0.02) embeddings, unit norms."""
    for mod in tower.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 0.5 * mod.in_features ** -0.5, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, Norm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for emb in (tower.word_emb, tower.pos_emb, tower.type_emb):
        emb.normal_(0.0, 0.02, generator=generator)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """The product in x's dtype, then the bias (JAX ``_linear``'s rounding points)."""
    return F.linear(x, lin.weight) + lin.bias.to(x.dtype)


def encode(tower: ClapTextTower, cfg: ClapTextConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor | None = None) -> dict:
    """[B, T] ids -> {'pooled': [B, d], 'embeds': [B, projection_dim] L2-normalised}; the
    mask (1 = token) defaults to the non-pad positions."""
    b, t = input_ids.shape
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).long()
    attention_mask = attention_mask.long()
    # RoBERTa position ids: pads at pad_idx, tokens at pad_idx + their running count
    pos_ids = torch.cumsum(attention_mask, dim=1) * attention_mask + cfg.pad_token_id
    x = (tower.word_emb[input_ids] + tower.pos_emb[pos_ids]
         + tower.type_emb[torch.zeros_like(input_ids)])
    x = layer_norm(x, tower.ln_emb.weight, tower.ln_emb.bias, eps=cfg.layer_norm_eps)
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    mask = attention_mask[:, None, None, :].bool()
    for lp in tower.layers:
        q, k, v = (_linear(x, lin).reshape(b, t, nh, hd) for lin in (lp.q, lp.k, lp.v))
        attn = gqa_attention(q, k, v, mask=mask).reshape(b, t, cfg.hidden_size)
        x = layer_norm(x + _linear(attn, lp.o), lp.ln_attn.weight, lp.ln_attn.bias,
                       eps=cfg.layer_norm_eps)
        ffn = _linear(F.gelu(_linear(x, lp.fc1)), lp.fc2)
        x = layer_norm(x + ffn, lp.ln_out.weight, lp.ln_out.bias, eps=cfg.layer_norm_eps)
    pooled = torch.tanh(_linear(x[:, 0], tower.pooler))
    proj = _linear(F.relu(_linear(pooled, tower.proj_fc1)), tower.proj_fc2)
    return {"pooled": pooled, "embeds": proj / torch.linalg.norm(proj, dim=-1, keepdim=True)}


def contrastive_loss(audio_embeds: torch.Tensor, text_embeds: torch.Tensor,
                     logit_scale_a: torch.Tensor, logit_scale_t: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over normalised embeddings: the caption loss over the text's
    logits plus the audio loss over the audio's, halved ([hf] modeling_clap.py:119-126)."""
    logits_per_text = text_embeds @ audio_embeds.T * torch.exp(torch.as_tensor(logit_scale_t))
    logits_per_audio = audio_embeds @ text_embeds.T * torch.exp(torch.as_tensor(logit_scale_a))
    labels = torch.arange(text_embeds.shape[0], device=text_embeds.device)
    return 0.5 * (F.cross_entropy(logits_per_text, labels)
                  + F.cross_entropy(logits_per_audio, labels))
