"""Logit processors and token sampling, as ``audio_flamingo_tpu/ops/sampling.py``.

HF processor order: repetition penalty -> (greedy argmax) -> temperature -> top-k ->
top-p -> categorical. Random draws come from an explicit ``torch.Generator``; the
categorical draw is Gumbel-max, as ``jax.random.categorical`` is, but the bits differ
from JAX's, so sampled paths match the reference in law, not token for token.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    temperature: float = 1.0
    top_k: int = 0                   # 0 = off
    top_p: float = 1.0               # 1.0 = off
    greedy: bool = True
    repetition_penalty: float = 1.0  # 1.0 = off; spans prompt + generated tokens
    min_new_tokens: int = 0          # EOS masked for the first N generated tokens
    no_repeat_ngram_size: int = 0    # 0 = off; other values raise (not ported yet)


def mask_eos(logits: torch.Tensor, eos_token_id: int, blocked: torch.Tensor) -> torch.Tensor:
    """Set the EOS logit to NEG_INF where ``blocked`` ([B] bool)."""
    if eos_token_id < 0:
        return logits
    out = logits.clone()
    out[:, eos_token_id] = torch.where(blocked, torch.full_like(out[:, eos_token_id], NEG_INF),
                                       out[:, eos_token_id])
    return out


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row; others -> NEG_INF."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering, HF semantics: keep the smallest prefix of descending-probability
    tokens whose mass exceeds p (the token that crosses p is kept)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kth = ((cum - probs) < p).sum(dim=-1, keepdim=True)    # >= 1
    thresh = torch.gather(sorted_logits, -1, kth - 1)
    return logits.masked_fill(logits < thresh, NEG_INF)


def apply_repetition_penalty(logits: torch.Tensor, token_history: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Seen tokens' logits are divided by the penalty if > 0, multiplied if < 0.

    token_history: [B, H] int with -1 for empty slots."""
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    tok = token_history.long()
    tok = torch.where((tok < 0) | (tok >= v), torch.full_like(tok, v), tok)
    seen = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, tok, True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen[:, :v], penalized, logits)


def sample_token(logits: torch.Tensor, params: SamplingParams,
                 generator: torch.Generator | None = None,
                 token_history: torch.Tensor | None = None) -> torch.Tensor:
    """[B, vocab] f32 logits -> [B] int64 token ids."""
    if token_history is not None and params.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, token_history, params.repetition_penalty)
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    lg = logits / max(params.temperature, 1e-6)
    lg = apply_top_k(lg, params.top_k)
    lg = apply_top_p(lg, params.top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
