"""Prefill / decode generation, as ``audio_flamingo_tpu/runtime/generate.py``.

``prefill`` runs the prompt (+ audio) once and writes the KV cache; a prompt right-padded
to a token bucket is handled by taking the logits at ``prompt_len - 1`` and setting the
cache index back to ``prompt_len`` (pad slots are overwritten before any decode step
attends to them). ``generate`` is a Python loop of ``decode_step`` calls that stops
when every row has emitted EOS; its outputs follow the JAX loop's contract (positions
after EOS hold EOS; lengths count up to and including the first EOS).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from audio_flamingo_tpu_torch.config import NOT_PORTED, AF3Config
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams, mask_eos, sample_token


@dataclass
class GenerateOutput:
    tokens: torch.Tensor        # [B, max_new_tokens] int64
    lengths: torch.Tensor       # [B] int64
    first_logits: torch.Tensor  # [B, vocab] f32 prefill logits at the last prompt token
    ttft_s: float               # prefill + first token, device-synchronized
    decode_s: float             # every later decode step, device-synchronized
    decode_steps: int


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def prefill(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
            mels: torch.Tensor | None, capacity: int, prompt_len: int | None = None):
    """Prompt (+ audio) -> (cache, last-token logits [B, vocab] f32)."""
    b, t = token_ids.shape
    embeds = af3.build_input_embeds(model, cfg, token_ids, mels)
    pos = torch.arange(t, device=token_ids.device)[None].expand(b, t)
    cache = qwen2.init_cache(cfg.lm, b, capacity, embeds.dtype, token_ids.device)
    h, cache = qwen2.forward(model.lm, cfg.lm, embeds, pos, cache=cache, is_prefill=True)
    if prompt_len is None:
        return cache, qwen2.unembed(model.lm, h[:, -1])
    cache.index = prompt_len
    return cache, qwen2.unembed(model.lm, h[:, prompt_len - 1])


@torch.inference_mode()
def decode_step(model: af3.AF3Model, cfg: AF3Config, cache: qwen2.KVCache,
                token: torch.Tensor, position: int):
    """One decode step: [B] token ids at ``position`` -> (cache, [B, vocab] f32 logits)."""
    embeds = qwen2.embed(model.lm, token[:, None])
    pos = torch.full((token.shape[0], 1), position, dtype=torch.long, device=token.device)
    h, cache = qwen2.forward(model.lm, cfg.lm, embeds, pos, cache=cache)
    return cache, qwen2.unembed(model.lm, h[:, 0])


@torch.inference_mode()
def generate(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
             mels: torch.Tensor | None = None, *, max_new_tokens: int = 64,
             capacity: int = 0, eos_token_id: int = -1,
             sampling: SamplingParams = SamplingParams(),
             generator: torch.Generator | None = None,
             prompt_len: int | None = None) -> GenerateOutput:
    """Token ids [B, T] (+ mels) -> GenerateOutput. capacity=0 rounds T + max_new_tokens
    up to a multiple of 128. prompt_len: the true length of a right-padded prompt."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if sampling.no_repeat_ngram_size:
        raise NotImplementedError(NOT_PORTED.format(
            "no_repeat_ngram_size", "generate features of runtime/generate.py"))
    b, t = token_ids.shape
    device = token_ids.device
    if capacity == 0:
        capacity = -(-(t + max_new_tokens) // 128) * 128
    true_len = t if prompt_len is None else prompt_len

    t0 = time.perf_counter()
    cache, logits = prefill(model, cfg, token_ids, mels, capacity, prompt_len=prompt_len)
    first_logits = logits
    history = None
    if sampling.repetition_penalty != 1.0:
        valid = torch.arange(t, device=device)[None] < true_len
        history = torch.where(valid, token_ids.long(), torch.full_like(token_ids.long(), -1))
    if sampling.min_new_tokens >= 1:
        logits = mask_eos(logits, eos_token_id, torch.ones(b, dtype=torch.bool, device=device))
    tok = sample_token(logits, sampling, generator, token_history=history)
    out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.long, device=device)
    out[:, 0] = tok
    done = tok == eos_token_id
    sync(device)
    ttft = time.perf_counter() - t0

    t1 = time.perf_counter()
    step = 0
    while step + 1 < max_new_tokens and not bool(done.all()):
        cache, logits = decode_step(model, cfg, cache, tok, true_len + step)
        hist = None
        if history is not None:
            gen = torch.where(torch.arange(max_new_tokens, device=device)[None] <= step,
                              out, torch.full_like(out, -1))
            hist = torch.cat([history, gen], dim=1)
        if sampling.min_new_tokens > 0:
            logits = mask_eos(logits, eos_token_id,
                              torch.full((b,), step + 1 < sampling.min_new_tokens, device=device))
        nxt = sample_token(logits, sampling, generator, token_history=hist)
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        step += 1
        out[:, step] = nxt
        done = done | (nxt == eos_token_id)
        tok = nxt
    sync(device)
    decode_s = time.perf_counter() - t1

    eos_hit = out == eos_token_id
    lengths = (torch.cumsum(eos_hit.long(), dim=1) == 0).sum(dim=1) + eos_hit.any(dim=1).long()
    return GenerateOutput(tokens=out, lengths=lengths.clamp(max=max_new_tokens),
                          first_logits=first_logits, ttft_s=ttft, decode_s=decode_s,
                          decode_steps=step)
