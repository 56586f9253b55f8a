"""Prefill / decode generation, as ``audio_flamingo_tpu/runtime/generate.py``.

``prefill`` runs the prompt (+ audio) once and writes the KV cache; a prompt right-padded
to a token bucket is handled by taking the logits at ``prompt_len - 1`` and setting the
cache index back to ``prompt_len`` (pad slots are overwritten before any decode step
attends to them). ``generate`` is a Python loop of ``decode_step`` calls that stops
when every row has emitted EOS or a stop sequence; its outputs follow the JAX
``decode_loop``'s contract (positions after EOS hold EOS; lengths count up to and
including the first EOS, or up to the end of the first stop sequence; with
``return_logprobs`` each sampled token's f32 log-probability under the logits it was
sampled from). ``generate_stream`` is the host-driven batch-1 loop that yields token ids
as they are sampled (JAX ``generate_stream``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

import torch

from audio_flamingo_tpu_torch.config import NOT_PORTED, AF3Config
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.sampling import (SamplingParams, apply_no_repeat_ngram,
                                                   mask_eos, sample_token)


@dataclass
class GenerateOutput:
    tokens: torch.Tensor        # [B, max_new_tokens] int64
    lengths: torch.Tensor       # [B] int64
    first_logits: torch.Tensor  # [B, vocab] f32 prefill logits at the last prompt token
    ttft_s: float               # prefill + first token, device-synchronized
    decode_s: float             # every later decode step, device-synchronized
    decode_steps: int
    logprobs: torch.Tensor | None = None   # [B, max_new_tokens] f32 with return_logprobs


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


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """f32 log-softmax of [B, vocab] logits at the sampled [B] tokens."""
    return torch.log_softmax(logits.float(), dim=-1).gather(1, tok[:, None])[:, 0]


def check_stops(out: torch.Tensor, step: int, done: torch.Tensor,
                stop_sequences: tuple) -> torch.Tensor:
    """done | (a stop sequence ends exactly at ``step`` of out [B, max_new_tokens])."""
    for seq in stop_sequences:
        m = len(seq)
        if m <= out.shape[1] and step + 1 >= m:
            win = out[:, step + 1 - m: step + 1]
            done = done | (win == torch.as_tensor(seq, device=out.device)[None]).all(dim=1)
    return done


def output_lengths(out: torch.Tensor, eos_token_id: int, stop_sequences: tuple) -> torch.Tensor:
    """Tokens up to and including the first EOS, cut at the end of the earliest stop
    sequence (a stop hit leaves no EOS marker where it ends)."""
    max_new = out.shape[1]
    eos_hit = out == eos_token_id
    lengths = (torch.cumsum(eos_hit.long(), dim=1) == 0).sum(dim=1) + eos_hit.any(dim=1).long()
    for seq in stop_sequences:
        m = len(seq)
        if m > max_new:
            continue
        wins = out.unfold(1, m, 1)                                   # [B, W, m]
        hit = (wins == torch.as_tensor(seq, device=out.device)).all(dim=-1)
        first_end = torch.where(hit.any(dim=1), hit.long().argmax(dim=1) + m,
                                torch.full_like(lengths, max_new))
        lengths = torch.minimum(lengths, first_end)
    return lengths.clamp(max=max_new)


def _check_prompt_len(prompt_len, stop_sequences: tuple, return_logprobs: bool,
                      sampling: SamplingParams) -> None:
    """A scalar prompt_len only: JAX refuses stops, logprobs and the n-gram ban on ragged
    rows, and its ragged generate (the slot engine's rows) is not ported."""
    if prompt_len is None or isinstance(prompt_len, int) or torch.as_tensor(prompt_len).ndim == 0:
        return
    if stop_sequences or return_logprobs or sampling.no_repeat_ngram_size:
        raise ValueError("ragged batches: use the engines for stops/logprobs/ngram blocking")
    raise NotImplementedError(NOT_PORTED.format("ragged generate (prompt_len per row)",
                                                "BatchEngine and ragged rows"))


@torch.inference_mode()
def generate(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
             mels: torch.Tensor | None = None, *, max_new_tokens: int = 64,
             capacity: int = 0, eos_token_id: int = -1,
             sampling: SamplingParams = SamplingParams(),
             generator: torch.Generator | None = None,
             prompt_len: int | None = None, stop_sequences: tuple = (),
             return_logprobs: bool = False) -> GenerateOutput:
    """Token ids [B, T] (+ mels) -> GenerateOutput. capacity=0 rounds T + max_new_tokens
    up to a multiple of 128. prompt_len: the true length of a right-padded prompt.

    ``sampling.no_repeat_ngram_size`` bans, at every step, the tokens that would complete
    an n-gram of the exact prompt plus the tokens generated so far (the JAX loop's rule;
    a right-padded prompt counts only its first ``prompt_len`` ids). ``stop_sequences``
    (token-id tuples): a row stops after emitting any of them, keeping the sequence.
    ``return_logprobs``: ``logprobs`` holds each sampled token's log-probability under
    the logits it was sampled from, after the n-gram ban and the EOS floor (0 past a
    row's end)."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    _check_prompt_len(prompt_len, stop_sequences, return_logprobs, sampling)
    stop_sequences = tuple(tuple(int(t) for t in seq) for seq in stop_sequences)
    b, t = token_ids.shape
    device = token_ids.device
    if capacity == 0:
        capacity = -(-(t + max_new_tokens) // 128) * 128
    true_len = t if prompt_len is None else int(prompt_len)

    t0 = time.perf_counter()
    cache, logits = prefill(model, cfg, token_ids, mels, capacity, prompt_len=prompt_len)
    first_logits = logits
    history = None
    if sampling.repetition_penalty != 1.0:
        valid = torch.arange(t, device=device)[None] < true_len
        history = torch.where(valid, token_ids.long(), torch.full_like(token_ids.long(), -1))
    ngram = sampling.no_repeat_ngram_size
    if ngram > 0:
        prompt_tokens = token_ids[:, :true_len].long()
        logits = apply_no_repeat_ngram(
            logits, torch.cat([prompt_tokens, torch.zeros((b, max_new_tokens), dtype=torch.long,
                                                          device=device)], 1), true_len, ngram)
    if sampling.min_new_tokens >= 1:
        logits = mask_eos(logits, eos_token_id, torch.ones(b, dtype=torch.bool, device=device))
    tok = sample_token(logits, sampling, generator, token_history=history)
    out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.long, device=device)
    out[:, 0] = tok
    logprobs = None
    if return_logprobs:
        logprobs = torch.zeros((b, max_new_tokens), dtype=torch.float32, device=device)
        logprobs[:, 0] = token_logprob(logits, tok)
    done = check_stops(out, 0, tok == eos_token_id, stop_sequences)
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
        if ngram > 0:
            logits = apply_no_repeat_ngram(logits, torch.cat([prompt_tokens, out], 1),
                                           true_len + step + 1, ngram)
        if sampling.min_new_tokens > 0:
            logits = mask_eos(logits, eos_token_id,
                              torch.full((b,), step + 1 < sampling.min_new_tokens, device=device))
        nxt = sample_token(logits, sampling, generator, token_history=hist)
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        step += 1
        out[:, step] = nxt
        if return_logprobs:
            logprobs[:, step] = torch.where(done, 0.0, token_logprob(logits, nxt))
        done = check_stops(out, step, done | (nxt == eos_token_id), stop_sequences)
        tok = nxt
    sync(device)
    decode_s = time.perf_counter() - t1

    return GenerateOutput(tokens=out, lengths=output_lengths(out, eos_token_id, stop_sequences),
                          first_logits=first_logits, ttft_s=ttft, decode_s=decode_s,
                          decode_steps=step, logprobs=logprobs)


@torch.inference_mode()
def generate_stream(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
                    mels: torch.Tensor | None = None, *, max_new_tokens: int = 128,
                    capacity: int = 0, eos_token_id: int = -1,
                    sampling: SamplingParams = SamplingParams(),
                    generator: torch.Generator | None = None,
                    prompt_len: int | None = None) -> Iterator[int]:
    """Host-driven streaming decode (batch 1): yields token ids as they are sampled, up to
    and including EOS. The EOS floor (``min_new_tokens``) and the repetition penalty
    (over the prompt plus what it has generated) apply as in ``generate``."""
    b, t = token_ids.shape
    if b != 1:
        raise ValueError(f"streaming drives batch 1, got {b} rows")
    if capacity == 0:
        capacity = -(-(t + max_new_tokens) // 128) * 128
    cache, logits = prefill(model, cfg, token_ids, mels, capacity, prompt_len=prompt_len)
    true_len = t if prompt_len is None else int(prompt_len)
    history = (token_ids[0, :true_len].tolist() if sampling.repetition_penalty != 1.0
               else None)
    device = token_ids.device

    def pick(logits, generated: int) -> torch.Tensor:
        if generated < sampling.min_new_tokens:
            logits = mask_eos(logits, eos_token_id, torch.ones(1, dtype=torch.bool,
                                                               device=device))
        hist = None if history is None else torch.tensor(history, device=device)[None]
        return sample_token(logits, sampling, generator, token_history=hist)

    token = pick(logits, 0)
    for i in range(max_new_tokens):
        tid = int(token[0])
        yield tid
        if tid == eos_token_id or i + 1 == max_new_tokens:
            return
        if history is not None:
            history.append(tid)
        cache, logits = decode_step(model, cfg, cache, token, true_len + i)
        token = pick(logits, i + 1)
