"""Logit processors and token sampling, as ``audio_flamingo_tpu/ops/sampling.py``.

HF processor order: no-repeat-ngram ban -> repetition penalty -> (greedy argmax) ->
temperature -> top-k -> top-p -> categorical. Random draws come from an explicit
``torch.Generator``; the categorical draw is Gumbel-max, as ``jax.random.categorical``
is, but the bits differ from JAX's, so sampled paths match the reference in law, not
token for token.
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
    no_repeat_ngram_size: int = 0    # 0 = off; bans tokens completing a seen n-gram


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


# ----------------------------------------------------------------------------------------
# Per-row processors and sampling of the serving engines. Every row carries its own
# parameters as tensors, so one decode loop serves any mix of requests. Drawn with the
# engine's ``torch.Generator``: greedy rows match the JAX engines token for token, sampled
# rows in law.


def apply_no_repeat_ngram_rows(logits: torch.Tensor, history: torch.Tensor,
                               lengths: torch.Tensor, n: int,
                               enable: torch.Tensor | None = None) -> torch.Tensor:
    """Ban every token that would complete an n-gram already in a row's history (the
    fairseq / HF NoRepeatNGram rule; the prompt counts).

    history: [B, H] contiguous prompt + generated ids; lengths: [B] (or a scalar) valid
    count per row; enable: optional [B] bool, rows with False pass through."""
    if n <= 0:
        return logits
    b, h = history.shape
    v = logits.shape[-1]
    if h < n:   # no full n-gram fits
        return logits
    device = logits.device
    lengths = torch.as_tensor(lengths, device=device).long().expand(b)
    # the row's current (n-1)-token prefix, at its own offset
    pidx = (lengths[:, None] - (n - 1) + torch.arange(n - 1, device=device)[None]).clamp(0, h - 1)
    prefix = torch.gather(history, 1, pidx)                                  # [B, n-1]
    w = h - (n - 1)
    idx = torch.arange(w, device=device)[:, None] + torch.arange(n - 1, device=device)[None]
    wins = history[:, idx]                                                    # [B, W, n-1]
    nxt = history[:, n - 1:]                                                  # [B, W]
    # window j is a realized n-gram iff its successor lies inside the valid region
    valid = (torch.arange(w, device=device)[None] + n) <= lengths[:, None]
    match = (wins == prefix[:, None, :]).all(dim=-1) & valid
    tok = torch.where(match, nxt.long(), torch.full_like(nxt, v, dtype=torch.long))
    # an empty (-1) entry reads as JAX's scatter reads a negative index: from the end, the
    # pad column (a reused engine row's stale history may hold one past the old request)
    tok = torch.where(tok < 0, tok + (v + 1), tok)
    banned = torch.zeros((b, v + 1), dtype=torch.bool, device=device)
    banned.scatter_(1, tok, True)
    out = logits.masked_fill(banned[:, :v], NEG_INF)
    active = lengths >= n
    if enable is not None:
        active = active & enable
    return torch.where(active[:, None], out, logits)


def apply_no_repeat_ngram(logits: torch.Tensor, history: torch.Tensor, length,
                          n: int) -> torch.Tensor:
    """The n-gram ban with one valid length shared by every row."""
    return apply_no_repeat_ngram_rows(logits, history, length, n)


def apply_repetition_penalty_rows(logits: torch.Tensor, token_history: torch.Tensor,
                                  penalty: torch.Tensor) -> torch.Tensor:
    """Per-row repetition penalty ([B] f32, 1.0 = off) over token_history [B, H] (-1 =
    empty); the seen-token mask is a scatter, never a [B, H, V] one-hot."""
    b, v = logits.shape
    tok = token_history.long()
    tok = torch.where((tok < 0) | (tok >= v), torch.full_like(tok, v), tok)
    seen = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, tok, True)
    pen = torch.as_tensor(penalty, device=logits.device).to(logits.dtype).expand(b)[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen[:, :v] & (pen != 1.0), penalized, logits)


class RowSampling(NamedTuple):
    """Per-row sampling parameters as tensors; build with ``row_sampling``."""

    temperature: torch.Tensor         # [B] f32
    top_k: torch.Tensor               # [B] int64, 0 = off
    top_p: torch.Tensor               # [B] f32, 1.0 = off
    greedy: torch.Tensor              # [B] bool
    repetition_penalty: torch.Tensor  # [B] f32, 1.0 = off
    ngram_n: torch.Tensor             # [B] int64, 0 = off


def row_sampling(params_per_row, device: torch.device | str = "cpu") -> RowSampling:
    ps = list(params_per_row)

    def col(name, dtype):
        return torch.tensor([getattr(p, name) for p in ps], dtype=dtype, device=device)

    return RowSampling(col("temperature", torch.float32), col("top_k", torch.long),
                       col("top_p", torch.float32), col("greedy", torch.bool),
                       col("repetition_penalty", torch.float32),
                       col("no_repeat_ngram_size", torch.long))


def apply_row_processors(logits: torch.Tensor, history: torch.Tensor, lengths: torch.Tensor,
                         rows: RowSampling, *, use_penalty: bool,
                         ngram_ns: tuple) -> torch.Tensor:
    """The history processors over a per-row history [B, H] (-1 = empty) with [B] valid
    counts. ngram_ns: the distinct nonzero n of the active rows; each n bans only the rows
    that asked for it."""
    if use_penalty:
        valid = torch.arange(history.shape[1], device=history.device)[None] < lengths[:, None]
        logits = apply_repetition_penalty_rows(
            logits, torch.where(valid, history, torch.full_like(history, -1)),
            rows.repetition_penalty)
    for n in ngram_ns:
        logits = apply_no_repeat_ngram_rows(logits, history, lengths, n,
                                            enable=rows.ngram_n == n)
    return logits


def apply_top_k_rows(logits: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Per-row top-k ([B] k values; 0 or negative = off)."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = torch.where(ks <= 0, torch.full_like(ks, v), ks).clamp(1, v).long()
    thresh = torch.gather(sorted_desc, -1, (k_eff - 1)[:, None])
    return logits.masked_fill(logits < thresh, NEG_INF)


def apply_top_p_rows(logits: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """Per-row nucleus filtering ([B] p values; 1.0 = off), keeping the crossing token."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kth = ((cum - probs) < ps[:, None]).sum(dim=-1, keepdim=True).clamp(min=1)
    thresh = torch.gather(sorted_desc, -1, kth - 1)
    return logits.masked_fill(logits < thresh, NEG_INF)


def sample_token_rows(logits: torch.Tensor, rows: RowSampling,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """[B, vocab] f32 logits -> [B] int64, each row under its own parameters. Greedy rows
    are the argmax; sampled rows go temperature -> top-k -> top-p -> Gumbel-max."""
    lg = logits / rows.temperature.clamp(min=1e-6)[:, None]
    lg = apply_top_k_rows(lg, rows.top_k)
    lg = apply_top_p_rows(lg, rows.top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
    sampled = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
    return torch.where(rows.greedy, torch.argmax(logits, dim=-1), sampled)


def engine_row_step(generator, logits: torch.Tensor, hist: torch.Tensor,
                    hist_len: torch.Tensor, rows: RowSampling, done: torch.Tensor,
                    min_left: torch.Tensor, step_i: int, *, eos_token_id: int,
                    mixed_sampling: bool, want_logprobs: bool, use_min_new: bool,
                    use_penalty: bool, ngram_ns: tuple):
    """One decode step's processors, shared by the engines: n-gram ban -> min-new-tokens
    EOS mask -> (for sampling only) repetition penalty -> sample -> the reported logprob
    -> history append. The ban and the EOS mask shape the reported distribution; the
    penalty warps only the sampling one. Returns (next [B], logprob [B] or None, hist).
    Nothing here reads the device from the host."""
    b = logits.shape[0]
    if ngram_ns:
        logits = apply_row_processors(logits, hist, hist_len, rows, use_penalty=False,
                                      ngram_ns=ngram_ns)
    if use_min_new:
        logits = mask_eos(logits, eos_token_id, min_left > step_i)
    s_logits = logits
    if use_penalty:
        s_logits = apply_row_processors(logits, hist, hist_len, rows, use_penalty=True,
                                        ngram_ns=())
    nxt = (sample_token_rows(s_logits, rows, generator) if mixed_sampling
           else torch.argmax(s_logits, dim=-1))
    nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
    lp_val = None
    if want_logprobs:
        logp = torch.log_softmax(logits, dim=-1)
        lp_val = torch.where(done, torch.zeros((), device=logits.device),
                             torch.gather(logp, 1, nxt[:, None])[:, 0])
    if use_penalty or ngram_ns:
        # live rows append at their length; done rows (and full ones) drop the write
        h = hist.shape[1]
        pos = torch.where(done | (hist_len >= h), torch.full_like(hist_len, h), hist_len)
        padded = torch.cat([hist, torch.full((b, 1), -1, dtype=hist.dtype, device=hist.device)], 1)
        padded.scatter_(1, pos.long()[:, None], nxt[:, None].to(hist.dtype))
        hist = padded[:, :h]
    return nxt, lp_val, hist


def processor_flags(active_sampling_params) -> tuple:
    """(use_penalty, ngram_ns) of the active rows' SamplingParams."""
    ps = list(active_sampling_params)
    use_pen = any(p.repetition_penalty != 1.0 for p in ps)
    ngram_ns = tuple(sorted({p.no_repeat_ngram_size for p in ps if p.no_repeat_ngram_size > 0}))
    return use_pen, ngram_ns
