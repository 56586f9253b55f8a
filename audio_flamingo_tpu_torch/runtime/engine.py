"""Request bookkeeping of the serving engines, as ``audio_flamingo_tpu/runtime/engine.py``
(``Request`` :521, ``seed_history`` :493, ``_find_stop`` :506, the request metrics
:576-595, ``_emit_first_token`` :597, ``_postprocess_chunk_row`` :636).

The slot engine (``BatchEngine``) and the speculative-decoding statistics of that module
are not ported yet (ROADMAP.md, Queue 1); ``runtime/paged_engine.PagedEngine`` uses what
is here. An engine passed to these functions has ``sampling``, ``eos_token_id``,
``finished``, ``request_metrics``, ``metrics`` and ``generator`` (a ``torch.Generator``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from audio_flamingo_tpu_torch.ops.sampling import (SamplingParams, apply_no_repeat_ngram,
                                                   mask_eos, sample_token)
from audio_flamingo_tpu_torch.utils.metrics import RequestTimer


def seed_history(hist: torch.Tensor, row: int, capacity: int, req, sampling) -> torch.Tensor:
    """Write one row of the device history: the request's prompt and every token it has
    emitted (the first token included). A no-op unless the request uses a history
    processor (repetition penalty or n-gram ban)."""
    if sampling.repetition_penalty == 1.0 and sampling.no_repeat_ngram_size == 0:
        return hist
    buf = np.full((capacity,), -1, np.int64)
    toks = np.concatenate([np.asarray(req.ids[0], np.int64),
                           np.asarray(req.tokens, np.int64)])[:capacity]
    buf[: len(toks)] = toks
    hist[row] = torch.from_numpy(buf).to(hist.device)
    return hist


def _find_stop(tokens: list, stops) -> int | None:
    """Index after the earliest full occurrence of any stop sequence, else None."""
    best = None
    for seq in stops:
        m = len(seq)
        sl = list(seq)
        for i in range(len(tokens) - m + 1):
            if tokens[i:i + m] == sl:
                end = i + m
                best = end if best is None else min(best, end)
                break
    return best


@dataclass
class Request:
    request_id: str
    ids: np.ndarray                   # [1, T]
    mels: object = None               # [1, windows, 3000, n_mels], numpy or torch, or None
    max_new_tokens: int = 128
    sampling: SamplingParams | None = None   # None -> the engine's default
    tokens: list = field(default_factory=list)
    done: bool = False
    on_tokens: object = None   # optional callable(list[int]), called as tokens emit
    min_new_tokens: int = 0    # EOS masked for the first N generated tokens
    stop: list | None = None   # token-id sequences; generation stops after any (kept)
    logprobs: bool = False     # collect each token's logprob into token_logprobs
    token_logprobs: list = field(default_factory=list)
    timer: object = None       # RequestTimer, attached at submit


def _start_request_metrics(req: Request) -> None:
    if req.timer is None:
        req.timer = RequestTimer()   # the clock starts at submit: queue wait counts


def _finish_request_metrics(engine, req: Request) -> None:
    """Record TTFT, decode tok/s and total latency of a retired request."""
    if req.timer is None:
        return
    m = req.timer.finish()
    engine.request_metrics[req.request_id] = m
    if getattr(engine, "metrics", None) is not None:
        engine.metrics.log(request_id=req.request_id,
                           **{k: v for k, v in m.items() if v is not None})


def _emit_first_token(engine, req: Request, logits_row: torch.Tensor):
    """Sample a request's first token from its [V] prefill logits under its own
    SamplingParams (the n-gram ban and the penalty over the prompt, the EOS floor),
    record timer, logprob and stream callback, and retire the request at once on EOS.

    Returns (token, finished, the request's SamplingParams); the caller releases the
    row's pages when finished is True."""
    req_sampling = req.sampling or engine.sampling
    lg = logits_row[None] if logits_row.ndim == 1 else logits_row
    prompt = torch.as_tensor(np.asarray(req.ids), dtype=torch.long, device=lg.device)
    if req_sampling.no_repeat_ngram_size > 0:
        lg = apply_no_repeat_ngram(lg, prompt, prompt.shape[1],
                                   req_sampling.no_repeat_ngram_size)
    if max(req.min_new_tokens, req_sampling.min_new_tokens) >= 1:
        lg = mask_eos(lg, engine.eos_token_id, torch.ones((1,), dtype=torch.bool,
                                                          device=lg.device))
    # the penalty warps the sampling only, not the reported logprob
    hist = prompt if req_sampling.repetition_penalty != 1.0 else None
    first = int(sample_token(lg, req_sampling, engine.generator, token_history=hist)[0])
    req.tokens.append(first)
    if req.timer is not None:
        req.timer.first_token()
    if req.logprobs:
        req.token_logprobs.append(float(torch.log_softmax(lg[0].float(), dim=-1)[first]))
    if req.on_tokens:
        req.on_tokens([first])
    finished = first == engine.eos_token_id
    if finished:
        engine.finished[req.request_id] = req.tokens
        _finish_request_metrics(engine, req)
    return first, finished, req_sampling


def _postprocess_chunk_row(engine, req: Request, row_tokens, lp_row) -> bool:
    """Per-row bookkeeping after a decode chunk: the budget and EOS trim, the stop
    sequence trim (before the callbacks, so a stream never delivers a token the trim
    removes), logprobs, timer, on_tokens. Returns True when a stop sequence fired."""
    budget = req.max_new_tokens - len(req.tokens)
    emitted = [int(t) for t in row_tokens[:budget]]
    if engine.eos_token_id in emitted:
        emitted = emitted[: emitted.index(engine.eos_token_id) + 1]
    prev = len(req.tokens)
    req.tokens.extend(emitted)
    hit_stop = False
    if req.stop:
        end = _find_stop(req.tokens, req.stop)
        if end is not None:
            del req.tokens[end:]
            hit_stop = True
    kept = req.tokens[prev:]
    if req.logprobs and lp_row is not None:
        req.token_logprobs.extend(float(x) for x in lp_row[: len(kept)])
    if req.timer is not None:
        req.timer.n_tokens += len(kept)
    if req.on_tokens and kept:
        req.on_tokens(kept)
    return hit_stop
