"""The slot-based continuous-batching engine and the request bookkeeping of the serving
engines, as ``audio_flamingo_tpu/runtime/engine.py``.

``BatchEngine``: ``num_slots`` cache rows share one static KV buffer (``SlotCache``, a
filled length per row); requests prefill into free slots as they arrive
(``prefill_into_slot``, in place into the slot's row) and ``decode_chunk`` advances every
active slot ``chunk`` steps at once, each row at its own offset (``_rows_forward``: per-row
writes at ``positions[b]``, the mask ``kv_pos <= positions[b] + i``; a fused w4 LM at one
token and at most 8 rows through the two suffix kernels, K6, as JAX does). The engine's
step is eager and reads the device once per chunk. Greedy rows equal single-request
``generate`` token for token. Beam requests ride the beam lane (``submit_beam``,
``runtime/beam_lane.py``); with ``draft_params`` the engine speculates, k draft
proposals a round checked by one target verify (``decode_spec_chunk``, greedy, and
``decode_spec_chunk_sampled``).

The bookkeeping (``Request`` :521, ``seed_history`` :493, ``_find_stop`` :506, the request
metrics :576-595, ``_emit_first_token`` :597, ``_postprocess_chunk_row`` :636) is shared
with ``runtime/paged_engine.PagedEngine``. An engine passed to these functions has
``sampling``, ``eos_token_id``, ``finished``, ``request_metrics``, ``metrics`` and
``generator`` (a ``torch.Generator``). The engines take the port's model (``AF3Model``)
where JAX takes ``params``, decode in the model's dtype and draw from one
``torch.Generator`` seeded from ``seed``: greedy rows match the JAX engines token for
token, sampled rows in law.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config, bucket_tokens
from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.rope import rope_cos_sin
from audio_flamingo_tpu_torch.ops.sampling import (RowSampling, SamplingParams,
                                                   apply_no_repeat_ngram, engine_row_step,
                                                   mask_eos, processor_flags, row_sampling,
                                                   sample_token)
from audio_flamingo_tpu_torch.runtime import beam_lane
from audio_flamingo_tpu_torch.runtime import generate as gen
from audio_flamingo_tpu_torch.utils.metrics import RequestTimer


@dataclass
class SlotCache:
    k: torch.Tensor         # [L, B, C, nkv, hd]
    v: torch.Tensor
    lengths: torch.Tensor   # [B] int32 filled length per row; a step replaces the tensor


def init_slot_cache(cfg: Qwen2Config, batch: int, capacity: int, dtype: torch.dtype,
                    device: torch.device | str) -> SlotCache:
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim())
    return SlotCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros((batch,), dtype=torch.int32, device=device))


def _rows_forward(lm, cfg: Qwen2Config, embeds: torch.Tensor, positions: torch.Tensor,
                  cache: SlotCache):
    """Decode forward with per-row cache offsets: embeds [B, s, d] at positions [B].
    Token i of row b is written at cache position positions[b] + i (in place) and attends
    the positions <= positions[b] + i; writes come before the read, so a block of several
    tokens is causal per row. Returns (final-normed hidden states, cache)."""
    b, s, _ = embeds.shape
    device = embeds.device
    pos_grid = positions.long()[:, None] + torch.arange(s, device=device)[None]    # [B, s]
    cos, sin = rope_cos_sin(pos_grid, cfg.resolved_head_dim(), cfg.rope_theta)
    kv_pos = torch.arange(cache.k.shape[2], device=device)
    mask = kv_pos[None, None, None, :] <= pos_grid[:, None, :, None]              # [B,1,s,C]
    rows = torch.arange(b, device=device)[:, None].expand(b, s)

    def attend_layer(i: int):
        def attend(q, k, v):
            ck, cv = cache.k[i], cache.v[i]
            ck.index_put_((rows, pos_grid), k.to(ck.dtype))
            cv.index_put_((rows, pos_grid), v.to(cv.dtype))
            return gqa_attention(q, ck, cv, mask=mask)
        return attend

    return qwen2.forward_attend(lm, cfg, embeds, cos, sin, attend_layer), cache


@torch.inference_mode()
def decode_chunk(lm, cfg: Qwen2Config, cache: SlotCache, tokens: torch.Tensor,
                 done: torch.Tensor, generator: torch.Generator | None, rows: RowSampling,
                 min_left: torch.Tensor, hist: torch.Tensor | None = None, *, chunk: int,
                 eos_token_id: int, mixed_sampling: bool = False, want_logprobs: bool = False,
                 use_min_new: bool = False, use_penalty: bool = False, ngram_ns: tuple = (),
                 step=None):
    """Advance every slot ``chunk`` steps, reading nothing back to the host. rows: per-row
    sampling parameters; min_left [B]: tokens still under the EOS floor; hist [B, H]:
    prompt + generated ids (-1 elsewhere) for the repetition penalty and the n-gram ban,
    kept across chunks (row b holds lengths[b] + 1 ids: the cache lags by the token not
    yet forwarded). A done row keeps its length and emits EOS. ``step(cache, tokens)`` ->
    (cache, logits [B, V] f32), writing at ``cache.lengths``, replaces the LM's step (the
    AF1/AF2 stack's, ``runtime/flamingo_engine.py``).

    Returns (cache, tokens [B], done [B], out [B, chunk], logprobs [B, chunk] f32, hist)."""
    b = tokens.shape[0]
    device = tokens.device
    out = torch.full((b, chunk), eos_token_id, dtype=torch.long, device=device)
    lp = torch.zeros((b, chunk), dtype=torch.float32, device=device)
    if hist is None:
        hist = torch.full((b, 8), -1, dtype=torch.long, device=device)   # processors off
    for i in range(chunk):
        if step is None:
            x = qwen2.embed(lm, tokens[:, None])
            h, cache = _rows_forward(lm, cfg, x, cache.lengths, cache)
            logits = qwen2.unembed(lm, h[:, 0])
        else:
            cache, logits = step(cache, tokens)
        nxt, lp_val, hist = engine_row_step(
            generator, logits, hist, cache.lengths + 1, rows, done, min_left, i,
            eos_token_id=eos_token_id, mixed_sampling=mixed_sampling,
            want_logprobs=want_logprobs, use_min_new=use_min_new, use_penalty=use_penalty,
            ngram_ns=ngram_ns)
        if want_logprobs:
            lp[:, i] = lp_val
        cache.lengths = cache.lengths + (~done).int()
        out[:, i] = nxt
        done = done | (nxt == eos_token_id)
        tokens = nxt
    return cache, tokens, done, out, lp, hist


# ----------------------------------------------------------------------------------------
# Speculative chunks (JAX :177-444), shared with the paged engine


def spec_emit(props: torch.Tensor, match: torch.Tensor, correction: torch.Tensor,
              done: torch.Tensor, *, eos_token_id: int):
    """The emit bookkeeping of greedy and sampled speculation (JAX :177): per-row accept
    flags ``match`` [B, k] and the correction (or bonus) token [B] at the first rejection
    -> (emitted [B, k + 1], ok [B, k + 1] emit mask cut after the first EOS, n_emitted [B],
    hit_eos [B])."""
    b, k = match.shape
    ar = torch.arange(k + 1, device=props.device)[None]
    m = torch.cumprod(match.long(), dim=1).sum(dim=1)                        # [B]
    emitted = torch.where(ar == m[:, None], correction[:, None],
                          torch.cat([props, props.new_zeros((b, 1))], dim=1))
    emit_mask = (ar <= m[:, None]) & ~done[:, None]
    is_eos = (emitted == eos_token_id).long()
    ok = emit_mask & (torch.cumsum(is_eos, dim=1) - is_eos == 0)
    return emitted, ok, ok.long().sum(dim=1), ((emitted == eos_token_id) & emit_mask).any(dim=1)


def spec_accept_emit(props: torch.Tensor, greedy: torch.Tensor, done: torch.Tensor,
                     generator: torch.Generator | None, *, accept_sim: float | None,
                     eos_token_id: int):
    """The greedy rule (JAX :197): accept the longest prefix where the draft matched the
    target's argmax; the correction is the target's token at the first mismatch.
    ``accept_sim`` (measurement only): Bernoulli(accept_sim) draws replace the comparison,
    every computation still running (at 0 and 1 the draws are certain)."""
    b, k = props.shape
    match = props == greedy[:, :k]
    if accept_sim is not None:
        match = torch.rand((b, k), generator=generator, device=props.device) < accept_sim
    m = torch.cumprod(match.long(), dim=1).sum(dim=1)
    correction = torch.gather(greedy, 1, m[:, None])[:, 0]
    return spec_emit(props, match, correction, done, eos_token_id=eos_token_id)


def spec_sampled_accept(generator: torch.Generator | None, p_t: torch.Tensor, p_d: torch.Tensor,
                        props: torch.Tensor, done: torch.Tensor, *, eos_token_id: int):
    """The batched Leviathan rule (JAX :214): p_t [B, k + 1, V] and p_d [B, k, V] warped
    alike; proposal x_i is accepted with probability min(1, p_t(x_i) / p_d(x_i)), the first
    rejection resamples from the renormalized residual max(p_t - p_d, 0) (at m == k the zero
    draft row makes it p_t[k], the bonus draw). The emitted law is the warped target's."""
    from audio_flamingo_tpu_torch.runtime.speculative import _log, categorical

    b, k = props.shape
    pt_x = torch.gather(p_t[:, :k], 2, props[..., None])[..., 0]
    pd_x = torch.gather(p_d, 2, props[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, device=props.device)
    match = u < (pt_x / pd_x.clamp(min=1e-30)).clamp(max=1.0)
    m = torch.cumprod(match.long(), dim=1).sum(dim=1)
    p_d_ext = torch.cat([p_d, torch.zeros_like(p_d[:, :1])], dim=1)
    idx = m[:, None, None].expand(b, 1, p_t.shape[-1])
    p_m = torch.gather(p_t, 1, idx)[:, 0]
    residual = (p_m - torch.gather(p_d_ext, 1, idx)[:, 0]).clamp(min=0.0)
    rs = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(rs > 1e-30, residual / rs.clamp(min=1e-30), p_m)
    correction = categorical(_log(residual), generator)
    return spec_emit(props, match, correction, done, eos_token_id=eos_token_id)


def spec_chunk_rounds(draft, draft_cfg: Qwen2Config, cache, d_cache: SlotCache,
                      tokens: torch.Tensor, done: torch.Tensor,
                      generator: torch.Generator | None, *, k: int, rounds: int,
                      eos_token_id: int, nv: int, verify,
                      sampling: SamplingParams | None = None,
                      accept_sim: float | None = None):
    """``rounds`` draft / verify / accept rounds, the one round body of every spec chunk
    (JAX :244). The draft runs on its dense ``d_cache`` (its k, v) at the target cache's
    per-row ``lengths``; ``verify(cache, seq [B, k + 1]) -> (cache, logits [B, k + 1, V])``
    is the engine's target forward (a slot or a paged cache; either keeps ``lengths`` as an
    attribute that a round replaces). ``sampling`` None or greedy runs the greedy rule (``accept_sim`` optional), otherwise
    the Leviathan rule with one warp for every row. Rollback: ``lengths`` advance by each
    row's emitted count. Reads nothing back to the host.

    Returns (cache, d_cache, tokens [B], done [B], out [B, rounds (k + 1)], valid)."""
    from audio_flamingo_tpu_torch.runtime.speculative import (_log, _warped_probs,
                                                              categorical, clamp_draft_tokens,
                                                              pad_draft_probs)

    sampled = sampling is not None and not sampling.greedy
    if accept_sim is not None and sampled:
        raise ValueError("accept_sim measures the greedy rule (sampled acceptance is exact)")
    b = tokens.shape[0]
    device = tokens.device
    width = rounds * (k + 1)
    out = torch.full((b, width), eos_token_id, dtype=torch.long, device=device)
    valid = torch.zeros((b, width), dtype=torch.bool, device=device)
    d_cache.lengths = cache.lengths
    for r in range(rounds):
        # 1) the draft proposes k tokens per row at lengths .. lengths + k - 1
        tok, props, p_rows = tokens, [], []
        for i in range(k):
            x = qwen2.embed(draft, clamp_draft_tokens(tok, draft_cfg)[:, None])
            h, d_cache = _rows_forward(draft, draft_cfg, x, d_cache.lengths + i, d_cache)
            logits = qwen2.unembed(draft, h[:, 0])
            if sampled:
                p_d = _warped_probs(logits.float(), sampling)
                tok = categorical(_log(p_d), generator)
                p_rows.append(pad_draft_probs(p_d, nv))
            else:
                tok = torch.argmax(logits, dim=-1)
            props.append(tok)
        props = torch.stack(props, dim=1)                                       # [B, k]
        # 1b) the last proposal's K/V: after a full accept it is context (JAX :317-330)
        x = qwen2.embed(draft, clamp_draft_tokens(props[:, k - 1], draft_cfg)[:, None])
        _, d_cache = _rows_forward(draft, draft_cfg, x, d_cache.lengths + k, d_cache)
        # 2) the target verifies each row's k + 1 block at its own offset
        cache, logits = verify(cache, torch.cat([tokens[:, None], props], dim=1))
        # 3) per-row acceptance, correction or bonus token, EOS cut
        if sampled:
            emitted, ok, n_emitted, hit_eos = spec_sampled_accept(
                generator, _warped_probs(logits.float(), sampling), torch.stack(p_rows, 1),
                props, done, eos_token_id=eos_token_id)
        else:
            emitted, ok, n_emitted, hit_eos = spec_accept_emit(
                props, torch.argmax(logits, dim=-1), done, generator, accept_sim=accept_sim,
                eos_token_id=eos_token_id)
        cols = slice(r * (k + 1), (r + 1) * (k + 1))
        out[:, cols] = torch.where(ok, emitted, torch.full_like(emitted, eos_token_id))
        valid[:, cols] = ok
        lengths = cache.lengths + n_emitted.to(cache.lengths.dtype)
        cache.lengths = d_cache.lengths = lengths
        cur = torch.gather(emitted, 1, (n_emitted - 1).clamp(min=0)[:, None])[:, 0]
        tokens = torch.where(done | (n_emitted == 0), tokens, cur)
        done = done | hit_eos
    return cache, d_cache, tokens, done, out, valid


def _slot_verify(lm, cfg: Qwen2Config):
    """The slot engine's verify: a multi-token ``_rows_forward`` at per-row offsets (JAX
    :364)."""
    def verify(cache: SlotCache, seq: torch.Tensor):
        h, cache = _rows_forward(lm, cfg, qwen2.embed(lm, seq), cache.lengths, cache)
        return cache, qwen2.unembed(lm, h)
    return verify


@torch.inference_mode()
def decode_spec_chunk(lm, draft, cfg: Qwen2Config, draft_cfg: Qwen2Config, cache: SlotCache,
                      d_cache: SlotCache, tokens: torch.Tensor, done: torch.Tensor,
                      generator: torch.Generator | None = None, *, k: int, rounds: int,
                      eos_token_id: int, accept_sim: float | None = None):
    """Batched greedy speculation over the slots (JAX :379): ``rounds`` rounds of
    ``spec_chunk_rounds`` with the slot verify. Emitted tokens equal target-only greedy
    decoding (with ``accept_sim``, a measurement mode, they mean nothing). Returns (cache,
    d_cache, tokens, done, out [B, rounds (k + 1)], valid): ``out[b][valid[b]]`` is row b's
    stream."""
    return spec_chunk_rounds(draft, draft_cfg, cache, d_cache, tokens, done, generator, k=k,
                             rounds=rounds, eos_token_id=eos_token_id, nv=cfg.vocab_size,
                             verify=_slot_verify(lm, cfg), accept_sim=accept_sim)


@torch.inference_mode()
def decode_spec_chunk_sampled(lm, draft, cfg: Qwen2Config, draft_cfg: Qwen2Config,
                              cache: SlotCache, d_cache: SlotCache, tokens: torch.Tensor,
                              done: torch.Tensor, generator: torch.Generator | None, *,
                              k: int, rounds: int, eos_token_id: int,
                              sampling: SamplingParams):
    """Batched sampled (Leviathan) speculation over the slots (JAX :416): one warp,
    ``sampling``, for every row; the emitted law is the warped target's."""
    return spec_chunk_rounds(draft, draft_cfg, cache, d_cache, tokens, done, generator, k=k,
                             rounds=rounds, eos_token_id=eos_token_id, nv=cfg.vocab_size,
                             verify=_slot_verify(lm, cfg), sampling=sampling)


@torch.inference_mode()
def draft_prefill_into_slot(draft, draft_cfg: Qwen2Config, d_cache: SlotCache, slot: int,
                            token_ids: torch.Tensor) -> SlotCache:
    """Prefill the draft on one request's ids into row ``slot`` of its cache, in place (JAX
    :446). Text only: the draft sees the ids, not the audio. A right-padded prompt writes
    pad K/V that decode overwrites before it attends it."""
    row = qwen2.KVCache(k=d_cache.k[:, slot:slot + 1], v=d_cache.v[:, slot:slot + 1])
    pos = torch.arange(token_ids.shape[1], device=token_ids.device)[None]
    qwen2.forward(draft, draft_cfg, qwen2.embed(draft, token_ids), pos, cache=row,
                  is_prefill=True)
    return d_cache


def record_spec_stats(engine, valid: np.ndarray, active_rows, rounds: int, k: int) -> None:
    """Accumulate the live acceptance on an engine (JAX :539): each (active row, round)
    emits m + 1 tokens for m accepted proposals, so the estimate is (emitted / round slots
    - 1) / k (rounds cut by EOS count low, as production counters do). The guard: once
    ``spec_guard_warmup`` round slots were seen and the estimate sits below
    ``spec_guard_min_accept``, the engine sets ``spec_disabled`` and later chunks decode
    plainly (the same cache and rows; speculation does not change the tokens)."""
    st = getattr(engine, "spec_stats", None)
    if st is None:
        st = engine.spec_stats = {"emitted": 0, "round_slots": 0, "k": k}
    rows = list(active_rows)
    st["emitted"] += int(valid[rows].sum()) if rows else 0
    st["round_slots"] += rounds * len(rows)
    if st["round_slots"]:
        per_round = st["emitted"] / st["round_slots"]
        st["acceptance_est"] = round(max(per_round - 1.0, 0.0) / k, 4)
    if (getattr(engine, "spec_guard", True)
            and not getattr(engine, "spec_disabled", False)
            and st["round_slots"] >= getattr(engine, "spec_guard_warmup", 64)
            and st.get("acceptance_est", 1.0) < getattr(engine, "spec_guard_min_accept", 0.5)):
        engine.spec_disabled = True
        st["guard_disabled"] = True


def speculating(engine) -> bool:
    """A draft is attached, the guard has not switched it off and the engine's sampling
    has no history processor and no EOS floor (JAX ``_speculating`` / ``_spec_sampled``)."""
    sp = engine.sampling
    return (engine.draft_params is not None and not engine.spec_disabled
            and sp.repetition_penalty == 1.0 and sp.no_repeat_ngram_size == 0
            and sp.min_new_tokens == 0)


def check_spec_request(engine, req) -> None:
    """The speculative path's refusals (JAX ``submit`` :736-746)."""
    if not speculating(engine):
        return
    if req.sampling is not None:
        if engine.sampling.greedy and not (req.sampling.greedy
                                           and req.sampling.repetition_penalty == 1.0
                                           and req.sampling.no_repeat_ngram_size == 0):
            raise ValueError("the speculative engine path is greedy-only (no history warpers)")
        if not engine.sampling.greedy and req.sampling != engine.sampling:
            raise ValueError("sampled speculation applies ONE warp to every row; per-request "
                             "sampling must equal the engine's")
    if req.min_new_tokens or req.stop or req.logprobs:
        raise ValueError("min_new_tokens/stop/logprobs are not supported on the speculative "
                         "path")


def spec_step(engine, lm, cfg: Qwen2Config, chunk_fn, chunk_fn_sampled):
    """One speculative chunk of an engine (JAX ``step``'s spec branches): the greedy or the
    sampled chunk over the engine's cache and draft cache, the stats and the guard.
    Returns (out, valid) as numpy, read once."""
    kw = dict(k=engine.spec_k, rounds=engine.spec_rounds, eos_token_id=engine.eos_token_id)
    if engine.sampling.greedy:
        res = chunk_fn(lm, engine.draft_params, cfg, engine.draft_cfg, engine.cache,
                       engine.d_cache, engine.tokens, engine.done, engine.generator,
                       accept_sim=engine.spec_accept_sim, **kw)
    else:
        res = chunk_fn_sampled(lm, engine.draft_params, cfg, engine.draft_cfg, engine.cache,
                               engine.d_cache, engine.tokens, engine.done, engine.generator,
                               sampling=engine.sampling, **kw)
    engine.cache, engine.d_cache, engine.tokens, engine.done, out, valid = res
    out, valid = out.cpu().numpy(), valid.cpu().numpy()   # the chunk's one host read
    record_spec_stats(engine, valid, list(engine.active), engine.spec_rounds, engine.spec_k)
    return out, valid


@torch.inference_mode()
def prefill_into_slot(model: af3.AF3Model, cfg: AF3Config, cache: SlotCache, slot: int,
                      token_ids: torch.Tensor, mels, *, prompt_len: int | None = None):
    """Prefill ONE request (batch 1) into row ``slot`` of the cache, in place (decode
    writes every position before it attends it, so what an earlier occupant left past
    the prompt is never read). token_ids may be right-padded to a bucket with
    ``prompt_len`` the true length. Returns (cache, first-token logits [vocab])."""
    row = qwen2.KVCache(k=cache.k[:, slot:slot + 1], v=cache.v[:, slot:slot + 1])
    _, logits = gen.prefill(model, cfg, token_ids, mels, cache.k.shape[2],
                            prompt_len=prompt_len, cache=row)
    lengths = cache.lengths.clone()
    lengths[slot] = token_ids.shape[1] if prompt_len is None else prompt_len
    cache.lengths = lengths
    return cache, logits[0]


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


@dataclass
class BatchEngine:
    """Host-side scheduler over ``prefill_into_slot`` and ``decode_chunk`` (JAX
    ``BatchEngine`` :665): admit queued requests into free slots, decode every active slot
    one chunk per round, retire finished ones; beam requests advance one lane chunk per
    round. ``device=None`` means CUDA (an error without a card).

    ``draft_params`` (a ``Qwen2`` / ``QuantQwen2`` draft LM on the engine's device) with its
    ``draft_cfg`` turns on batched speculation: a greedy engine runs
    ``decode_spec_chunk`` (tokens equal the plain path's), a sampled one
    ``decode_spec_chunk_sampled`` (one warp for every row), ``spec_rounds`` rounds of
    ``spec_k`` proposals a chunk; a repetition penalty, n-gram ban or EOS floor on the
    engine keeps it on the plain path. ``spec_accept_sim`` (measurement only) injects
    Bernoulli acceptance; the guard (``spec_guard*``) turns speculation off below its
    break-even acceptance."""

    model: af3.AF3Model                # the port's AF3 model (AudioFlamingo.model)
    cfg: AF3Config
    num_slots: int = 4
    capacity: int = 2048
    chunk: int = 16
    eos_token_id: int = -1
    sampling: SamplingParams = SamplingParams()
    seed: int = 0
    draft_params: object = None        # the draft LM (Qwen2 / QuantQwen2): speculation on
    draft_cfg: Qwen2Config | None = None
    spec_k: int = 4
    spec_rounds: int = 4
    spec_accept_sim: float | None = None   # measurement: Bernoulli(a) acceptance
    spec_guard: bool = True                # switch speculation off below break-even
    spec_guard_min_accept: float = 0.5
    spec_guard_warmup: int = 64            # round slots seen before the guard acts
    spec_disabled: bool = False            # set by the guard; sticky for the engine
    metrics: object = None             # optional utils.metrics.MetricsLogger sink
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.cache = self._new_cache()
        # per-row prompt + generated ids (-1 = empty) for the history processors
        self.hist = torch.full((self.num_slots, self.capacity), -1, dtype=torch.long,
                               device=self.device)
        self.tokens = torch.full((self.num_slots,), self.eos_token_id, dtype=torch.long,
                                 device=self.device)
        self.done = torch.ones((self.num_slots,), dtype=torch.bool, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.finished: dict[str, list[int]] = {}
        self.row_params: list[SamplingParams] = [self.sampling] * self.num_slots
        self.rows = row_sampling(self.row_params, self.device)
        self.request_metrics: dict[str, dict] = {}
        self.d_cache = None
        if self.draft_params is not None:
            if self.draft_cfg is None:
                raise ValueError("draft_params needs its draft_cfg")
            self.d_cache = init_slot_cache(self.draft_cfg, self.num_slots, self.capacity,
                                           gen.compute_dtype(self.draft_params), self.device)

    def _new_cache(self) -> SlotCache:
        return init_slot_cache(self.cfg.lm, self.num_slots, self.capacity,
                               gen.compute_dtype(self.model.lm), self.device)

    def submit(self, req: Request) -> None:
        if req.ids.shape[1] > self.capacity:
            raise ValueError(f"prompt ({req.ids.shape[1]} tokens) exceeds the slot capacity "
                             f"({self.capacity})")
        check_spec_request(self, req)
        _start_request_metrics(req)
        self.queue.append(req)

    def submit_beam(self, req) -> None:
        """Queue a beam-search request (``beam_lane.BeamRequest``), served by the beam lane
        between decode rounds; results appear in ``finished_beams`` as (sequences [R,
        max_new], scores [R])."""
        beam_lane.attach_beam_lane(self).submit(req)

    @property
    def finished_beams(self) -> dict:
        return beam_lane.finished_beams(self)

    def _prefill(self, slot: int, req: Request, ids: torch.Tensor,
                 prompt_len: int | None) -> torch.Tensor:
        """Prefill a request's bucket-padded ids into row ``slot`` -> first-token logits."""
        mels = None if req.mels is None else torch.as_tensor(req.mels, device=self.device)
        self.cache, logits = prefill_into_slot(self.model, self.cfg, self.cache, slot, ids,
                                               mels, prompt_len=prompt_len)
        return logits

    def _fill_slots(self) -> None:
        for slot in range(self.num_slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            ids = torch.as_tensor(np.asarray(req.ids), dtype=torch.long, device=self.device)
            t = ids.shape[1]
            bucket = min(bucket_tokens(t), self.capacity)
            prompt_len = None
            if bucket != t:
                pad = torch.full((1, bucket - t), self.eos_token_id, dtype=torch.long,
                                 device=self.device)
                ids = torch.cat([ids, pad], dim=1)
                prompt_len = t
            logits = self._prefill(slot, req, ids, prompt_len)
            first, finished, req_sampling = _emit_first_token(self, req, logits)
            if finished:
                self.cache.lengths[slot] = 0
                continue
            self.row_params[slot] = req_sampling
            self.rows = row_sampling(self.row_params, self.device)
            self.hist = seed_history(self.hist, slot, self.capacity, req, req_sampling)
            if speculating(self):
                draft_prefill_into_slot(self.draft_params, self.draft_cfg, self.d_cache, slot,
                                        ids)
            self.tokens[slot] = first
            self.done[slot] = False
            self.active[slot] = req

    @torch.inference_mode()
    def step(self) -> None:
        """One round: admit queued requests, decode one chunk of every active slot and
        retire the finished ones, then advance the beam lane one chunk."""
        self._fill_slots()
        if not self.active:
            beam_lane.step_beam_lane(self)
            return
        if speculating(self):
            out, valid = self._spec_chunk()
            row_tokens = [out[s][valid[s]].tolist() for s in range(self.num_slots)]
            lp, budget = None, self.spec_rounds * (self.spec_k + 1)
        else:
            row_tokens, lp = self._decode_chunk()
            budget = self.chunk
        done = self.done.cpu().numpy().copy()
        lengths = self.cache.lengths.cpu().numpy()
        for slot, req in list(self.active.items()):
            if _postprocess_chunk_row(self, req, row_tokens[slot],
                                      lp[slot] if req.logprobs and lp is not None else None):
                done[slot] = True
            # capacity guard: retire a row before its writes could pass the last slot
            if lengths[slot] >= self.capacity - budget - 1:
                done[slot] = True
            if done[slot] or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                self.finished[req.request_id] = req.tokens
                _finish_request_metrics(self, req)
                del self.active[slot]
                self.done[slot] = True
                self.cache.lengths[slot] = 0
        beam_lane.step_beam_lane(self)

    def _spec_chunk(self):
        """One speculative chunk over every slot -> (out, valid), read once."""
        return spec_step(self, self.model.lm, self.cfg.lm, decode_spec_chunk,
                         decode_spec_chunk_sampled)

    def _step_fn(self):
        """The decode step the plain chunk runs: None for the LM's own (``decode_chunk``)."""
        return None

    def _decode_chunk(self):
        """The plain chunk over every slot -> (row tokens, logprobs), read once."""
        min_left = np.zeros((self.num_slots,), np.int64)
        for slot, req in self.active.items():
            want = max(req.min_new_tokens, (req.sampling or self.sampling).min_new_tokens)
            min_left[slot] = max(want - len(req.tokens), 0)
        reqs = list(self.active.values())
        use_pen, ngram_ns = processor_flags(r.sampling or self.sampling for r in reqs)
        self.cache, self.tokens, self.done, out, lp, self.hist = decode_chunk(
            self.model.lm, self.cfg.lm, self.cache, self.tokens, self.done, self.generator,
            self.rows, torch.as_tensor(min_left, device=self.device), self.hist,
            chunk=self.chunk, eos_token_id=self.eos_token_id,
            mixed_sampling=any(not (r.sampling or self.sampling).greedy for r in reqs),
            want_logprobs=any(r.logprobs for r in reqs), use_min_new=bool(min_left.any()),
            use_penalty=use_pen, ngram_ns=ngram_ns, step=self._step_fn())
        out = out.cpu().numpy()   # the chunk's one host read
        return [out[s].tolist() for s in range(self.num_slots)], lp.cpu().numpy()

    def run_until_done(self, max_rounds: int = 1000) -> dict[str, list[int]]:
        rounds = 0
        while ((self.queue or self.active or beam_lane.beam_lane_busy(self))
               and rounds < max_rounds):
            self.step()
            rounds += 1
        return self.finished
