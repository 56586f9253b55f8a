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
``runtime/beam_lane.py``); speculative decoding (``draft_params``) is not ported yet and
raises.

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

from audio_flamingo_tpu_torch.config import NOT_PORTED, AF3Config, Qwen2Config, bucket_tokens
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
                 use_min_new: bool = False, use_penalty: bool = False, ngram_ns: tuple = ()):
    """Advance every slot ``chunk`` steps, reading nothing back to the host. rows: per-row
    sampling parameters; min_left [B]: tokens still under the EOS floor; hist [B, H]:
    prompt + generated ids (-1 elsewhere) for the repetition penalty and the n-gram ban,
    kept across chunks (row b holds lengths[b] + 1 ids: the cache lags by the token not
    yet forwarded). A done row keeps its length and emits EOS.

    Returns (cache, tokens [B], done [B], out [B, chunk], logprobs [B, chunk] f32, hist)."""
    b = tokens.shape[0]
    device = tokens.device
    out = torch.full((b, chunk), eos_token_id, dtype=torch.long, device=device)
    lp = torch.zeros((b, chunk), dtype=torch.float32, device=device)
    if hist is None:
        hist = torch.full((b, 8), -1, dtype=torch.long, device=device)   # processors off
    for i in range(chunk):
        x = qwen2.embed(lm, tokens[:, None])
        h, cache = _rows_forward(lm, cfg, x, cache.lengths, cache)
        logits = qwen2.unembed(lm, h[:, 0])
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
    round. ``device=None`` means CUDA (an error without a card)."""

    model: af3.AF3Model                # the port's AF3 model (AudioFlamingo.model)
    cfg: AF3Config
    num_slots: int = 4
    capacity: int = 2048
    chunk: int = 16
    eos_token_id: int = -1
    sampling: SamplingParams = SamplingParams()
    seed: int = 0
    draft_params: object = None        # speculative decoding: not ported yet
    draft_cfg: object = None
    metrics: object = None             # optional utils.metrics.MetricsLogger sink
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.draft_params is not None or self.draft_cfg is not None:
            raise NotImplementedError(NOT_PORTED.format(
                "speculative slot serving (draft_params)", "4, speculative decoding"))
        self.device = resolve_device(self.device)
        self.cache = init_slot_cache(self.cfg.lm, self.num_slots, self.capacity,
                                     gen.compute_dtype(self.model.lm), self.device)
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

    def submit(self, req: Request) -> None:
        if req.ids.shape[1] > self.capacity:
            raise ValueError(f"prompt ({req.ids.shape[1]} tokens) exceeds the slot capacity "
                             f"({self.capacity})")
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
            mels = None if req.mels is None else torch.as_tensor(req.mels, device=self.device)
            self.cache, logits = prefill_into_slot(self.model, self.cfg, self.cache, slot, ids,
                                                   mels, prompt_len=prompt_len)
            first, finished, req_sampling = _emit_first_token(self, req, logits)
            if finished:
                self.cache.lengths[slot] = 0
                continue
            self.row_params[slot] = req_sampling
            self.rows = row_sampling(self.row_params, self.device)
            self.hist = seed_history(self.hist, slot, self.capacity, req, req_sampling)
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
            use_penalty=use_pen, ngram_ns=ngram_ns)
        # the chunk's one host read
        out, lp = out.cpu().numpy(), lp.cpu().numpy()
        done = self.done.cpu().numpy().copy()
        lengths = self.cache.lengths.cpu().numpy()
        for slot, req in list(self.active.items()):
            if _postprocess_chunk_row(self, req, out[slot].tolist(),
                                      lp[slot] if req.logprobs else None):
                done[slot] = True
            # capacity guard: retire a row before its writes could pass the last slot
            if lengths[slot] >= self.capacity - self.chunk - 1:
                done[slot] = True
            if done[slot] or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                self.finished[req.request_id] = req.tokens
                _finish_request_metrics(self, req)
                del self.active[slot]
                self.done[slot] = True
                self.cache.lengths[slot] = 0
        beam_lane.step_beam_lane(self)

    def run_until_done(self, max_rounds: int = 1000) -> dict[str, list[int]]:
        rounds = 0
        while ((self.queue or self.active or beam_lane.beam_lane_busy(self))
               and rounds < max_rounds):
            self.step()
            rounds += 1
        return self.finished
