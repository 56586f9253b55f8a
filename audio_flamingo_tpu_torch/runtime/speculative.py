"""Speculative decoding, as ``audio_flamingo_tpu/runtime/speculative.py``: a small draft LM
proposes k tokens, the target verifies them in one (k + 1)-token forward, so one stream of
the target's weights yields up to k + 1 tokens. Greedy output equals target-only greedy
decoding; sampled output (Leviathan et al.) has the warped target's law.

JAX runs the propose / verify / rollback loop in one ``lax.while_loop``. Here its body is
one round function, ``spec_body``, in place on fixed tensors (``SpecState``): the k draft
steps, the last proposal's draft-KV write, the verify, the accept rule and the ``out`` /
``n_out`` / ``done`` / position bookkeeping. It reads nothing back to the host.

- On a CUDA device the round is captured once per key in a CUDA graph
  (``generate.DecodeGraph`` with this body, held by ``generate.hold`` beside generate's and
  the beam's steps) and replayed; the host reads ``done`` every ``SYNC_EVERY`` rounds. On
  the CPU the same function runs eagerly.
- Rollback moves only the device index of both caches (target and draft) to the accepted
  position: rejected slots lie past it, are never attended (the mask is ``kv_pos <=
  position``) and are overwritten later. The host's count (``host_index``, read by the
  capacity check of ``qwen2.forward``) is kept at the worst case the capacity was sized
  for, ``ceil((t + max_new + k + 1) / 128) 128`` as JAX allocates it, which
  ``generate_speculative`` checks up front.
- A round after ``done`` changes no tensor: it runs at position 0, puts back the cache
  slots it wrote and gates every other write, so the rounds the host runs past the end
  (up to ``SYNC_EVERY - 1``) leave the answer as it was.

Batch 1, no repetition penalty (the verify cannot apply a history-dependent warp); the
engines (``runtime/engine.py``, ``runtime/paged_engine.py``) serve batched speculation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import torch

from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams, apply_top_k, apply_top_p
from audio_flamingo_tpu_torch.runtime import engine
from audio_flamingo_tpu_torch.runtime import generate as gen


def categorical(logp: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row of [..., V] log-probabilities (Gumbel-max, as ``sample_token``)."""
    u = torch.rand(logp.shape, generator=generator, device=logp.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
    return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)


def _log(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p.clamp(min=1e-30))


def speculative_accept(p_target: torch.Tensor, p_draft: torch.Tensor, proposed: torch.Tensor,
                       generator: torch.Generator | None = None):
    """One-token speculative sampling (JAX :26): accept ``proposed`` with probability
    min(1, p_t[x] / p_d[x]), else resample from the renormalized residual max(p_t - p_d,
    0). The returned token's law is exactly p_target. p_target, p_draft [V]; proposed []
    (or any shape: one independent trial per entry). Returns (token, accepted)."""
    ratio = p_target[proposed] / p_draft[proposed].clamp(min=1e-30)
    u = torch.rand(proposed.shape, generator=generator, device=p_target.device,
                   dtype=torch.float32)
    accept = u < ratio.clamp(max=1.0)
    residual = (p_target - p_draft).clamp(min=0.0)
    residual = residual / residual.sum().clamp(min=1e-30)
    resampled = categorical(_log(residual).expand(*proposed.shape, residual.shape[0]),
                            generator)
    return torch.where(accept, proposed, resampled), accept


def _warped_probs(logits: torch.Tensor, sampling: SamplingParams) -> torch.Tensor:
    """The sampling pipeline's warp (temperature, top-k, top-p) as probabilities (JAX :45).
    Draft and target must be warped alike for the acceptance rule to keep the target's
    law."""
    lg = logits / max(sampling.temperature, 1e-6)
    lg = apply_top_k(lg, sampling.top_k)
    lg = apply_top_p(lg, sampling.top_p)
    return torch.softmax(lg, dim=-1)


def clamp_draft_tokens(tok: torch.Tensor, draft_cfg: Qwen2Config) -> torch.Tensor:
    """Token ids clamped to the draft's vocabulary before they enter the draft (JAX :57): the
    target may emit ids the draft's embedding has no row for (Qwen2.5-0.5B has 151,936
    rows, the 7B 152,064). The law stays exact: the recorded q is the draft's own."""
    return tok.clamp(max=draft_cfg.vocab_size - 1)


def pad_draft_probs(p_d: torch.Tensor, nv: int) -> torch.Tensor:
    """Draft probabilities [..., dv] zero-padded to the target's vocabulary nv (JAX :69):
    q = 0 past the draft's vocabulary keeps the rule exact (the draft never proposes such a
    token; on a rejection the residual there is p_t)."""
    dv = p_d.shape[-1]
    if dv == nv:
        return p_d
    if dv > nv:
        raise ValueError(f"draft vocab {dv} exceeds target vocab {nv}")
    return torch.nn.functional.pad(p_d, (0, nv - dv))


def _forward_tokens(lm, cfg: Qwen2Config, cache: qwen2.KVCache, tokens: torch.Tensor,
                    start: torch.Tensor):
    """``tokens`` [1, n] at positions start.. (``start`` a 0-dim device tensor) -> logits
    [1, n, vocab] f32 (JAX :244). The cache's device index is set to ``start`` and left at
    start + n; its host count is kept at the worst case (module docstring)."""
    n = tokens.shape[1]
    cache.index.copy_(start)
    cache.host_index = cache.capacity - n
    embeds = qwen2.embed(lm, tokens)
    pos = (start + torch.arange(n, device=tokens.device))[None]
    h, _ = qwen2.forward(lm, cfg, embeds, pos, cache=cache)
    return qwen2.unembed(lm, h)


# ----------------------------------------------------------------------------------------
# The round: JAX's while_loop body on fixed tensors


class SpecSpec(NamedTuple):
    """What fixes a round's ops besides the shapes."""

    k: int
    max_new_tokens: int
    eos_token_id: int = -1
    sampling: SamplingParams = SamplingParams()


@dataclass
class SpecState:
    """The tensors one round reads and writes in place (JAX's ``SpecState`` /
    ``SpecSampleState``), on the target's device."""

    t_cache: qwen2.KVCache
    d_cache: qwen2.KVCache
    cur: torch.Tensor        # [1] int64: the last accepted token (emitted, not yet fed)
    position: torch.Tensor   # [] int64: the next position to write (tokens in context)
    out: torch.Tensor        # [1, max_new + k + 1] int64, EOS where nothing was emitted
    n_out: torch.Tensor      # [] int64: tokens emitted
    done: torch.Tensor       # [] bool
    rounds: torch.Tensor     # [] int64: rounds that ran before done
    p_d: torch.Tensor | None             # [k, V] f32: a sampled round's padded draft law
    generator: torch.Generator | None = None

    @property
    def cache(self) -> qwen2.KVCache:
        """The target's cache (``DecodeGraph`` reads its device)."""
        return self.t_cache

    def nbytes(self) -> dict:
        caches = sum(t.numel() * t.element_size() for c in (self.t_cache, self.d_cache)
                     for t in (c.k, c.v, c.index))
        rest = sum(t.numel() * t.element_size() for t in (
            self.cur, self.position, self.out, self.n_out, self.done, self.rounds, self.p_d)
            if t is not None)
        return dict(cache=caches, state=rest)


def new_state(cfg: Qwen2Config, draft_cfg: Qwen2Config, spec: SpecSpec, capacity: int,
              dtype: torch.dtype, draft_dtype: torch.dtype, device,
              generator: torch.Generator | None = None) -> SpecState:
    """A state with both caches (each LM's compute dtype) and every other tensor on device."""
    long = dict(dtype=torch.long, device=device)
    sampled = not spec.sampling.greedy
    return SpecState(
        t_cache=qwen2.init_cache(cfg, 1, capacity, dtype, device),
        d_cache=qwen2.init_cache(draft_cfg, 1, capacity, draft_dtype, device),
        cur=torch.zeros(1, **long), position=torch.zeros((), **long),
        out=torch.full((1, spec.max_new_tokens + spec.k + 1), spec.eos_token_id, **long),
        n_out=torch.zeros((), **long), done=torch.zeros((), dtype=torch.bool, device=device),
        rounds=torch.zeros((), **long),
        p_d=(torch.zeros((spec.k, cfg.vocab_size), dtype=torch.float32, device=device)
             if sampled else None),
        generator=generator)


def spec_body(lm, cfg: Qwen2Config, draft, draft_cfg: Qwen2Config, spec: SpecSpec,
              st: SpecState) -> None:
    """One round of JAX's speculative ``while_loop`` body (greedy :294-354, sampled
    :153-227), in place on ``st`` and gated on ``~st.done``: the draft proposes k tokens
    from ``cur`` at ``position`` (argmax, or a draw from its warped law, recorded padded to
    the target's vocabulary), writes the last proposal's K/V, the target verifies [cur,
    proposals] in one forward, the accepted prefix and the correction (or bonus) token are
    written to ``out`` up to the first EOS, and both caches' index, ``position``, ``n_out``,
    ``cur`` and ``done`` move on. Reads nothing back to the host."""
    k, eos, sp = spec.k, spec.eos_token_id, spec.sampling
    sampled = not sp.greedy
    device = st.cur.device
    ar = torch.arange(k + 1, device=device)
    go = ~st.done
    # a round after done runs at position 0 and puts back every cache slot it wrote
    pos = torch.where(go, st.position, torch.zeros_like(st.position))
    slots = pos + ar
    bufs = (st.t_cache.k, st.t_cache.v, st.d_cache.k, st.d_cache.v)
    saved = [buf.index_select(2, slots) for buf in bufs]

    # 1) the draft proposes k tokens at positions pos .. pos + k - 1
    tok, props = st.cur, []
    for i in range(k):
        logits = _forward_tokens(draft, draft_cfg, st.d_cache,
                                 clamp_draft_tokens(tok, draft_cfg)[:, None], pos + i)[:, 0]
        if sampled:
            p_d = _warped_probs(logits.float(), sp)                          # [1, Vd]
            tok = categorical(_log(p_d), st.generator)
            st.p_d[i] = pad_draft_probs(p_d, cfg.vocab_size)[0]
        else:
            tok = torch.argmax(logits, dim=-1)
        props.append(tok)
    props = torch.cat(props)                                                 # [k]
    # the last proposal's K/V (the k steps never fed it): after a full accept it is
    # context, and its slot would otherwise stay garbage (JAX :169-175, :300-305)
    _forward_tokens(draft, draft_cfg, st.d_cache,
                    clamp_draft_tokens(props[k - 1:], draft_cfg)[None], pos + k)

    # 2) the target verifies [cur, p_0 .. p_{k-1}] in one forward
    t_logits = _forward_tokens(lm, cfg, st.t_cache, torch.cat([st.cur, props])[None], pos)[0]

    # 3) the accept rule and the emit mask: the engines' batched rules at B = 1 (the mask
    # gated on done, cut after the first EOS)
    if sampled:
        emitted, valid, n_emitted, hit_eos = engine.spec_sampled_accept(
            st.generator, _warped_probs(t_logits.float(), sp)[None], st.p_d[None],
            props[None], st.done[None], eos_token_id=eos)
    else:
        emitted, valid, n_emitted, hit_eos = engine.spec_accept_emit(
            props[None], torch.argmax(t_logits, dim=-1)[None], st.done[None], None,
            accept_sim=None, eos_token_id=eos)
    emitted, valid, n_emitted, hit_eos = emitted[0], valid[0], n_emitted[0], hit_eos[0]

    # 4) write the emitted tokens to out and move the bookkeeping on
    at = (st.n_out + ar).clamp(max=st.out.shape[1] - 1)[None]
    st.out.scatter_(1, at, torch.where(valid, emitted, st.out.gather(1, at)[0])[None])
    cur = emitted.index_select(0, (n_emitted - 1).clamp(min=0, max=k).view(1))
    st.cur.copy_(torch.where(go, cur, st.cur))
    st.position.add_(n_emitted)
    st.n_out.add_(n_emitted)
    st.rounds.add_(go.long())
    st.done.copy_(st.done | hit_eos | (st.n_out >= spec.max_new_tokens))
    for cache in (st.t_cache, st.d_cache):
        cache.index.copy_(st.position)
    for buf, old in zip(bufs, saved):
        buf.index_copy_(2, slots, torch.where(go, buf.index_select(2, slots), old))


def begin(st: SpecState, spec: SpecSpec, first: torch.Tensor, t: int) -> None:
    """Start a sequence after both prefills: token 0 (``first`` [1]) emitted, fed next at
    position t."""
    st.cur.copy_(first)
    st.position.fill_(t)
    st.out.fill_(spec.eos_token_id)
    st.out[:, 0] = first
    st.n_out.fill_(1)
    st.rounds.zero_()
    st.done.copy_((first[0] == spec.eos_token_id) | torch.tensor(spec.max_new_tokens <= 1,
                                                                device=first.device))
    for cache in (st.t_cache, st.d_cache):
        cache.index.fill_(t)


def start(model: af3.AF3Model, cfg: AF3Config, draft, draft_cfg: Qwen2Config, spec: SpecSpec,
          st: SpecState, token_ids: torch.Tensor, mels: torch.Tensor | None,
          generator: torch.Generator | None) -> torch.Tensor:
    """Both prefills into the state's caches (the target on the prompt and audio, the
    draft on the ids alone), the first token from the target's last logits (argmax, or a
    draw from its warped law), then ``begin``. Returns the prefill logits [1, V] f32."""
    t = token_ids.shape[1]
    _, t_logits = gen.prefill(model, cfg, token_ids, mels, st.t_cache.capacity,
                              cache=st.t_cache)
    st.d_cache.rewind(0)
    pos = torch.arange(t, device=token_ids.device)[None]
    qwen2.forward(draft, draft_cfg, qwen2.embed(draft, token_ids), pos, cache=st.d_cache,
                  is_prefill=True)
    if spec.sampling.greedy:
        first = torch.argmax(t_logits, dim=-1)
    else:
        first = categorical(_log(_warped_probs(t_logits.float(), spec.sampling)), generator)
    begin(st, spec, first, t)
    return t_logits


def finish(out: torch.Tensor, n_out: torch.Tensor, max_new: int, eos: int):
    """JAX's normalization (:356-366): the first max_new tokens, EOS past n_out and past
    the first EOS -> (tokens [1, max_new], lengths [1])."""
    out = out[:, :max_new]
    lengths = n_out.clamp(max=max_new).view(1)
    pos_ids = torch.arange(max_new, device=out.device)[None]
    out = torch.where(pos_ids < lengths[:, None], out, torch.full_like(out, eos))
    eos_cut = torch.cumsum((out == eos).long(), dim=1)
    keep = (eos_cut == 0) | ((out == eos) & (eos_cut == 1))
    out = torch.where(keep, out, torch.full_like(out, eos))
    n_kept = ((torch.cumsum((out == eos).long(), dim=1) == 0).sum(dim=1)
              + (out == eos).any(dim=1).long())
    return out, n_kept.clamp(max=max_new)


# ----------------------------------------------------------------------------------------
# The generation loop


@dataclass
class SpecOutput:
    tokens: torch.Tensor     # [1, max_new_tokens] int64
    lengths: torch.Tensor    # [1] int64
    rounds: int              # rounds that emitted (before done)
    emitted: int             # tokens the rounds emitted (n_out - 1)
    ttft_s: float            # both prefills and the first token, device-synchronized
    decode_s: float          # the rounds, device-synchronized
    rounds_run: int          # rounds run, up to SYNC_EVERY - 1 past done
    capture_s: float = 0.0   # this call's capture of the round (0 when a held one was reused)

    @property
    def acceptance(self) -> float:
        """Accepted proposals over proposals: each round emits m + 1 tokens for m accepted
        (a round cut by EOS or the budget counts low)."""
        return max(self.emitted - self.rounds, 0) / max(self.rounds * self.k, 1)

    k: int = 4


def spec_key(lm, cfg: Qwen2Config, draft, draft_cfg: Qwen2Config, spec: SpecSpec,
             capacity: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """What fixes a captured round: both LMs' weights (addresses, shapes, dtypes), configs,
    the spec, the capacity, the dtype and the device."""
    return ("speculative", gen.graph_key(lm, cfg, spec, 1, capacity, dtype, device),
            gen.graph_key(draft, draft_cfg, spec, 1, capacity, gen.compute_dtype(draft), device))


def _check_draft(cfg: AF3Config, draft_cfg: Qwen2Config, k: int) -> None:
    if draft_cfg.vocab_size > cfg.lm.vocab_size:
        raise ValueError(f"draft vocab {draft_cfg.vocab_size} exceeds target vocab "
                         f"{cfg.lm.vocab_size}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


@torch.inference_mode()
def generate_speculative(model: af3.AF3Model, cfg: AF3Config, draft, draft_cfg: Qwen2Config,
                         token_ids: torch.Tensor, mels: torch.Tensor | None = None, *,
                         k: int = 4, max_new_tokens: int = 64, capacity: int = 0,
                         eos_token_id: int = -1, sampling: SamplingParams = SamplingParams(),
                         generator: torch.Generator | None = None) -> SpecOutput:
    """Speculative generation at batch 1 (JAX ``generate_speculative`` :260 with a greedy
    ``sampling``, ``generate_speculative_sampled`` :100 otherwise; no repetition penalty).
    token_ids [1, T] (the exact prompt) + mels; the draft (``Qwen2`` or ``QuantQwen2``)
    sees the same ids, text only. Greedy tokens equal target-only greedy decoding; sampled
    ones have the warped target's law. On a CUDA device the round replays a captured graph;
    on the CPU it runs eagerly."""
    b, t = token_ids.shape
    if b != 1:
        raise ValueError(f"speculative decoding drives batch 1, got {b} rows")
    if sampling.repetition_penalty != 1.0:
        raise ValueError("speculative decoding takes no repetition penalty")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    _check_draft(cfg, draft_cfg, k)
    need = t + max_new_tokens + k + 1
    if capacity == 0:
        capacity = -(-need // 128) * 128
    elif capacity < need:
        raise ValueError(f"KV cache of {capacity} slots cannot take a prompt of {t} tokens, "
                         f"{max_new_tokens} new tokens and a round of {k + 1}")
    device = token_ids.device
    spec = SpecSpec(k, max_new_tokens, eos_token_id,
                    sampling._replace(min_new_tokens=0, no_repeat_ngram_size=0))
    dtype, d_dtype = gen.compute_dtype(model.lm), gen.compute_dtype(draft)
    lm, lcfg = model.lm, cfg.lm

    def body(lm_, cfg_, spec_, st_):
        spec_body(lm_, cfg_, draft, draft_cfg, spec_, st_)

    graph, capture_s = None, 0.0
    if device.type == "cuda":
        t0 = time.perf_counter()

        def make():
            g = None if spec.sampling.greedy else torch.Generator(device=device)
            return gen.DecodeGraph(lm, lcfg, spec,
                                   new_state(lcfg, draft_cfg, spec, capacity, dtype, d_dtype,
                                             device, g),
                                   body=body)
        graph, captured = gen.hold(spec_key(lm, lcfg, draft, draft_cfg, spec, capacity, dtype,
                                            device), make)
        capture_s = time.perf_counter() - t0 if captured else 0.0
        graph.busy = True
        st = graph.state
    else:
        st = new_state(lcfg, draft_cfg, spec, capacity, dtype, d_dtype, device, generator)
    try:
        t0 = time.perf_counter()
        start(model, cfg, draft, draft_cfg, spec, st, token_ids, mels, generator)
        if graph is not None:
            graph.load_generator(generator)
        gen.sync(device)
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        rounds_run = 0
        step = graph.replay if graph is not None else (lambda: body(lm, lcfg, spec, st))
        while rounds_run + 1 < max_new_tokens and not bool(st.done):
            n = min(gen.SYNC_EVERY, max_new_tokens - 1 - rounds_run)
            for _ in range(n):
                step()
            rounds_run += n
        gen.sync(device)
        decode_s = time.perf_counter() - t1
        tokens, lengths = finish(st.out, st.n_out, max_new_tokens, eos_token_id)
        rounds, emitted = int(st.rounds), int(st.n_out) - 1
    finally:
        if graph is not None:
            graph.store_generator(generator)
            graph.busy = False
    return SpecOutput(tokens=tokens, lengths=lengths, rounds=rounds, emitted=emitted,
                      ttft_s=ttft, decode_s=decode_s, rounds_run=rounds_run,
                      capture_s=capture_s, k=k)
