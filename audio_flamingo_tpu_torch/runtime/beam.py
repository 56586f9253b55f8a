"""Beam search, as ``audio_flamingo_tpu/runtime/beam.py``: HF ``_beam_search`` semantics
(the 2K-candidate rule, the running beams, the length-penalised merge of finished beams,
the early-stop heuristic), f32 log-softmax scores, the first beam at 0 and the others at
``NEG`` so that step 0 expands only beam 0.

Beams ride the batch axis: row ``b * K + k`` of the KV cache is beam k of prompt b, one
decode step serves every beam, and the reorder by surviving parent is a row gather on the
cache. The beam runs on a bf16 or f32 ``KVCache`` (the ``Q8KVCache`` is not offered, as
in JAX).

JAX's ``_beam_fns`` body is one step function here, ``beam_body``, in place on a
``BeamState`` of fixed tensors (its cache's index, the step and the true prompt length on
the device); it reads nothing back to the host. JAX's ``while_loop`` runs no body once
``alive`` is false; a graph cannot branch, so every update of the body is gated on
``alive``: a step after the search ended leaves the state exactly as it was (the cache's
slot it decodes into is put back). The host reads ``alive`` every ``SYNC_EVERY`` steps and
never runs more than ``max_new_tokens`` steps, which is where the search ends at the
latest.

- On a CUDA device the step is captured once in a CUDA graph (``generate.DecodeGraph``
  over ``beam_body``) and replayed.
  The graph holds its state, cache included, under ``runtime/generate``'s held steps (at
  most ``MAX_HELD``, ``release_graphs``); its key is the LM's weights, the batch, the
  capacity, the dtype and the options JAX makes static (``BeamSpec``). The prompt length
  is a device tensor, so prompts of one capacity share a graph. A sampled step draws its
  Gumbel noise from a generator registered with the graph.
- On the CPU the same body runs eagerly.

Every top-k of the body orders equal values as ``jax.lax.top_k`` does, the lower index
first (``top_k``); ``torch.topk`` promises no order among ties, and ties are common here:
at step 0 every candidate of beams 1..K-1 rounds to exactly NEG, and in the finished merge
the old slots and the candidates that may not finish tie near NEG. Where JAX divides by a
constant, XLA multiplies by its f32 reciprocal, and so does the body.

``beam_open`` / ``beam_advance`` are the engines' pausable pair (``runtime/beam_lane.py``):
chunks only partition the steps, so a request's result equals ``generate_beam``'s.

The AF1/AF2 family (``generate_beam_xattn``, ``beam_open_xattn``, ``beam_advance_xattn``)
runs the same body over the flamingo stack's decode step (``models/flamingo.decode_step``):
the transformed media are expanded across the beams once, into a buffer of the state
(``BeamState.media``, row b * K + k), and never reordered, since every beam of a prompt
attends the same media. On the card that step is captured as well (``xattn_beam_body``),
its key holding the media's shape.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF2Config, AF3Config, Qwen2Config
from audio_flamingo_tpu_torch.models import af3, flamingo, qwen2
from audio_flamingo_tpu_torch.ops.sampling import apply_no_repeat_ngram
from audio_flamingo_tpu_torch.runtime import generate as gen

NEG = -1.0e9


class BeamSpec(NamedTuple):
    """What fixes a beam step's ops besides the shapes (JAX's static arguments)."""

    num_beams: int
    max_new_tokens: int
    eos_token_id: int
    length_penalty: float = 1.0
    early_stopping: bool | str = False    # False (the heuristic), True or "never"
    min_new_tokens: int = 0
    no_repeat_ngram_size: int = 0
    do_sample: bool = False
    temperature: float = 1.0


@dataclass
class BeamState:
    """The tensors one beam step reads and writes in place (JAX's ``BeamState``)."""

    i: torch.Tensor          # [] int64: steps taken
    t: torch.Tensor          # [] int64: the true prompt length
    cache: qwen2.KVCache     # B * K rows, row b * K + k beam k of prompt b
    logits: torch.Tensor     # [B * K, V] f32: the next step's logits
    run_seq: torch.Tensor    # [B, K, max_new] int64
    run_sc: torch.Tensor     # [B, K] f32
    fin_seq: torch.Tensor    # [B, K, max_new] int64
    fin_sc: torch.Tensor     # [B, K] f32
    is_fin: torch.Tensor     # [B, K] bool
    heur_ok: torch.Tensor    # [B, 1] bool: the early-stop heuristic's gate
    alive: torch.Tensor      # [] bool
    hist: torch.Tensor       # [B * K, capacity] int64: prompt and generated ids at their
                             # positions, for the n-gram ban ([B * K, 1] without it)
    generator: torch.Generator | None = None
    media: torch.Tensor | None = None   # AF1/AF2: [B * K, S, d_audio], row b * K + k

    def nbytes(self) -> dict:
        """Bytes of the cache and of the rest of the state."""
        cache = sum(t.numel() * t.element_size() for t in vars(self.cache).values()
                    if isinstance(t, torch.Tensor))
        rest = sum(t.numel() * t.element_size() for t in (
            self.i, self.t, self.logits, self.run_seq, self.run_sc, self.fin_seq, self.fin_sc,
            self.is_fin, self.heur_ok, self.alive, self.hist, self.media) if t is not None)
        return dict(cache=cache, state=rest)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of f32 ``x`` and their indices, largest first,
    equal values lower index first (``jax.lax.top_k``'s order). Each entry becomes one
    int64 key, its order-preserving bits above its inverted index, so no two keys tie."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32)
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).long()
    key = ordered * (1 << 32) + ((1 << 32) - 1 - torch.arange(n, device=x.device))
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def _take_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, L] gathered along axis 1 by idx [B, k] ([hf] _gather_beams)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _recip(c: float) -> float:
    """The f32 reciprocal of the f32 constant c, by which XLA multiplies for x / c."""
    return float(np.float32(1.0) / np.float32(c))


def new_beam_state(cfg: Qwen2Config | AF2Config, spec: BeamSpec, batch: int, capacity: int,
                   dtype: torch.dtype, device: torch.device,
                   generator: torch.Generator | None = None,
                   media_shape: tuple | None = None) -> BeamState:
    """A state of ``batch`` prompts, not alive (no step changes it until ``begin``). For
    the AF1/AF2 stack ``cfg`` is its ``AF2Config`` and ``media_shape`` (S, d_audio) the
    transformed media's, a zeroed buffer of B * K rows."""
    k = spec.num_beams
    long = dict(dtype=torch.long, device=device)
    seq = torch.zeros((batch, k, spec.max_new_tokens), **long)
    width = capacity if spec.no_repeat_ngram_size > 0 else 1
    if media_shape is None:
        cache = qwen2.init_cache(cfg, batch * k, capacity, dtype, device)
        vocab, media = cfg.vocab_size, None
    else:
        cache = flamingo._init_cache(cfg, batch * k, capacity, dtype, device)
        vocab = cfg.lm.vocab_size
        media = torch.zeros((batch * k, *media_shape), dtype=dtype, device=device)
    return BeamState(
        i=torch.zeros((), **long), t=torch.zeros((), **long), cache=cache,
        logits=torch.zeros((batch * k, vocab), dtype=torch.float32, device=device),
        run_seq=seq, run_sc=torch.zeros((batch, k), device=device), fin_seq=seq.clone(),
        fin_sc=torch.zeros((batch, k), device=device),
        is_fin=torch.zeros((batch, k), dtype=torch.bool, device=device),
        heur_ok=torch.ones((batch, 1), dtype=torch.bool, device=device),
        alive=torch.zeros((), dtype=torch.bool, device=device),
        hist=torch.zeros((batch * k, width), **long), generator=generator, media=media)


def begin(st: BeamState, spec: BeamSpec, first_logits: torch.Tensor, cache: qwen2.KVCache,
          prompt_len: int, prompt_tokens: torch.Tensor,
          media: torch.Tensor | None = None) -> None:
    """JAX's ``beam_state_init`` into ``st``: the prefill's B-row cache copied to every
    beam's row, its logits [B, V] to every beam, beam 0 at score 0 and the rest at NEG,
    nothing finished, alive. ``prompt_tokens`` [B, T] (T may include bucket padding).
    ``media`` [B, S, d] (AF1/AF2): copied to every beam's row of the state's buffer."""
    b, k = st.run_sc.shape
    capacity = st.cache.capacity
    if cache.capacity != capacity or prompt_tokens.shape[1] > capacity:
        raise ValueError(f"a prefill of {cache.capacity} slots for a beam cache of {capacity}")
    if (media is None) != (st.media is None):
        raise ValueError("an AF1/AF2 beam state takes the prefill's media, an AF3 one none")
    for dst, src in ((st.cache.k, cache.k), (st.cache.v, cache.v)):
        dst.view(dst.shape[0], b, k, *dst.shape[2:]).copy_(src[:, :, None])
    if media is not None:
        st.media.view(b, k, *st.media.shape[1:]).copy_(media[:, None])
    st.cache.rewind(prompt_len)
    st.logits.view(b, k, -1).copy_(first_logits[:, None])
    pad = spec.eos_token_id if spec.eos_token_id >= 0 else 0
    st.run_seq.fill_(pad)
    st.run_sc.zero_()
    st.run_sc[:, 1:] = NEG
    st.fin_seq.fill_(pad)
    st.fin_sc.fill_(NEG)
    st.is_fin.zero_()
    st.heur_ok.fill_(True)
    st.alive.fill_(True)
    st.i.zero_()
    st.t.fill_(prompt_len)
    if spec.no_repeat_ngram_size > 0:
        st.hist.zero_()
        st.hist.view(b, k, -1)[:, :, : prompt_tokens.shape[1]] = prompt_tokens.long()[:, None]


def beam_body(lm, cfg: Qwen2Config, spec: BeamSpec, st: BeamState,
              model_step=None) -> None:
    """One step of JAX's beam ``while_loop`` body (audio_flamingo_tpu/runtime/beam.py
    :110-199), in place on ``st`` and gated on ``st.alive``: f32 log-softmax, the n-gram
    ban over ``hist``, the EOS floor and the temperature; the top-2K candidates over
    [B, K * V] (Gumbel-top-k when sampling); the K running beams; the length-penalised
    merge of finished beams through a top-K of 3K; the cache rows reordered by surviving
    parent and ``cur_tok`` decoded at ``t + i`` (``generate.decode_step``, JAX's
    ``_af3_decode_fn``); the history reordered; the early-stop heuristic and ``alive``.
    Reads nothing back to the host. ``model_step(cache, tokens, position)`` -> [B * K, V]
    f32 logits replaces the LM's decode step (``xattn_beam_body``)."""
    k = spec.num_beams
    k2 = 2 * k
    eos, max_new, pen = spec.eos_token_id, spec.max_new_tokens, spec.length_penalty
    b = st.run_seq.shape[0]
    vocab = st.logits.shape[-1]
    device = st.logits.device
    go, i, t = st.alive, st.i, st.t

    lp = torch.log_softmax(st.logits, dim=-1)
    if spec.no_repeat_ngram_size > 0:
        # [hf] applies the processor to each running beam's log-probs before selection
        lp = apply_no_repeat_ngram(lp, st.hist, t + i, spec.no_repeat_ngram_size)
    if spec.min_new_tokens > 0 and eos >= 0:
        lp[:, eos] = torch.where(i < spec.min_new_tokens, torch.full_like(lp[:, eos], NEG),
                                 lp[:, eos])
    if spec.do_sample and spec.temperature != 1.0:
        lp = lp * _recip(max(spec.temperature, 1e-6))   # [hf] warpers run on the log-probs
    acc = (lp.view(b, k, vocab) + st.run_sc[:, :, None]).view(b, k * vocab)

    # top-2K candidates across all beams; sampling draws them without replacement from
    # softmax(acc) by the Gumbel-top-k trick, scores staying acc
    if spec.do_sample:
        u = torch.rand(acc.shape, generator=st.generator, device=device, dtype=torch.float32)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
        idx = top_k(acc - torch.log(-torch.log(u)), k2)[1]
        cand_sc = torch.gather(acc, 1, idx)
    else:
        cand_sc, idx = top_k(acc, k2)
    parent = torch.div(idx, vocab, rounding_mode="floor")
    tok = idx - parent * vocab
    # past the end (i = max_new) every write is gated off; the clamps keep its indices in
    # range (a step that may run, i < max_new, is not changed by them)
    cand_seq = _take_beams(st.run_seq, parent)
    cand_seq.scatter_(2, i.clamp(max=max_new - 1).expand(b, k2, 1), tok[:, :, None])
    hits = (tok == eos) | (i + 1 >= max_new)

    # the next running beams: the best K that did not finish
    new_run_sc, keep = top_k(cand_sc + hits.float() * NEG, k)
    new_run_seq = _take_beams(cand_seq, keep)
    parent_keep = torch.gather(parent, 1, keep)
    cur_tok = torch.gather(tok, 1, keep)

    # finished: length penalty over the generated length, only the top-K ranks may
    # finish, merged with the old ones through a top-K of 3K
    flp = cand_sc / (i + 1.0) ** pen
    if spec.early_stopping is True:
        flp = flp + st.is_fin.all(dim=1, keepdim=True).float() * NEG
    flp = flp + (~st.heur_ok).float() * NEG
    ok_fin = hits & (torch.arange(k2, device=device) < k)
    flp = flp + (~ok_fin).float() * NEG
    new_fin_sc, bidx = top_k(torch.cat([st.fin_sc, flp], dim=1), k)
    new_fin_seq = _take_beams(torch.cat([st.fin_seq, cand_seq], dim=1), bidx)
    new_is_fin = torch.gather(torch.cat([st.is_fin, ok_fin], dim=1), 1, bidx)

    # reorder the cache rows by surviving parent (no reorder once the search ended) and
    # decode one token; a step after the end puts back the slot it wrote
    cache = st.cache
    rows = (parent_keep + (torch.arange(b, device=device) * k)[:, None]).view(-1)
    rows = torch.where(go, rows, torch.arange(b * k, device=device))
    for buf in (cache.k, cache.v):
        buf.copy_(buf.index_select(1, rows))
    index0 = cache.index.clone()
    slot = index0.clamp(max=cache.capacity - 1).view(1)
    cache.index.copy_(slot[0])
    cache.host_index = min(cache.host_index, cache.capacity - 1)   # the host's copy, clamped alike
    saved = [buf.index_select(2, slot) for buf in (cache.k, cache.v)]
    if model_step is None:
        _, new_logits = gen.decode_step(lm, cfg, cache, cur_tok.view(-1), t + i)
    else:
        new_logits = model_step(cache, cur_tok.view(-1), t + i)
    for buf, old in zip((cache.k, cache.v), saved):
        buf.index_copy_(2, slot, torch.where(go, buf.index_select(2, slot), old))
    cache.index.copy_(torch.where(go, cache.index, index0))

    if spec.no_repeat_ngram_size > 0:
        h3 = _take_beams(st.hist.view(b, k, -1), parent_keep)
        h3.scatter_(2, (t + i).clamp(max=h3.shape[2] - 1).expand(b, k, 1),
                    cur_tok[:, :, None])
        st.hist.copy_(torch.where(go, h3.view(b * k, -1), st.hist))

    # the early-stop heuristic at cur_len = i + 1
    if spec.early_stopping == "never" and pen > 0.0:
        best_poss = new_run_sc[:, :1] * _recip(float(max_new) ** pen)
    else:
        best_poss = new_run_sc[:, :1] / (i + 1.0) ** pen
    worst_fin = torch.where(new_is_fin, new_fin_sc.min(dim=1, keepdim=True).values,
                            torch.full_like(new_fin_sc, NEG))
    new_heur = st.heur_ok & (best_poss > worst_fin).any(dim=-1, keepdim=True)
    # the loop ends when no beam can improve, (early_stopping=True) every beam finished,
    # or every candidate hit
    new_alive = new_heur.any() & ~hits.all()
    if spec.early_stopping is True:
        new_alive = new_alive & ~new_is_fin.all()

    for dst, new in ((st.logits, new_logits), (st.run_seq, new_run_seq),
                     (st.run_sc, new_run_sc), (st.fin_seq, new_fin_seq),
                     (st.fin_sc, new_fin_sc), (st.is_fin, new_is_fin), (st.heur_ok, new_heur)):
        dst.copy_(torch.where(go, new, dst))
    st.i.add_(go.long())
    st.alive.copy_(go & new_alive)


def xattn_beam_body(model: flamingo.FlamingoModel, cfg: AF2Config, spec: BeamSpec,
                    st: BeamState) -> None:
    """``beam_body`` over the AF1/AF2 stack: each step decodes through the gated xattn
    blocks against the state's media buffer (JAX ``beam_advance_xattn``'s decode_fn)."""
    beam_body(model, cfg, spec, st, model_step=lambda cache, tok, pos: flamingo.decode_step(
        model, cfg, cache, st.media, tok, pos)[1])


def held_beam_graph(lm, cfg: Qwen2Config | AF2Config, spec: BeamSpec, batch: int,
                    capacity: int, dtype: torch.dtype, device: torch.device,
                    media_shape: tuple | None = None) -> tuple[gen.DecodeGraph, bool]:
    """The held captured beam step of this key (``generate.hold``: captured now if there
    is none, or if the held one is in use) and whether it was captured now. The capture's
    warm-up step runs on a state that is not alive, so it changes nothing. With
    ``media_shape`` ``lm`` is a ``FlamingoModel`` and ``cfg`` its ``AF2Config``."""
    key = (("beam", media_shape)
           + gen.graph_key(lm, cfg, spec, batch, capacity, dtype, device))
    body = beam_body if media_shape is None else xattn_beam_body

    def make():
        generator = torch.Generator(device=device) if spec.do_sample else None
        state = new_beam_state(cfg, spec, batch, capacity, dtype, device, generator,
                               media_shape)
        return gen.DecodeGraph(lm, cfg, spec, state, body=body)
    return gen.hold(key, make)


class BeamSearch:
    """One beam search over ``batch`` prompts: its state and the step that advances it,
    the held captured step on the card and the eager body elsewhere. ``steps`` counts
    the steps run; no more than ``max_new_tokens`` are. ``model`` is an ``AF3Model``, or a
    ``FlamingoModel`` with its ``AF2Config`` and ``media_shape`` (S, d_audio)."""

    def __init__(self, model, cfg: AF3Config | AF2Config, spec: BeamSpec, batch: int,
                 capacity: int, device: torch.device,
                 generator: torch.Generator | None = None, media_shape: tuple | None = None):
        if media_shape is None:
            self.lm, self.cfg, self.body = model.lm, cfg.lm, beam_body
            dtype = gen.compute_dtype(model.lm)
        else:
            self.lm, self.cfg, self.body = model, cfg, xattn_beam_body
            dtype = flamingo.compute_dtype(model)
        self.spec = spec
        self.generator, self.capture_s, self.steps = generator, 0.0, 0
        with torch.inference_mode():
            if device.type == "cuda":
                t0 = time.perf_counter()
                self.graph, captured = held_beam_graph(self.lm, self.cfg, spec, batch, capacity,
                                                       dtype, device, media_shape)
                self.capture_s = time.perf_counter() - t0 if captured else 0.0
                self.graph.busy = True
                self.state = self.graph.state
            else:
                self.graph = None
                self.state = new_beam_state(self.cfg, spec, batch, capacity, dtype, device,
                                            generator, media_shape)

    @torch.inference_mode()
    def begin(self, first_logits: torch.Tensor, cache: qwen2.KVCache, prompt_len: int,
              prompt_tokens: torch.Tensor, media: torch.Tensor | None = None) -> None:
        begin(self.state, self.spec, first_logits, cache, prompt_len, prompt_tokens, media)
        if self.graph is not None:
            self.graph.load_generator(self.generator)
        self.steps = 0

    @torch.inference_mode()
    def advance(self, n: int) -> int:
        """Run up to n more steps (not past ``max_new_tokens`` in all); returns how many."""
        n = max(min(n, self.spec.max_new_tokens - self.steps), 0)
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.body(self.lm, self.cfg, self.spec, self.state)
        self.steps += n
        return n

    def run(self) -> None:
        """Step until the search ends, reading ``alive`` every SYNC_EVERY steps."""
        while self.steps < self.spec.max_new_tokens and bool(self.state.alive):
            self.advance(gen.SYNC_EVERY)

    def result(self, num_return_sequences: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(sequences [B, R, max_new] int64, EOS-padded; scores [B, R] f32), best first."""
        r = num_return_sequences
        return self.state.fin_seq[:, :r].clone(), self.state.fin_sc[:, :r].clone()

    def close(self) -> None:
        if self.graph is not None and self.graph.busy:
            self.graph.store_generator(self.generator)
            self.graph.busy = False

    def __enter__(self) -> "BeamSearch":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _spec(num_beams, max_new_tokens, eos_token_id, length_penalty, early_stopping,
          min_new_tokens, no_repeat_ngram_size, do_sample, temperature) -> BeamSpec:
    if early_stopping not in (False, True, "never"):
        raise ValueError(f"early_stopping is False, True or 'never', not {early_stopping!r}")
    return BeamSpec(int(num_beams), int(max_new_tokens), int(eos_token_id),
                    float(length_penalty), early_stopping, int(min_new_tokens),
                    int(no_repeat_ngram_size), bool(do_sample), float(temperature))


def _generator(spec: BeamSpec, generator, device) -> torch.Generator | None:
    """A sampled search without a generator draws from one seeded 0 (JAX's PRNGKey(0))."""
    if spec.do_sample and generator is None:
        return torch.Generator(device=device).manual_seed(0)
    return generator


def beam_loop(model, cfg: AF3Config | AF2Config, first_logits: torch.Tensor,
              cache: qwen2.KVCache, spec: BeamSpec, *, prompt_len: int,
              prompt_tokens: torch.Tensor, num_return_sequences: int = 1,
              generator: torch.Generator | None = None, media: torch.Tensor | None = None):
    """Beam search to the end from a prefill: first_logits [B, V], its B-row cache (and,
    for the AF1/AF2 stack, its transformed media [B, S, d]). Returns (sequences [B, R,
    max_new], scores [B, R])."""
    if num_return_sequences > spec.num_beams:
        raise ValueError("num_return_sequences must be <= num_beams")
    device = first_logits.device
    with BeamSearch(model, cfg, spec, first_logits.shape[0], cache.capacity, device,
                    _generator(spec, generator, device),
                    None if media is None else tuple(media.shape[1:])) as search:
        search.begin(first_logits, cache, prompt_len, prompt_tokens, media)
        search.run()
        return search.result(num_return_sequences)


def _check_capacity(t: int, true_len: int, max_new_tokens: int, capacity: int) -> int:
    if capacity == 0:
        return -(-(t + max_new_tokens) // 128) * 128
    if t > capacity or true_len + max_new_tokens > capacity:
        raise ValueError(f"a beam cache of {capacity} slots cannot take a prompt of {t} "
                         f"positions ({true_len} true) and {max_new_tokens} new tokens")
    return capacity


@torch.inference_mode()
def generate_beam(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
                  mels: torch.Tensor | None = None, *, num_beams: int, max_new_tokens: int,
                  eos_token_id: int, capacity: int = 0, length_penalty: float = 1.0,
                  early_stopping=False, min_new_tokens: int = 0,
                  num_return_sequences: int = 1, no_repeat_ngram_size: int = 0,
                  do_sample: bool = False, temperature: float = 1.0,
                  generator: torch.Generator | None = None, prompt_len: int | None = None):
    """AF3-family beam search: token ids [B, T] (+ mels) -> (sequences [B, R,
    max_new_tokens] int64 padded with EOS, scores [B, R] f32), best first. capacity=0
    rounds T + max_new_tokens up to a multiple of 128. early_stopping: False (the
    heuristic), True or "never", as HF. ``prompt_len``: the true length of a prompt
    right-padded to a bucket (the engines' lane), which JAX's ``generate_beam`` lacks."""
    t = token_ids.shape[1]
    true_len = t if prompt_len is None else int(prompt_len)
    capacity = _check_capacity(t, true_len, max_new_tokens, capacity)
    spec = _spec(num_beams, max_new_tokens, eos_token_id, length_penalty, early_stopping,
                 min_new_tokens, no_repeat_ngram_size, do_sample, temperature)
    cache, logits0 = gen.prefill(model, cfg, token_ids, mels, capacity, prompt_len=prompt_len)
    return beam_loop(model, cfg, logits0, cache, spec, prompt_len=true_len,
                     prompt_tokens=token_ids, num_return_sequences=num_return_sequences,
                     generator=generator)


@torch.inference_mode()
def generate_beam_xattn(model: flamingo.FlamingoModel, cfg: AF2Config,
                        token_ids: torch.Tensor, window_embeds: torch.Tensor, *,
                        num_beams: int, max_new_tokens: int, eos_token_id: int,
                        capacity: int = 0, length_penalty: float = 1.0, early_stopping=False,
                        min_new_tokens: int = 0, num_return_sequences: int = 1,
                        media_mode: str = "last", no_repeat_ngram_size: int = 0,
                        do_sample: bool = False, temperature: float = 1.0,
                        generator: torch.Generator | None = None,
                        prompt_len: int | None = None):
    """AF1/AF2 (gated-xattn) beam search (JAX :288): ``generate_beam``'s bookkeeping over
    the flamingo prefill and decode step. token_ids [B, T], window_embeds [B, n_media, wpm,
    d_audio] -> (sequences [B, R, max_new_tokens], scores [B, R]). The media are
    transformed once and expanded across the beams, never reordered. ``media_mode`` is
    JAX's prefill option (it acts only with a media mask, which beams do not take);
    ``prompt_len``: the true length of a bucket-padded prompt (the engines' lane)."""
    t = token_ids.shape[1]
    true_len = t if prompt_len is None else int(prompt_len)
    capacity = _check_capacity(t, true_len, max_new_tokens, capacity)
    spec = _spec(num_beams, max_new_tokens, eos_token_id, length_penalty, early_stopping,
                 min_new_tokens, no_repeat_ngram_size, do_sample, temperature)
    cache, media, logits0 = flamingo.prefill(model, cfg, token_ids, window_embeds, capacity,
                                             media_mode=media_mode, prompt_len=prompt_len)
    return beam_loop(model, cfg, logits0, cache, spec, prompt_len=true_len,
                     prompt_tokens=token_ids, num_return_sequences=num_return_sequences,
                     generator=generator, media=media)


def _open(model, cfg, token_ids: torch.Tensor, prompt_len: int, spec: BeamSpec,
          capacity: int, generator, media_shape, prefill) -> BeamSearch:
    """A search begun from ``prefill(capacity, prompt_len or None)`` -> (cache, media or
    None, first logits); closed again if the prefill fails."""
    t = token_ids.shape[1]
    device = token_ids.device
    search = BeamSearch(model, cfg, spec, token_ids.shape[0], capacity, device,
                        _generator(spec, generator, device), media_shape)
    try:
        cache, media, logits0 = prefill(capacity, prompt_len if prompt_len != t else None)
        search.begin(logits0, cache, prompt_len, token_ids, media)
    except BaseException:
        search.close()
        raise
    return search


@torch.inference_mode()
def beam_open(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
              mels: torch.Tensor | None, prompt_len: int, *, num_beams: int,
              max_new_tokens: int, eos_token_id: int, capacity: int,
              length_penalty: float = 1.0, early_stopping=False, min_new_tokens: int = 0,
              no_repeat_ngram_size: int = 0, do_sample: bool = False,
              temperature: float = 1.0,
              generator: torch.Generator | None = None) -> BeamSearch:
    """Prefill ONE request and begin its search (the engines' beam lane). token_ids
    [1, T] may be right-padded to a bucket with ``prompt_len`` the true length. The step
    options are given here, where JAX gives them to ``beam_advance``: the captured step
    holds them. Close the search (``BeamSearch.close``) when it is done."""
    capacity = _check_capacity(token_ids.shape[1], prompt_len, max_new_tokens, capacity)
    spec = _spec(num_beams, max_new_tokens, eos_token_id, length_penalty, early_stopping,
                 min_new_tokens, no_repeat_ngram_size, do_sample, temperature)

    def prefill(cap, plen):
        cache, logits0 = gen.prefill(model, cfg, token_ids, mels, cap, prompt_len=plen)
        return cache, None, logits0
    return _open(model, cfg, token_ids, prompt_len, spec, capacity, generator, None, prefill)


@torch.inference_mode()
def beam_open_xattn(model: flamingo.FlamingoModel, cfg: AF2Config, token_ids: torch.Tensor,
                    window_embeds: torch.Tensor, prompt_len: int, *, num_beams: int,
                    max_new_tokens: int, eos_token_id: int, capacity: int,
                    length_penalty: float = 1.0, early_stopping=False,
                    min_new_tokens: int = 0, no_repeat_ngram_size: int = 0,
                    do_sample: bool = False, temperature: float = 1.0,
                    media_mode: str = "last",
                    generator: torch.Generator | None = None) -> BeamSearch:
    """``beam_open`` for the AF1/AF2 stack (JAX :391): the prefill transforms the
    request's window embeddings [1, n_media, wpm, d_audio] once and the search's state
    holds them expanded across the beams (JAX returns them beside the state as
    ``media_k``)."""
    capacity = _check_capacity(token_ids.shape[1], prompt_len, max_new_tokens, capacity)
    spec = _spec(num_beams, max_new_tokens, eos_token_id, length_penalty, early_stopping,
                 min_new_tokens, no_repeat_ngram_size, do_sample, temperature)
    n_media, wpm = window_embeds.shape[1], window_embeds.shape[2]

    def prefill(cap, plen):
        return flamingo.prefill(model, cfg, token_ids, window_embeds, cap,
                                media_mode=media_mode, prompt_len=plen)
    return _open(model, cfg, token_ids, prompt_len, spec, capacity, generator,
                 (n_media * wpm, cfg.audio_embed_dim), prefill)


def beam_advance(search: BeamSearch, chunk: int) -> BeamSearch:
    """Advance a search by up to ``chunk`` steps (the engines' beam lane). Chunk
    boundaries only partition the steps: every step sees the inputs of the one-shot
    search, so the result equals ``generate_beam``'s."""
    search.advance(chunk)
    return search


# the AF1/AF2 search advances as the AF3 one does: its state holds the media (JAX :419)
beam_advance_xattn = beam_advance
