"""Prefill / decode generation, as ``audio_flamingo_tpu/runtime/generate.py``.

``prefill`` runs the prompt (+ audio) once and writes the KV cache; a prompt right-padded
to a token bucket is handled by taking the logits at ``prompt_len - 1`` and setting the
cache index back to ``prompt_len`` (pad slots are overwritten before any decode step
attends to them).

Decode is JAX's ``decode_loop``. Its body is one step function, ``decode_body``:
``decode_step``, the processors, ``sample_token``, the writes into ``out`` and
``logprobs`` and ``done |= eos | stop``, in place on fixed tensors (``DecodeState``: the
cache, whose index lives on the device, the last token, the position and the step as
0-dim device tensors, ``out``, ``done``, the logprobs and the token history). It reads
nothing back to the host.

- On a CUDA device the step is captured once in a CUDA graph (``DecodeGraph``) and
  replayed, as JAX compiles ``decode_step`` once per shape. A captured step holds its
  state, cache included, for the next call with the same key (``graph_key``: the LM's
  weights and layout, batch, capacity, ``max_new_tokens``, dtype and the options that
  change the traced ops); ``prefill`` writes into the held cache, as JAX donates it. At
  most ``MAX_HELD`` steps are held, the least recently used dropped first;
  ``release_graphs`` drops them all. A capture that fails raises: there is no eager
  decode on the card.
- On the CPU the same function runs eagerly, step by step.
- A ragged batch (``prompt_len`` a [B] tensor, JAX ``_generate_rows``) decodes each row
  from its own offset through the slot engine's per-row forward, eagerly on every device.

JAX's ``while_loop`` tests ``done`` on the device before every step. A graph cannot
branch, so the host reads ``done.all()`` once before the first step and then once every
``SYNC_EVERY`` steps. A step past every row's end writes EOS and a logprob of 0, as JAX's
body does for a finished row, so tokens, lengths and logprobs are JAX's: positions after
EOS hold EOS; lengths count up to and including the first EOS, or up to the end of the
first stop sequence; with ``return_logprobs`` each sampled token's f32 log-probability
under the logits it was sampled from. No step runs past ``max_new_tokens - 1``, so every
position written stays below the capacity, which ``generate`` checks covers
``prompt_len + max_new_tokens - 1``. ``generate_stream`` is the host-driven batch-1 loop
that yields token ids as they are sampled (JAX ``generate_stream``): it replays the same
step once per token and reads the token back, which is what streaming means.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple

import torch

from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.kernels import launches
from audio_flamingo_tpu_torch.ops.sampling import (SamplingParams, apply_no_repeat_ngram,
                                                   mask_eos, sample_token)

SYNC_EVERY = 8   # decode steps between two host reads of done.all()
MAX_HELD = 2     # captured steps (each with its cache) held for reuse


@dataclass
class GenerateOutput:
    tokens: torch.Tensor        # [B, max_new_tokens] int64
    lengths: torch.Tensor       # [B] int64
    first_logits: torch.Tensor  # [B, vocab] f32 prefill logits at the last prompt token
    ttft_s: float               # prefill + first token, device-synchronized
    decode_s: float             # every later decode step, device-synchronized
    decode_steps: int           # decode steps actually run: up to SYNC_EVERY - 1 past the
                                # step where every row was done (they write EOS)
    logprobs: torch.Tensor | None = None   # [B, max_new_tokens] f32 with return_logprobs
    capture_s: float = 0.0      # this call's capture of the decode step on the card (one
                                # eager warm-up step and the capture; 0 when a held step
                                # was reused), outside ttft_s and decode_s


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compute_dtype(lm) -> torch.dtype:
    """The dtype the LM computes (and keeps its cache) in."""
    return lm.dtype if isinstance(lm, qwen2.QuantQwen2) else lm.embed_tokens.dtype


@torch.inference_mode()
def prefill(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
            mels: torch.Tensor | None, capacity: int, prompt_len: int | None = None,
            cache: qwen2.KVCache | None = None):
    """Prompt (+ audio) -> (cache, last-token logits [B, vocab] f32). ``cache``: a cache
    of that capacity to write into (a held decode step's), else a new one."""
    b, t = token_ids.shape
    embeds = af3.build_input_embeds(model, cfg, token_ids, mels)
    pos = torch.arange(t, device=token_ids.device)[None].expand(b, t)
    if cache is None:
        cache = qwen2.init_cache(cfg.lm, b, capacity, embeds.dtype, token_ids.device)
    elif cache.capacity != capacity:
        raise ValueError(f"a cache of {cache.capacity} slots for a capacity of {capacity}")
    else:
        cache.rewind(0)
    h, cache = qwen2.forward(model.lm, cfg.lm, embeds, pos, cache=cache, is_prefill=True)
    if prompt_len is None:
        return cache, qwen2.unembed(model.lm, h[:, -1])
    cache.rewind(prompt_len)
    return cache, qwen2.unembed(model.lm, h[:, prompt_len - 1])


def decode_step(lm, cfg: Qwen2Config, cache: qwen2.KVCache | qwen2.Q8KVCache,
                token: torch.Tensor, position: torch.Tensor):
    """One decode step of the LM: [B] token ids at ``position`` (a 0-dim int64 tensor on
    the device) -> (cache, [B, vocab] f32 logits). Reads nothing back to the host."""
    embeds = qwen2.embed(lm, token[:, None])
    h, cache = qwen2.forward(lm, cfg, embeds, position.expand(token.shape[0], 1), cache=cache)
    return cache, qwen2.unembed(lm, h[:, 0])


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """f32 log-softmax of [B, vocab] logits at the sampled [B] tokens."""
    return torch.log_softmax(logits.float(), dim=-1).gather(1, tok[:, None])[:, 0]


def check_stops(out: torch.Tensor, step: torch.Tensor, done: torch.Tensor,
                stops: tuple) -> torch.Tensor:
    """done | (a stop sequence ends exactly at ``step`` of out [B, max_new_tokens]).
    ``step``: a 0-dim int64 device tensor; ``stops``: [m] int64 device tensors. JAX's
    window ``dynamic_slice`` is a gather here."""
    b = out.shape[0]
    for seq in stops:
        m = seq.shape[0]
        if m > out.shape[1]:   # can never complete within the budget
            continue
        idx = (step - (m - 1)).clamp(min=0) + torch.arange(m, device=out.device)
        hit = (torch.gather(out, 1, idx.expand(b, m)) == seq).all(dim=1)
        done = done | (hit & (step + 1 >= m))
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


def _ragged(prompt_len, stop_sequences: tuple, return_logprobs: bool,
            sampling: SamplingParams) -> bool:
    """Whether prompt_len gives one length per row. JAX refuses stops, logprobs and the
    n-gram ban on ragged rows (the engines serve them)."""
    if prompt_len is None or isinstance(prompt_len, int) or torch.as_tensor(prompt_len).ndim == 0:
        return False
    if stop_sequences or return_logprobs or sampling.no_repeat_ngram_size:
        raise ValueError("ragged batches: use the engines for stops/logprobs/ngram blocking")
    return True


# ----------------------------------------------------------------------------------------
# The decode step: JAX's decode_loop body on fixed tensors


class DecodeSpec(NamedTuple):
    """What fixes a step's ops besides the shapes."""

    max_new_tokens: int
    eos_token_id: int = -1
    sampling: SamplingParams = SamplingParams()
    stop_sequences: tuple = ()     # token-id tuples
    return_logprobs: bool = False


@dataclass
class DecodeState:
    """The tensors one decode step reads and writes in place (JAX's ``GenState``)."""

    cache: qwen2.KVCache | qwen2.Q8KVCache
    tok: torch.Tensor        # [B] int64: the last sampled token, fed at ``position``
    position: torch.Tensor   # [] int64: its absolute position (prompt length + step)
    step: torch.Tensor       # [] int64: its index in ``out``
    out: torch.Tensor        # [B, max_new_tokens] int64, EOS where nothing was sampled
    done: torch.Tensor       # [B] bool
    logits: torch.Tensor     # [B, vocab] f32: the last step's model logits (no processor)
    logprobs: torch.Tensor | None   # [B, max_new_tokens] f32 with return_logprobs
    seq: torch.Tensor | None        # [B, capacity + 1] int64: the prompt and each
                                    # generated token at its position (the last one may
                                    # lie one past the cache), for the repetition penalty
                                    # and the n-gram ban (valid up to ``position``)
    stops: tuple                    # the stop sequences as [m] int64 device tensors
    generator: torch.Generator | None = None

    def nbytes(self) -> dict:
        """Bytes of the cache and of the rest of the state."""
        cache = sum(t.numel() * t.element_size() for t in vars(self.cache).values()
                    if isinstance(t, torch.Tensor))
        rest = sum(t.numel() * t.element_size() for t in (
            self.tok, self.position, self.step, self.out, self.done, self.logits,
            self.logprobs, self.seq, *self.stops) if t is not None)
        return dict(cache=cache, state=rest)


def new_state(cfg: Qwen2Config, spec: DecodeSpec, cache, generator=None) -> DecodeState:
    """A state over ``cache`` (its batch and capacity), every other tensor on its device."""
    b, capacity, device = cache.batch, cache.capacity, cache.index.device
    sp = spec.sampling
    long = dict(dtype=torch.long, device=device)
    return DecodeState(
        cache=cache, tok=torch.zeros(b, **long), position=torch.zeros((), **long),
        step=torch.zeros((), **long),
        out=torch.full((b, spec.max_new_tokens), spec.eos_token_id, **long),
        done=torch.zeros(b, dtype=torch.bool, device=device),
        logits=torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=device),
        logprobs=(torch.zeros((b, spec.max_new_tokens), dtype=torch.float32, device=device)
                  if spec.return_logprobs else None),
        seq=(torch.zeros((b, capacity + 1), **long)
             if sp.repetition_penalty != 1.0 or sp.no_repeat_ngram_size > 0 else None),
        stops=tuple(torch.tensor(s, **long) for s in spec.stop_sequences),
        generator=generator)


def _history(seq: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The repetition penalty's history: seq's ids up to position ``last``, -1 after."""
    valid = torch.arange(seq.shape[1], device=seq.device)[None] <= last
    return torch.where(valid, seq, torch.full_like(seq, -1))


def begin(st: DecodeState, spec: DecodeSpec, tok: torch.Tensor, position: int,
          logits: torch.Tensor | None = None) -> None:
    """Start a sequence: ``tok`` [B] is token 0, fed next at ``position`` (the prompt's
    length); ``logits``: the logits it was sampled from, for its logprob."""
    st.tok.copy_(tok)
    st.position.fill_(position)
    st.step.zero_()
    st.out.fill_(spec.eos_token_id)
    st.out[:, 0] = tok
    if st.logprobs is not None:
        st.logprobs.zero_()
        st.logprobs[:, 0] = token_logprob(logits, tok)
    if st.seq is not None:
        st.seq[:, position] = tok
    st.done.copy_(check_stops(st.out, st.step, tok == spec.eos_token_id, st.stops))


def start_decode(st: DecodeState, spec: DecodeSpec, first_logits: torch.Tensor,
                 token_ids: torch.Tensor, true_len: int,
                 generator: torch.Generator | None) -> None:
    """JAX's ``decode_loop`` before its ``while_loop``: the first token sampled from the
    prefill's logits under the n-gram ban (over the exact prompt), the EOS floor and the
    repetition penalty (over the prompt), then ``begin``."""
    sp = spec.sampling
    logits, hist = first_logits, None
    if st.seq is not None:
        st.seq[:, : token_ids.shape[1]] = token_ids
        st.position.fill_(true_len)
        if sp.repetition_penalty != 1.0:
            hist = _history(st.seq, st.position - 1)
        if sp.no_repeat_ngram_size > 0:
            logits = apply_no_repeat_ngram(logits, st.seq, st.position,
                                           sp.no_repeat_ngram_size)
    if sp.min_new_tokens >= 1:
        logits = mask_eos(logits, spec.eos_token_id,
                          torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device))
    tok = sample_token(logits, sp, generator, token_history=hist)
    begin(st, spec, tok, true_len, logits)


def decode_body(lm, cfg: Qwen2Config, spec: DecodeSpec, st: DecodeState,
                model_step: Callable[[DecodeState], torch.Tensor] | None = None) -> None:
    """One step of JAX's ``decode_loop`` body (audio_flamingo_tpu/runtime/generate.py
    :154-179), in place on ``st``: decode ``tok`` at ``position``, the n-gram ban over the
    prompt and the tokens so far, the EOS floor, the repetition penalty over the same,
    sample, EOS for finished rows, write token ``step + 1`` (and its logprob), then ``done
    |= eos | stop``. Reads nothing back to the host. ``model_step(st)`` -> [B, vocab] f32
    logits replaces the LM's ``decode_step`` (the AF2 stack's, models/flamingo.py)."""
    if spec.max_new_tokens < 2:   # a step writes token step + 1
        raise ValueError("a sequence of one token has no decode step")
    sp = spec.sampling
    b = st.tok.shape[0]
    if model_step is None:
        _, logits = decode_step(lm, cfg, st.cache, st.tok, st.position)
    else:
        logits = model_step(st)
    st.logits.copy_(logits)
    hist = None
    if sp.repetition_penalty != 1.0:
        hist = _history(st.seq, st.position)
    if sp.no_repeat_ngram_size > 0:
        logits = apply_no_repeat_ngram(logits, st.seq, st.position + 1,
                                       sp.no_repeat_ngram_size)
    if sp.min_new_tokens > 0:
        logits = mask_eos(logits, spec.eos_token_id, (st.step + 1 < sp.min_new_tokens).expand(b))
    nxt = sample_token(logits, sp, st.generator, token_history=hist)
    nxt = torch.where(st.done, torch.full_like(nxt, spec.eos_token_id), nxt)
    st.step.add_(1)
    at = st.step.expand(b, 1)
    st.out.scatter_(1, at, nxt[:, None])
    if st.logprobs is not None:
        lp = torch.where(st.done, torch.zeros_like(st.logits[:, 0]), token_logprob(logits, nxt))
        st.logprobs.scatter_(1, at, lp[:, None])
    if st.seq is not None:
        st.seq.scatter_(1, (st.position + 1).expand(b, 1), nxt[:, None])
    st.done.copy_(check_stops(st.out, st.step, st.done | (nxt == spec.eos_token_id), st.stops))
    st.tok.copy_(nxt)
    st.position.add_(1)


def run_decode(st: DecodeState, max_new_tokens: int, step: Callable[[], None]) -> int:
    """``step()`` until every row is done or ``max_new_tokens - 1`` steps ran; the host
    reads ``done.all()`` before the first step and then every ``SYNC_EVERY`` steps.
    Returns the steps run."""
    steps = 0
    while steps + 1 < max_new_tokens and not bool(st.done.all()):
        n = min(SYNC_EVERY, max_new_tokens - 1 - steps)
        for _ in range(n):
            step()
        steps += n
    return steps


# ----------------------------------------------------------------------------------------
# The captured step


class DecodeGraph:
    """A step function, ``decode_body`` or another of its signature (the beam's
    ``runtime/beam.beam_body``), captured in one CUDA graph over the state it holds (a
    state with ``cache``, ``generator`` and ``nbytes``).

    One eager step runs first, so that what the kernel wrappers keep for later calls
    (plans, split counters, scratch) is allocated outside the graph's pool; its launches
    count as launches. The launches made inside the capture are counted at each replay
    (``ops/kernels/launches``). A sampled step draws from a generator of its own,
    registered with the graph: ``load_generator`` and ``store_generator`` hand it the
    caller's state and back, so the draws are the eager draws of the same seed."""

    def __init__(self, lm, cfg: Qwen2Config, spec, state, body: Callable | None = None):
        body = body or decode_body
        device = state.cache.index.device
        if device.type != "cuda":
            raise ValueError(f"a decode step is captured on cuda, not {device}")
        t0 = time.perf_counter()
        self.spec, self.state, self.busy = spec, state, False
        with torch.inference_mode():
            body(lm, cfg, spec, state)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            self.graph = torch.cuda.CUDAGraph()
            if state.generator is not None:
                self.graph.register_generator_state(state.generator)
            launches.take_captured()
            with torch.cuda.graph(self.graph):
                body(lm, cfg, spec, state)
            self.launches = launches.take_captured()
        torch.cuda.synchronize(device)
        self.graph_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        self.state.cache.host_index += 1
        launches.count_replay(self.launches)

    def load_generator(self, generator: torch.Generator | None) -> None:
        if self.state.generator is not None:
            self.state.generator.set_state(self._source(generator).get_state())

    def store_generator(self, generator: torch.Generator | None) -> None:
        if self.state.generator is not None:
            self._source(generator).set_state(self.state.generator.get_state())

    def _source(self, generator) -> torch.Generator:
        """The caller's generator, or the default generator of the state's device."""
        if generator is not None:
            return generator
        device = self.state.cache.index.device
        return torch.cuda.default_generators[device.index if device.index is not None
                                             else torch.cuda.current_device()]

    def nbytes(self) -> dict:
        return dict(self.state.nbytes(), graph=self.graph_bytes)


_HELD: collections.OrderedDict = collections.OrderedDict()   # key -> a captured step


def graph_key(lm, cfg: Qwen2Config, spec: DecodeSpec, batch: int, capacity: int,
              dtype: torch.dtype, device: torch.device) -> tuple:
    """What fixes a captured step: the LM's layout and the address, shape and dtype of
    every weight (a graph reads them in place), its config, the spec, the batch, the
    capacity and the dtype of the cache, and the device."""
    weights = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                    for t in (*lm.parameters(), *lm.buffers()))
    return (type(lm), weights, cfg, spec, batch, capacity, dtype, device)


def hold(key: tuple, make: Callable[[], object]) -> tuple[object, bool]:
    """The held captured step of ``key`` (made by ``make()`` if there is none, dropping the
    least recently used beyond ``MAX_HELD``) and whether it was made now. A held step in
    use (``busy``: an open stream, a beam request in an engine's lane) is not shared: a
    private one is made and not held."""
    graph = _HELD.get(key)
    if graph is not None and not graph.busy:
        _HELD.move_to_end(key)
        return graph, False
    graph = make()
    if key not in _HELD:
        _HELD[key] = graph
        while len(_HELD) > MAX_HELD:
            _HELD.popitem(last=False)   # a step in use is kept by its user until it ends
    return graph, True


def release_graphs() -> int:
    """Drop every held captured step and its cache (freed once no open stream uses it);
    returns the bytes they held."""
    freed = sum(sum(graph.nbytes().values()) for graph in _HELD.values())
    _HELD.clear()
    return freed


def held_bytes() -> dict:
    """Bytes the held captured steps keep: caches, the rest of their states, graph pools."""
    out = dict(steps=len(_HELD), cache=0, state=0, graph=0)
    for graph in _HELD.values():
        for k, v in graph.nbytes().items():
            out[k] += v
    return out


class Decoder:
    """A generate's decode: on the card the held captured step of ``key`` (``hold``; made
    by ``make_state`` and ``body``), else a state of its own stepped eagerly (so too for a
    single token, which takes no step). ``body(lm, cfg, spec, state)`` is the step:
    ``decode_body`` for the LM alone, ``models/flamingo.decode_body`` for the AF1/AF2
    stack. ``make_state(generator)`` makes a state; a sampled captured step draws from a
    generator of its own, loaded from and stored back to the caller's."""

    def __init__(self, lm, cfg, spec: DecodeSpec, key: tuple,
                 make_state: Callable[[torch.Generator | None], object], device: torch.device,
                 generator: torch.Generator | None, body: Callable = decode_body):
        self.generator, self.capture_s = generator, 0.0
        with torch.inference_mode():
            if device.type == "cuda" and spec.max_new_tokens > 1:
                t0 = time.perf_counter()
                self.graph, captured = hold(key, lambda: DecodeGraph(
                    lm, cfg, spec,
                    make_state(None if spec.sampling.greedy else torch.Generator(device=device)),
                    body))
                self.capture_s = time.perf_counter() - t0 if captured else 0.0
                self.graph.busy = True
                self.state = self.graph.state
            else:
                self.graph = None
                self.state = make_state(generator)
        self._body = lambda: body(lm, cfg, spec, self.state)

    @torch.inference_mode()
    def step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self._body()

    def __enter__(self) -> "Decoder":
        return self

    def started(self) -> None:
        """The first token is sampled: the captured step draws on from here."""
        if self.graph is not None:
            self.graph.load_generator(self.generator)

    def __exit__(self, *exc) -> None:
        if self.graph is not None:
            self.graph.store_generator(self.generator)
            self.graph.busy = False


def _lm_decoder(model: af3.AF3Model, cfg: AF3Config, spec: DecodeSpec, batch: int,
                capacity: int, device: torch.device,
                generator: torch.Generator | None) -> Decoder:
    """The LM's decode over a bf16/f32 ``KVCache``."""
    dtype = compute_dtype(model.lm)
    return Decoder(model.lm, cfg.lm, spec,
                   graph_key(model.lm, cfg.lm, spec, batch, capacity, dtype, device),
                   lambda g: new_state(cfg.lm, spec, qwen2.init_cache(cfg.lm, batch, capacity,
                                                                      dtype, device), g),
                   device, generator)


def _capacity(t: int, true_len: int, max_new_tokens: int, capacity: int) -> int:
    if capacity == 0:
        return -(-(t + max_new_tokens) // 128) * 128
    if t > capacity or true_len + max_new_tokens - 1 > capacity:
        raise ValueError(f"KV cache of {capacity} slots cannot take a prompt of {t} "
                         f"positions ({true_len} true) and {max_new_tokens} new tokens")
    return capacity


@torch.inference_mode()
def generate(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
             mels: torch.Tensor | None = None, *, max_new_tokens: int = 64,
             capacity: int = 0, eos_token_id: int = -1,
             sampling: SamplingParams = SamplingParams(),
             generator: torch.Generator | None = None,
             prompt_len: int | None = None, stop_sequences: tuple = (),
             return_logprobs: bool = False) -> GenerateOutput:
    """Token ids [B, T] (+ mels) -> GenerateOutput. capacity=0 rounds T + max_new_tokens
    up to a multiple of 128. prompt_len: the true length of a right-padded prompt, or a
    [B] tensor of lengths for a ragged batch (``_generate_rows``).

    ``sampling.no_repeat_ngram_size`` bans, at every step, the tokens that would complete
    an n-gram of the exact prompt plus the tokens generated so far (the JAX loop's rule;
    a right-padded prompt counts only its first ``prompt_len`` ids). ``stop_sequences``
    (token-id tuples): a row stops after emitting any of them, keeping the sequence.
    ``return_logprobs``: ``logprobs`` holds each sampled token's log-probability under
    the logits it was sampled from, after the n-gram ban and the EOS floor (0 past a
    row's end). On a CUDA device decode replays the captured step (see the module)."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    b, t = token_ids.shape
    device = token_ids.device
    if _ragged(prompt_len, stop_sequences, return_logprobs, sampling):
        return _generate_rows(model, cfg, token_ids, mels, capacity, max_new_tokens,
                              eos_token_id, sampling, generator,
                              torch.as_tensor(prompt_len, device=device).long())
    stop_sequences = tuple(tuple(int(t) for t in seq) for seq in stop_sequences)
    true_len = t if prompt_len is None else int(prompt_len)
    capacity = _capacity(t, true_len, max_new_tokens, capacity)
    spec = DecodeSpec(max_new_tokens, eos_token_id, sampling, stop_sequences, return_logprobs)

    with _lm_decoder(model, cfg, spec, b, capacity, device, generator) as dec:
        st = dec.state
        t0 = time.perf_counter()
        _, first_logits = prefill(model, cfg, token_ids, mels, capacity,
                                  prompt_len=prompt_len, cache=st.cache)
        start_decode(st, spec, first_logits, token_ids.long(), true_len, generator)
        dec.started()
        sync(device)
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        steps = run_decode(st, max_new_tokens, dec.step)
        sync(device)
        decode_s = time.perf_counter() - t1
        out = st.out.clone()
        logprobs = st.logprobs.clone() if return_logprobs else None

    return GenerateOutput(tokens=out, lengths=output_lengths(out, eos_token_id, stop_sequences),
                          first_logits=first_logits, ttft_s=ttft, decode_s=decode_s,
                          decode_steps=steps, logprobs=logprobs, capture_s=dec.capture_s)


@torch.inference_mode()
def _generate_rows(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor, mels,
                   capacity: int, max_new_tokens: int, eos_token_id: int,
                   sampling: SamplingParams, generator: torch.Generator | None,
                   prompt_len: torch.Tensor) -> GenerateOutput:
    """A ragged batch (JAX ``_generate_rows``): prompt_len [B], each row decoding from its
    own offset. One prefill over the right-padded batch (a row's pad slots hold garbage
    K/V, which decode overwrites before it attends them), then the slot engine's per-row
    forward (``engine._rows_forward``). Eager, one step at a time, on every device; the
    host reads ``done.all()`` every ``SYNC_EVERY`` steps."""
    from audio_flamingo_tpu_torch.runtime.engine import SlotCache, _rows_forward

    b, t = token_ids.shape
    device = token_ids.device
    if capacity == 0:
        capacity = -(-(t + max_new_tokens) // 128) * 128
    elif t > capacity or int(prompt_len.max()) + max_new_tokens - 1 > capacity:
        raise ValueError(f"KV cache of {capacity} slots cannot take a prompt of {t} "
                         f"positions and {max_new_tokens} new tokens")
    t0 = time.perf_counter()
    embeds = af3.build_input_embeds(model, cfg, token_ids, mels)
    cache = qwen2.init_cache(cfg.lm, b, capacity, embeds.dtype, device)
    pos = torch.arange(t, device=device)[None].expand(b, t)
    h, cache = qwen2.forward(model.lm, cfg.lm, embeds, pos, cache=cache, is_prefill=True)
    first_logits = qwen2.unembed(model.lm, h[torch.arange(b, device=device), prompt_len - 1])

    prompt_history = None
    if sampling.repetition_penalty != 1.0:
        valid = torch.arange(t, device=device)[None] < prompt_len[:, None]
        prompt_history = torch.where(valid, token_ids.long(), torch.full_like(token_ids.long(), -1))
    logits = first_logits
    if sampling.min_new_tokens >= 1:
        logits = mask_eos(logits, eos_token_id, torch.ones(b, dtype=torch.bool, device=device))
    tok = sample_token(logits, sampling, generator, token_history=prompt_history)
    slot = SlotCache(cache.k, cache.v, prompt_len.int())
    out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.long, device=device)
    out[:, 0] = tok
    done = tok == eos_token_id
    sync(device)
    ttft = time.perf_counter() - t0

    def step(i: int) -> None:
        nonlocal slot, tok, done
        x = qwen2.embed(model.lm, tok[:, None])
        hs, slot = _rows_forward(model.lm, cfg.lm, x, slot.lengths, slot)
        lg = qwen2.unembed(model.lm, hs[:, 0])
        hist = None
        if prompt_history is not None:
            gen_hist = torch.where(torch.arange(max_new_tokens, device=device)[None] <= i - 1,
                                   out, torch.full_like(out, -1))
            hist = torch.cat([prompt_history, gen_hist], dim=1)
        if sampling.min_new_tokens > 0:
            lg = mask_eos(lg, eos_token_id,
                          torch.full((b,), i < sampling.min_new_tokens, device=device))
        nxt = sample_token(lg, sampling, generator, token_history=hist)
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        out[:, i] = nxt
        slot.lengths = slot.lengths + (~done).int()
        done = done | (nxt == eos_token_id)
        tok = nxt

    t1 = time.perf_counter()
    steps = 0
    while steps + 1 < max_new_tokens and not bool(done.all()):
        n = min(SYNC_EVERY, max_new_tokens - 1 - steps)
        for _ in range(n):
            steps += 1
            step(steps)
    sync(device)
    return GenerateOutput(tokens=out, lengths=output_lengths(out, eos_token_id, ()),
                          first_logits=first_logits, ttft_s=ttft,
                          decode_s=time.perf_counter() - t1, decode_steps=steps)


def generate_stream(model: af3.AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
                    mels: torch.Tensor | None = None, *, max_new_tokens: int = 128,
                    capacity: int = 0, eos_token_id: int = -1,
                    sampling: SamplingParams = SamplingParams(),
                    generator: torch.Generator | None = None,
                    prompt_len: int | None = None) -> Iterator[int]:
    """Host-driven streaming decode (batch 1): yields token ids as they are sampled, up to
    and including EOS. The EOS floor (``min_new_tokens``) and the repetition penalty
    (over the prompt plus what it has generated) apply as in ``generate``; the n-gram ban
    does not, as in JAX. Each token is one step (one replay on the card) and one read."""
    b, t = token_ids.shape
    if b != 1:
        raise ValueError(f"streaming drives batch 1, got {b} rows")
    true_len = t if prompt_len is None else int(prompt_len)
    capacity = _capacity(t, true_len, max_new_tokens, capacity)
    spec = DecodeSpec(max_new_tokens, eos_token_id,
                      sampling._replace(no_repeat_ngram_size=0))
    # inference mode is entered around each device section, never held across a yield
    with _lm_decoder(model, cfg, spec, b, capacity, token_ids.device, generator) as dec:
        st = dec.state
        _, logits = prefill(model, cfg, token_ids, mels, capacity, prompt_len=prompt_len,
                            cache=st.cache)
        with torch.inference_mode():
            start_decode(st, spec, logits, token_ids.long(), true_len, generator)
        dec.started()
        for i in range(max_new_tokens):
            tid = int(st.tok[0])
            yield tid
            if tid == eos_token_id or i + 1 == max_new_tokens:
                return
            dec.step()
