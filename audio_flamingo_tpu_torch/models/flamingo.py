"""The AF1/AF2 family, as ``audio_flamingo_tpu/models/flamingo.py``: CLAP window
embeddings -> audio-transform self-attention layers -> Flamingo gated cross-attention into
a Qwen2.5 (AF2) or OPT (AF1) decoder.

- ``transform_audio``: [B, n_media, windows, d_audio] window embeddings through the
  audio-transform layers (8 heads), attention only within each media item, so the media
  masks of few-shot prompts stay exact.
- ``_lm_forward_with_xattn`` is the stack: one Python loop over the LM's layers, the xattn
  block ``i // every`` before layer i when ``i % every == 0``, then the LM's own layer
  (``qwen2._layer_forward`` without flash, or ``opt._layer_forward``). Each layer's
  products run as the LM's layout runs them: an int8 tree through K4 at decode sizes, a
  fused-w4 tree through K5 (``qwen2.qkv_proj`` / ``mlp_forward``). The fused w4 decode
  suffixes (K6) cannot run here: suffix B computes the next layer's norm and qkv from the
  residual before that layer's xattn block has run. The cache advances once, after the
  stack.
- ``prefill`` / ``decode_step`` / ``generate``: the media are transformed once at prefill
  and every decode step attends to them. ``generate`` is JAX's ``decode_loop`` through the
  port's ``runtime/generate`` machinery (``DecodeSpec``, ``start_decode``, ``run_decode``,
  ``decode_body``): on the card the step is captured once per key in a CUDA graph and
  replayed. The captured step reads the media from a buffer of its state, which each
  generate fills before the first replay; the key holds the media's shape and the decode
  media mask's, so a second clip never replays against the first clip's media.
- ``logits`` (every text token sees all media) and ``logits_with_media_mask`` (Flamingo
  masking for interleaved few-shot prompts).

Weights live in ``FlamingoModel``: the audio-transform and xattn stacks as modules (torch
layouts) and the LM as ``qwen2.Qwen2``, ``qwen2.QuantQwen2`` or ``opt.OPT``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import AF2Config, OPTConfig
from audio_flamingo_tpu_torch.models import opt, qwen2
from audio_flamingo_tpu_torch.ops import xattn as xattn_op
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.mlp import gelu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm, rms_norm
from audio_flamingo_tpu_torch.ops.rope import rope_cos_sin
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as gen

ATL_HEADS = 8   # heads of the audio-transform layers


# ------------------------------------------------------------------ audio transform layers

class ATLayer(nn.Module):
    """Pre-norm self-attention (bias-free q, k, v, o) and a biased GELU MLP of 4 d."""

    def __init__(self, d: int, **factory):
        super().__init__()
        self.ln1 = Norm(d, **factory)
        self.q = nn.Linear(d, d, bias=False, **factory)
        self.k = nn.Linear(d, d, bias=False, **factory)
        self.v = nn.Linear(d, d, bias=False, **factory)
        self.o = nn.Linear(d, d, bias=False, **factory)
        self.ln2 = Norm(d, **factory)
        self.fc1 = nn.Linear(d, 4 * d, **factory)
        self.fc2 = nn.Linear(4 * d, d, **factory)


def _atl_forward(x: torch.Tensor, lp: ATLayer, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // num_heads
    h = layer_norm(x, lp.ln1.weight, lp.ln1.bias)
    q, k, v = (F.linear(h, lin.weight).reshape(b, s, num_heads, hd) for lin in (lp.q, lp.k, lp.v))
    x = x + F.linear(gqa_attention(q, k, v).reshape(b, s, d), lp.o.weight)
    h = layer_norm(x, lp.ln2.weight, lp.ln2.bias)
    return x + gelu_mlp(h, lp.fc1.weight, lp.fc1.bias, lp.fc2.weight, lp.fc2.bias)


# ------------------------------------------------------------------------------- the model

class FlamingoModel(nn.Module):
    """``audio_transform`` and ``xattn`` (one block per ``cross_every_n_layers`` LM
    layers) and the LM."""

    def __init__(self, audio_transform: nn.ModuleList, xattn: nn.ModuleList, lm: nn.Module):
        super().__init__()
        self.audio_transform = audio_transform
        self.xattn = xattn
        self.lm = lm


def is_opt(cfg: AF2Config) -> bool:
    return isinstance(cfg.lm, OPTConfig)


def num_xattn(cfg: AF2Config) -> int:
    return cfg.lm.num_layers // cfg.xattn.cross_every_n_layers


def build(cfg: AF2Config, device: torch.device | str, dtype: torch.dtype,
          lm: nn.Module | None = None) -> FlamingoModel:
    """Allocate a FlamingoModel's weights (uninitialized) on ``device`` in ``dtype``,
    built on the meta device so no host copy exists. ``lm``: an LM already on ``device``
    (e.g. a ``QuantQwen2``), taken as it is in place of a float one."""
    d_lm, d_a = cfg.lm.hidden_size, cfg.audio_embed_dim
    with torch.device("meta"):
        atl = nn.ModuleList(ATLayer(d_a, dtype=dtype)
                            for _ in range(cfg.num_audio_transform_layers))
        xa = nn.ModuleList(xattn_op.XAttnBlock(d_lm, d_a, cfg.xattn.num_heads,
                                               cfg.xattn.ffn_mult, dtype=dtype)
                           for _ in range(num_xattn(cfg)))
        float_lm = None
        if lm is None:
            float_lm = opt.OPT(cfg.lm, dtype=dtype) if is_opt(cfg) else qwen2.Qwen2(cfg.lm, dtype=dtype)
    atl, xa = atl.to_empty(device=device), xa.to_empty(device=device)
    lm = float_lm.to_empty(device=device) if lm is None else lm
    return FlamingoModel(atl, xa, lm).eval().requires_grad_(False)


@torch.no_grad()
def init_fusion_(model: FlamingoModel, generator: torch.Generator) -> None:
    """The audio-transform and xattn stacks with the JAX init's distributions (Normal(0,
    0.5 / sqrt(fan_in)) weights, zero biases, unit norms, zero gates); the LM untouched."""
    for lp in model.audio_transform:
        for lin in (lp.q, lp.k, lp.v, lp.o, lp.fc1, lp.fc2):
            lin.weight.normal_(0.0, 0.5 * lin.in_features ** -0.5, generator=generator)
            if lin.bias is not None:
                lin.bias.zero_()
        for norm in (lp.ln1, lp.ln2):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
    for block in model.xattn:
        xattn_op.init_(block, generator)


def init_fusion(cfg: AF2Config, lm: nn.Module, generator: torch.Generator,
                device: torch.device | str, dtype: torch.dtype) -> FlamingoModel:
    """Random fusion stacks around a given LM (JAX ``init_fusion``: pair them with a
    quantized LM, e.g. ``ops/quant.random_quantized_lm``, without a float LM ever made)."""
    model = build(cfg, device, dtype, lm=lm)
    init_fusion_(model, generator)
    return model


def init(cfg: AF2Config, generator: torch.Generator, device: torch.device | str,
         dtype: torch.dtype) -> FlamingoModel:
    """A random model: the fusion stacks and a float LM (JAX ``init``)."""
    model = build(cfg, device, dtype)
    init_fusion_(model, generator)
    (opt.init_ if is_opt(cfg) else qwen2.init_)(model.lm, generator)
    return model


def compute_dtype(model: FlamingoModel) -> torch.dtype:
    """The dtype the model computes (and keeps its cache) in."""
    return model.lm.dtype if isinstance(model.lm, opt.OPT) else gen.compute_dtype(model.lm)


# ------------------------------------------------------------------------------- forward

def transform_audio(model: FlamingoModel, cfg: AF2Config,
                    window_embeds: torch.Tensor) -> torch.Tensor:
    """[B, n_media, windows_per_media, d_audio] -> [B, n_media * wpm, d_audio]:
    self-attention within each media item, never across items."""
    b, n_media, wpm, d = window_embeds.shape
    x = window_embeds.reshape(b * n_media, wpm, d)
    for lp in model.audio_transform:
        x = _atl_forward(x, lp, ATL_HEADS)
    return x.reshape(b, n_media * wpm, d)


def _embed(model: FlamingoModel, cfg: AF2Config, token_ids: torch.Tensor) -> torch.Tensor:
    return opt.embed(model.lm, token_ids) if is_opt(cfg) else qwen2.embed(model.lm, token_ids)


def _unembed(model: FlamingoModel, cfg: AF2Config, hidden: torch.Tensor) -> torch.Tensor:
    return opt.unembed(model.lm, hidden) if is_opt(cfg) else qwen2.unembed(model.lm, hidden)


def _init_cache(cfg: AF2Config, batch: int, capacity: int, dtype: torch.dtype,
                device) -> qwen2.KVCache:
    return (opt.init_cache if is_opt(cfg) else qwen2.init_cache)(cfg.lm, batch, capacity,
                                                                 dtype, device)


def _lm_forward_with_xattn(model: FlamingoModel, cfg: AF2Config, embeds: torch.Tensor,
                           positions: torch.Tensor, media: torch.Tensor,
                           media_mask: torch.Tensor | None,
                           cache: qwen2.KVCache | None = None) -> torch.Tensor:
    """The decoder stack with a gated-xattn block before every ``cross_every_n_layers``-th
    layer (JAX flamingo.py:135-200). With a cache, each layer writes its K/V at the cache's
    device index and attends over the whole cache; the cache advances by s after the
    stack. Returns the final-normed hidden states."""
    lm, lcfg = model.lm, cfg.lm
    b, s, _ = embeds.shape
    device = embeds.device
    if is_opt(cfg):
        x = embeds + opt.position_embeds(lm, lcfg, positions, embeds.dtype)
        cos = sin = None
    else:
        x = embeds
        cos, sin = rope_cos_sin(positions, lcfg.resolved_head_dim(), lcfg.rope_theta)
    if cache is not None:
        if cache.host_index + s > cache.capacity:
            raise ValueError(f"KV cache of {cache.capacity} slots cannot take "
                             f"{cache.host_index} + {s} positions")
        kv_pos = torch.arange(cache.capacity, device=device)[None, None, None, :]
        slots = cache.index + torch.arange(s, device=device)
        mask = kv_pos <= positions[:, None, :, None]
    else:
        slots = None
        mask = positions[:, None, :, None] >= positions[:, None, None, :]
    every = cfg.xattn.cross_every_n_layers
    for i in range(lcfg.num_layers):
        if i % every == 0:
            x = xattn_op.apply(model.xattn[i // every], x, media, mask=media_mask)
        if is_opt(cfg):
            x = opt._layer_forward(x, lm, i, lcfg, mask, cache, slots)
        else:
            x = qwen2._layer_forward(x, lm, i, lcfg, cos, sin, mask, cache, False, slots)
    if cache is not None:
        cache.advance(s)
    return final_norm(model, cfg, x)


def final_norm(model: FlamingoModel, cfg: AF2Config, x: torch.Tensor) -> torch.Tensor:
    """The LM's norm after its last layer (OPT's LayerNorm, Qwen2's RMSNorm)."""
    lm = model.lm
    if is_opt(cfg):
        return opt.final_norm(lm, x)
    final = lm.ln_f_w if isinstance(lm, qwen2.QuantQwen2) else lm.norm.weight
    return rms_norm(x, final, cfg.lm.rms_norm_eps)


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None].expand(b, t)


@torch.inference_mode()
def logits(model: FlamingoModel, cfg: AF2Config, token_ids: torch.Tensor,
           window_embeds: torch.Tensor) -> torch.Tensor:
    """Full forward where every text token may attend to all audio: [B, T] ids and
    [B, n_media, wpm, d_audio] window embeddings -> [B, T, vocab] f32."""
    media = transform_audio(model, cfg, window_embeds.to(compute_dtype(model)))
    b, t = token_ids.shape
    h = _lm_forward_with_xattn(model, cfg, _embed(model, cfg, token_ids),
                               _positions(b, t, token_ids.device), media, None)
    return _unembed(model, cfg, h)


@torch.inference_mode()
def logits_with_media_mask(model: FlamingoModel, cfg: AF2Config, token_ids: torch.Tensor,
                           window_embeds: torch.Tensor, text_media_idx: torch.Tensor,
                           n_media: int, mode: str = "last") -> torch.Tensor:
    """``logits`` with Flamingo media masking (few-shot ICL): text_media_idx [B, T] counts
    the media items seen before each token."""
    media = transform_audio(model, cfg, window_embeds.to(compute_dtype(model)))
    b, t = token_ids.shape
    mmask = xattn_op.media_mask(text_media_idx, n_media, window_embeds.shape[2], mode=mode)
    h = _lm_forward_with_xattn(model, cfg, _embed(model, cfg, token_ids),
                               _positions(b, t, token_ids.device), media, mmask)
    return _unembed(model, cfg, h)


@torch.inference_mode()
def prefill(model: FlamingoModel, cfg: AF2Config, token_ids: torch.Tensor,
            window_embeds: torch.Tensor, capacity: int,
            text_media_idx: torch.Tensor | None = None, media_mode: str = "last",
            prompt_len: int | None = None, cache: qwen2.KVCache | None = None):
    """Prompt + CLAP windows -> (cache, media, last-token logits [B, vocab] f32). The media
    are transformed once here for every decode step. text_media_idx: optional [B, T]
    media ordinals for Flamingo masking of the prompt. prompt_len: the true length of a
    right-padded prompt (its last real row's logits; the cache index set to it).
    ``cache``: a cache of that capacity to write into (a held decode step's)."""
    b, t = token_ids.shape
    dtype = compute_dtype(model)
    media = transform_audio(model, cfg, window_embeds.to(dtype))
    if cache is None:
        cache = _init_cache(cfg, b, capacity, dtype, token_ids.device)
    elif cache.capacity != capacity:
        raise ValueError(f"a cache of {cache.capacity} slots for a capacity of {capacity}")
    else:
        cache.rewind(0)
    mmask = None
    if text_media_idx is not None:
        mmask = xattn_op.media_mask(text_media_idx, window_embeds.shape[1],
                                    window_embeds.shape[2], mode=media_mode)
    h = _lm_forward_with_xattn(model, cfg, _embed(model, cfg, token_ids),
                               _positions(b, t, token_ids.device), media, mmask, cache)
    if prompt_len is None:
        return cache, media, _unembed(model, cfg, h[:, -1])
    cache.rewind(prompt_len)
    return cache, media, _unembed(model, cfg, h[:, prompt_len - 1])


@torch.inference_mode()
def decode_step(model: FlamingoModel, cfg: AF2Config, cache: qwen2.KVCache,
                media: torch.Tensor, token: torch.Tensor, position: torch.Tensor,
                decode_media_mask: torch.Tensor | None = None):
    """One decode step with gated cross-attention to the fixed media: [B] tokens at
    ``position`` (a 0-dim int64 device tensor) -> (cache, [B, vocab] f32 logits).
    decode_media_mask: optional [B, 1, 1, S]. Reads nothing back to the host."""
    embeds = _embed(model, cfg, token[:, None])
    h = _lm_forward_with_xattn(model, cfg, embeds, position.expand(token.shape[0], 1), media,
                               decode_media_mask, cache)
    return cache, _unembed(model, cfg, h[:, 0])


# ------------------------------------------------------------------------------- generate

@dataclass
class FlamingoDecodeState(gen.DecodeState):
    """``generate.DecodeState`` with the media a step attends to: buffers of the state,
    which each generate fills (a captured step reads them in place)."""

    media: torch.Tensor | None = None        # [B, S, d_audio] transformed media
    media_mask: torch.Tensor | None = None   # [B, 1, 1, S] decode media mask, or None

    def nbytes(self) -> dict:
        out = super().nbytes()
        out["state"] += sum(t.numel() * t.element_size() for t in (self.media, self.media_mask)
                            if t is not None)
        return out


def new_state(model: FlamingoModel, cfg: AF2Config, spec: gen.DecodeSpec, batch: int,
              capacity: int, media_shape: tuple, mask_shape: tuple | None,
              device: torch.device, generator: torch.Generator | None) -> FlamingoDecodeState:
    """A decode state over a new cache, with zeroed media (and mask) buffers."""
    dtype = compute_dtype(model)
    st = gen.new_state(cfg.lm, spec, _init_cache(cfg, batch, capacity, dtype, device),
                       generator)
    return FlamingoDecodeState(
        **vars(st), media=torch.zeros(media_shape, dtype=dtype, device=device),
        media_mask=(None if mask_shape is None else
                    torch.zeros(mask_shape, dtype=torch.bool, device=device)))


def decode_body(model: FlamingoModel, cfg: AF2Config, spec: gen.DecodeSpec,
                st: FlamingoDecodeState) -> None:
    """``generate.decode_body`` with the flamingo stack's decode step over ``st``'s media."""
    gen.decode_body(model, cfg, spec, st, model_step=lambda s: decode_step(
        model, cfg, s.cache, s.media, s.tok, s.position, s.media_mask)[1])


@torch.inference_mode()
def generate(model: FlamingoModel, cfg: AF2Config, token_ids: torch.Tensor,
             window_embeds: torch.Tensor, *, max_new_tokens: int = 64, capacity: int = 0,
             eos_token_id: int = -1, sampling: SamplingParams = SamplingParams(),
             generator: torch.Generator | None = None,
             text_media_idx: torch.Tensor | None = None, media_mode: str = "last",
             prompt_len: int | None = None, stop_sequences: tuple = (),
             return_logprobs: bool = False) -> gen.GenerateOutput:
    """AF1/AF2 generation: [B, T] ids and [B, n_media, wpm, d_audio] window embeddings ->
    ``generate.GenerateOutput``. The options are ``runtime/generate.generate``'s (EOS,
    sampling, repetition penalty over the prompt and the tokens so far, the n-gram ban on
    an exact prompt, stop sequences, log-probabilities). With text_media_idx the prompt
    uses Flamingo media masking and the generated tokens attend per ``media_mode`` ('last'
    = only the final clip). capacity=0 rounds T + max_new_tokens up to a multiple of 128."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    b, t = token_ids.shape
    device = token_ids.device
    if prompt_len is not None and sampling.no_repeat_ngram_size > 0:
        raise ValueError("no_repeat_ngram_size needs the exact prompt (no bucket padding)")
    stop_sequences = tuple(tuple(int(x) for x in seq) for seq in stop_sequences)
    true_len = t if prompt_len is None else int(prompt_len)
    capacity = gen._capacity(t, true_len, max_new_tokens, capacity)
    spec = gen.DecodeSpec(max_new_tokens, eos_token_id, sampling, stop_sequences,
                          return_logprobs)
    n_media, wpm = window_embeds.shape[1], window_embeds.shape[2]
    media_shape = (b, n_media * wpm, cfg.audio_embed_dim)
    decode_mask = None
    if text_media_idx is not None:   # generated tokens come after every media item
        decode_mask = xattn_op.media_mask(
            torch.full((b, 1), n_media, dtype=torch.long, device=device), n_media, wpm,
            mode=media_mode)
    mask_shape = None if decode_mask is None else tuple(decode_mask.shape)
    key = (("flamingo", media_shape, mask_shape)
           + gen.graph_key(model, cfg, spec, b, capacity, compute_dtype(model), device))

    def make_state(g):
        return new_state(model, cfg, spec, b, capacity, media_shape, mask_shape, device, g)

    with gen.Decoder(model, cfg, spec, key, make_state, device, generator,
                     body=decode_body) as dec:
        st = dec.state
        t0 = time.perf_counter()
        _, media, first_logits = prefill(model, cfg, token_ids, window_embeds, capacity,
                                         text_media_idx=text_media_idx, media_mode=media_mode,
                                         prompt_len=prompt_len, cache=st.cache)
        st.media.copy_(media)
        if decode_mask is not None:
            st.media_mask.copy_(decode_mask)
        gen.start_decode(st, spec, first_logits, token_ids.long(), true_len, generator)
        dec.started()
        gen.sync(device)
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        steps = gen.run_decode(st, max_new_tokens, dec.step)
        gen.sync(device)
        decode_s = time.perf_counter() - t1
        out = st.out.clone()
        logprobs = st.logprobs.clone() if return_logprobs else None

    return gen.GenerateOutput(
        tokens=out, lengths=gen.output_lengths(out, eos_token_id, stop_sequences),
        first_logits=first_logits, ttft_s=ttft, decode_s=decode_s, decode_steps=steps,
        logprobs=logprobs, capture_s=dec.capture_s)
