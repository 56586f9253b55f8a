"""The slot engine of the AF1/AF2 (gated-xattn) family, as
``audio_flamingo_tpu/runtime/flamingo_engine.py``.

``FlamingoEngine`` is ``runtime/engine.BatchEngine`` with a media buffer beside the KV
slots: a request's CLAP window embeddings are padded to the engine's fixed shape
(``n_media`` x ``windows_per_media``), transformed once at its prefill
(``prefill_into_slot_xattn``) and kept in its slot's row of ``media`` [slots, S, d_audio],
which every decode step of that slot attends. Rows at different offsets decode together:
``_rows_forward_xattn`` writes each row's K/V at its own position and runs the gated xattn
block before every ``cross_every_n_layers``-th LM layer (``xattn_stack``, the layer loop
``models/flamingo._lm_forward_with_xattn`` runs, with the engine's cache in each layer's
attention). The LM is Qwen2 (AF2: float, int8 or fused-w4 trees, their products through
K4 and K5; K6 cannot run between xattn blocks) or OPT (AF1: every head its own KV head of
hidden / heads, q scaled before the product). Greedy rows equal single-request
``flamingo.generate`` token for token.

With a draft (a text-only Qwen2 sharing the ids) the engine speculates:
``decode_spec_chunk_xattn`` is ``engine.spec_chunk_rounds`` with the multi-token
``_rows_forward_xattn`` as the target's verify, the greedy rule for a greedy engine and the
Leviathan rule otherwise (one warp, the engine's sampling, for every row; a request's own
sampling must equal it). Beam requests ride the beam lane (``family="xattn"``), their
windows padded as admission pads them. The step is eager and reads the device once per
chunk, as the AF3 engines' is.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF2Config
from audio_flamingo_tpu_torch.models import flamingo, opt, qwen2
from audio_flamingo_tpu_torch.ops import xattn as xattn_op
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.rope import rope_cos_sin
from audio_flamingo_tpu_torch.runtime import beam_lane
from audio_flamingo_tpu_torch.runtime.engine import (BatchEngine, Request, SlotCache,
                                                     _start_request_metrics, spec_chunk_rounds,
                                                     spec_step, speculating)


def kv_geometry(cfg: AF2Config) -> tuple:
    """(KV heads, head dim, query heads a KV head, attention scale) of the LM's cache: OPT
    keeps every head its own KV head of hidden / heads and scales q before the product
    (scale 1); Qwen2 its GQA heads at the default hd ** -0.5 (None)."""
    lcfg = cfg.lm
    if flamingo.is_opt(cfg):
        return lcfg.num_heads, lcfg.hidden_size // lcfg.num_heads, 1, 1.0
    return (lcfg.num_kv_heads, lcfg.resolved_head_dim(), lcfg.num_heads // lcfg.num_kv_heads,
            None)


def xattn_stack(model: flamingo.FlamingoModel, cfg: AF2Config, embeds: torch.Tensor,
                pos_grid: torch.Tensor, media: torch.Tensor, attend_layer) -> torch.Tensor:
    """The AF1/AF2 decoder stack over the engines' caches (JAX ``_rows_forward_xattn`` and
    ``_xattn_paged_step``'s layer loop): embeds [B, s, d] at positions pos_grid [B, s];
    before layer i, when i % every == 0, the gated xattn block i // every against media
    [B, S, d_audio]; layer i's attention through ``attend_layer(i)(q, k, v)`` -> [B, s, nh,
    hd], which writes the caller's cache (OPT's q comes scaled). Returns the final-normed
    hidden states."""
    lm, lcfg = model.lm, cfg.lm
    is_opt = flamingo.is_opt(cfg)
    if is_opt:
        x = embeds + opt.position_embeds(lm, lcfg, pos_grid, embeds.dtype)
        cos = sin = None
    else:
        x = embeds
        cos, sin = rope_cos_sin(pos_grid, lcfg.resolved_head_dim(), lcfg.rope_theta)
    every = cfg.xattn.cross_every_n_layers
    for i in range(lcfg.num_layers):
        if i % every == 0:
            x = xattn_op.apply(model.xattn[i // every], x, media)
        if is_opt:
            x = opt._layer_forward(x, lm, i, lcfg, None, attend=attend_layer(i))
        else:
            x = qwen2.layer_attend(x, lm, i, lcfg, cos, sin, attend_layer(i))
    return flamingo.final_norm(model, cfg, x)


def _rows_forward_xattn(model: flamingo.FlamingoModel, cfg: AF2Config, embeds: torch.Tensor,
                        positions: torch.Tensor, cache: SlotCache, media: torch.Tensor):
    """Decode forward for every row at its own offset (JAX :48): token i of row b is written
    at positions[b] + i (in place) and attends the positions <= positions[b] + i, so a
    block of s > 1 tokens (a speculative verify) is causal per row. Returns (final-normed
    hidden states, cache)."""
    b, s, _ = embeds.shape
    device = embeds.device
    pos_grid = positions.long()[:, None] + torch.arange(s, device=device)[None]    # [B, s]
    kv_pos = torch.arange(cache.k.shape[2], device=device)
    mask = kv_pos[None, None, None, :] <= pos_grid[:, None, :, None]              # [B,1,s,C]
    rows = torch.arange(b, device=device)[:, None].expand(b, s)
    scale = kv_geometry(cfg)[3]

    def attend_layer(i: int):
        def attend(q, k, v):
            ck, cv = cache.k[i], cache.v[i]
            ck.index_put_((rows, pos_grid), k.to(ck.dtype))
            cv.index_put_((rows, pos_grid), v.to(cv.dtype))
            return gqa_attention(q, ck.to(q.dtype), cv.to(q.dtype), mask=mask, scale=scale)
        return attend

    return xattn_stack(model, cfg, embeds, pos_grid, media, attend_layer), cache


def _slot_step(model: flamingo.FlamingoModel, cfg: AF2Config, media: torch.Tensor):
    """One decode step of every slot at ``cache.lengths`` -> (cache, logits [B, V] f32):
    with it ``engine.decode_chunk`` is JAX's ``decode_chunk_xattn`` (:166)."""
    def step(cache: SlotCache, tokens: torch.Tensor):
        h, cache = _rows_forward_xattn(model, cfg, flamingo._embed(model, cfg, tokens[:, None]),
                                       cache.lengths, cache, media)
        return cache, flamingo._unembed(model, cfg, h[:, 0])
    return step


def _slot_verify(model: flamingo.FlamingoModel, cfg: AF2Config, media: torch.Tensor):
    """The slot engine's verify: the multi-token ``_rows_forward_xattn`` (JAX :150)."""
    def verify(cache: SlotCache, seq: torch.Tensor):
        h, cache = _rows_forward_xattn(model, cfg, flamingo._embed(model, cfg, seq),
                                       cache.lengths, cache, media)
        return cache, flamingo._unembed(model, cfg, h)
    return verify


@torch.inference_mode()
def decode_spec_chunk_xattn(model: flamingo.FlamingoModel, draft, cfg: AF2Config, draft_cfg,
                            cache: SlotCache, d_cache: SlotCache, tokens: torch.Tensor,
                            done: torch.Tensor, generator: torch.Generator | None = None, *,
                            media: torch.Tensor, k: int, rounds: int, eos_token_id: int,
                            sampling=None, accept_sim: float | None = None):
    """Speculation over the slots (JAX :134): ``engine.spec_chunk_rounds`` with a text-only
    Qwen2 draft on its dense cache and the multi-token ``_rows_forward_xattn`` as the
    verify. sampling None or greedy: the greedy rule (emitted tokens equal target-only
    greedy; ``accept_sim`` a measurement mode); otherwise the Leviathan rule. Returns
    (cache, d_cache, tokens, done, out [B, rounds (k + 1)], valid)."""
    return spec_chunk_rounds(draft, draft_cfg, cache, d_cache, tokens, done, generator, k=k,
                             rounds=rounds, eos_token_id=eos_token_id, nv=cfg.lm.vocab_size,
                             verify=_slot_verify(model, cfg, media), sampling=sampling,
                             accept_sim=accept_sim)


@torch.inference_mode()
def prefill_into_slot_xattn(model: flamingo.FlamingoModel, cfg: AF2Config, cache: SlotCache,
                            media_buf: torch.Tensor, slot: int, token_ids: torch.Tensor,
                            window_embeds: torch.Tensor, *, prompt_len: int | None = None):
    """Prefill ONE request (batch 1) into row ``slot`` of the cache and its transformed
    media into row ``slot`` of ``media_buf``, in place (JAX :210). token_ids may be
    right-padded to a bucket with ``prompt_len`` the true length. Returns (cache,
    media_buf, first-token logits [V])."""
    row = qwen2.KVCache(k=cache.k[:, slot:slot + 1], v=cache.v[:, slot:slot + 1])
    _, media, logits = flamingo.prefill(model, cfg, token_ids, window_embeds,
                                        cache.k.shape[2], prompt_len=prompt_len, cache=row)
    lengths = cache.lengths.clone()
    lengths[slot] = token_ids.shape[1] if prompt_len is None else prompt_len
    cache.lengths = lengths
    media_buf[slot] = media[0].to(media_buf.dtype)
    return cache, media_buf, logits[0]


@dataclass
class FlamingoRequest(Request):
    """An AF1/AF2 request: ``window_embeds`` [1, n_media, windows, d_audio] CLAP features
    (numpy, already encoded: the CLAP tower runs in the processor)."""

    window_embeds: np.ndarray | None = None


def check_xattn_spec_request(engine, req) -> None:
    """The speculative xattn path's refusals (JAX ``submit``): it applies the engine's
    sampling to every row, and takes no EOS floor, stop sequences or logprobs."""
    if not speculating(engine):
        return
    if req.sampling is not None and req.sampling != engine.sampling:
        raise ValueError("the speculative xattn path applies the engine's sampling to every "
                         "row; per-request sampling must equal it")
    if req.min_new_tokens or req.stop or req.logprobs:
        raise ValueError("min_new_tokens/stop/logprobs are not supported on the speculative "
                         "path")


def pad_windows(cfg: AF2Config, n_media: int, windows_per_media: int, we, device) -> torch.Tensor:
    """Zero-pad window embeddings to the engine's fixed [1, n_media, W, d_audio] (JAX
    ``_pad_windows``): zero windows are what the tanh gates learn to discount, and shapes
    that already match are exact."""
    full = np.zeros((1, n_media, windows_per_media, cfg.audio_embed_dim), np.float32)
    if we is not None:
        we = np.asarray(we, np.float32)
        full[:, :we.shape[1], :we.shape[2]] = we
    return torch.from_numpy(full).to(device)


@dataclass
class FlamingoEngine(BatchEngine):
    """``BatchEngine`` for AF1/AF2 (JAX ``FlamingoEngine`` :239): ``model`` a
    ``FlamingoModel`` with its ``AF2Config``, requests ``FlamingoRequest``, every request's
    windows padded to ``n_media`` x ``windows_per_media``. Speculation (``draft_params``,
    ``draft_cfg``, ``spec_*``) and the beam lane as ``BatchEngine``'s. ``device=None``
    means CUDA (an error without a card)."""

    model: flamingo.FlamingoModel
    cfg: AF2Config
    capacity: int = 1024
    n_media: int = 1                 # the media buffer's shape: requests padded to it
    windows_per_media: int = 1

    def __post_init__(self):
        super().__post_init__()
        self.media = torch.zeros((self.num_slots, self.n_media * self.windows_per_media,
                                  self.cfg.audio_embed_dim),
                                 dtype=flamingo.compute_dtype(self.model), device=self.device)

    def _new_cache(self) -> SlotCache:
        nkv, hd, _, _ = kv_geometry(self.cfg)
        shape = (self.cfg.lm.num_layers, self.num_slots, self.capacity, nkv, hd)
        dtype = flamingo.compute_dtype(self.model)
        return SlotCache(torch.zeros(shape, dtype=dtype, device=self.device),
                         torch.zeros(shape, dtype=dtype, device=self.device),
                         torch.zeros((self.num_slots,), dtype=torch.int32, device=self.device))

    def submit(self, req: FlamingoRequest) -> None:
        if req.ids.shape[1] > self.capacity:
            raise ValueError(f"prompt ({req.ids.shape[1]} tokens) exceeds the slot capacity "
                             f"({self.capacity})")
        check_xattn_spec_request(self, req)
        _start_request_metrics(req)
        self.queue.append(req)

    def submit_beam(self, req) -> None:
        """Queue an AF1/AF2 beam request (``beam_lane.BeamRequest`` with
        ``window_embeds``), served by the xattn beam lane between decode rounds."""
        beam_lane.attach_beam_lane(self, "xattn", self._pad_windows).submit(req)

    def _pad_windows(self, we) -> torch.Tensor:
        return pad_windows(self.cfg, self.n_media, self.windows_per_media, we, self.device)

    def _prefill(self, slot: int, req: FlamingoRequest, ids: torch.Tensor,
                 prompt_len: int | None) -> torch.Tensor:
        self.cache, self.media, logits = prefill_into_slot_xattn(
            self.model, self.cfg, self.cache, self.media, slot, ids,
            self._pad_windows(req.window_embeds), prompt_len=prompt_len)
        return logits

    def _spec_chunk(self):
        chunk = functools.partial(decode_spec_chunk_xattn, media=self.media)
        return spec_step(self, self.model, self.cfg, chunk, chunk)

    def _step_fn(self):
        return _slot_step(self.model, self.cfg, self.media)
