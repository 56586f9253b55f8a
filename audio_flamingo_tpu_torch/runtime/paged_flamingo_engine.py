"""The paged engine of the AF1/AF2 (gated-xattn) family, as
``audio_flamingo_tpu/runtime/paged_flamingo_engine.py``.

``PagedFlamingoEngine`` is ``runtime/paged_engine.PagedEngine`` (pages of one shared pool
mapped through block tables, rows grown lazily, preemption to host memory and resume, the
prefix cache, chunked prefill, speculation with ``preempt=False``, the beam lane) with a
per-row media buffer: a request's CLAP windows, padded to the engine's fixed shape, are
transformed once at admission and kept in its row of ``media`` [rows, S, d_audio] (swapped
out and back with its pages). Gated cross-attention makes every position depend on the
audio, so the prefix cache's block keys fold the windows' digest into every block.

A decode step (``xattn_paged_step``) runs the AF1/AF2 layer loop
(``flamingo_engine.xattn_stack``) with each layer's self-attention through the pages:
``paged_attention`` (K3) on the stacked pool at the layer's index, one call a layer, the
current token folded in by ``merge_current_token``; every layer's new K/V goes to its page
after the loop as one batched scatter over [L, B], and the pool is never sliced into a
per-layer copy. AF2's Qwen2 runs K3 at hd 128 over its GQA groups; AF1's OPT at hd 64,
g = 1, scale 1 (its q is scaled before the product). A speculative verify
(``xattn_paged_verify``) folds its k + 1 tokens into K3's group axis and merges the
block's own triangle with ``merge_block_tokens``.

``attn_impl`` keeps JAX's three values. JAX's "auto" picks a dense gather for small
non-int8 pools because a Pallas call has a fixed cost on a TPU; that rule is the TPU's,
so here "auto" and "kernel" both call ``paged_attention`` (K3 on a CUDA tensor, its plain
version on a CPU one) for every pool, and "dense" is the caller's explicit pin to
``paged_attention_reference``, as in JAX.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF2Config
from audio_flamingo_tpu_torch.models import flamingo
from audio_flamingo_tpu_torch.ops.kernels.paged_attention import (merge_block_tokens,
                                                                  merge_current_token,
                                                                  paged_attention,
                                                                  paged_attention_reference)
from audio_flamingo_tpu_torch.runtime import beam_lane
from audio_flamingo_tpu_torch.runtime.engine import (_start_request_metrics, spec_chunk_rounds,
                                                     spec_step)
from audio_flamingo_tpu_torch.runtime.flamingo_engine import (FlamingoRequest,
                                                              check_xattn_spec_request,
                                                              kv_geometry, pad_windows,
                                                              xattn_stack)
from audio_flamingo_tpu_torch.runtime.paged_cache import (PagedKV, _current_kv, _write_step_kv,
                                                          init_paged, paged_install_pages,
                                                          paged_prefill_suffix)
from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine, _block_keys

ATTN_IMPLS = ("auto", "kernel", "dense")


def _paged_attn_fn(attn_impl: str):
    """``paged_attention`` for "auto" and "kernel", ``paged_attention_reference`` for the
    "dense" pin (JAX :48 without the TPU's size rule)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl is one of {ATTN_IMPLS}, not {attn_impl!r}")
    return paged_attention_reference if attn_impl == "dense" else paged_attention


def _page_slots(cache: PagedKV, pos_grid: torch.Tensor):
    """The (page, offset) each position [B, s] writes to (dead rows: the trash page)."""
    bs = cache.block_size
    page_pos = (pos_grid // bs).clamp(max=cache.max_blocks - 1)
    block_ids = torch.gather(cache.block_tables.long(), 1, page_pos).clamp(min=0)
    return block_ids, pos_grid % bs


@torch.inference_mode()
def xattn_paged_step(model: flamingo.FlamingoModel, cfg: AF2Config, cache: PagedKV,
                     media: torch.Tensor, tokens: torch.Tensor, attn_impl: str = "auto"):
    """One decode step for every row through its pages and the gated xattn blocks (JAX
    :76): tokens [B] at positions ``cache.lengths``, media [B, S, d_audio]. Returns (cache
    with lengths + 1, logits [B, vocab] f32). As ``paged_decode_chunk``'s ``step`` it makes
    that loop JAX's ``paged_decode_chunk_xattn`` (:352)."""
    attn_fn = _paged_attn_fn(attn_impl)
    b = tokens.shape[0]
    nkv, hd, g, scale = kv_geometry(cfg)
    nh = cfg.lm.num_heads
    positions = cache.lengths.long()[:, None]
    block_ids, offs = _page_slots(cache, positions)
    new: list = []

    def attend_layer(i: int):
        def attend(q, k, v):
            qg = q[:, 0].reshape(b, nkv, g, hd)
            o, m, l = attn_fn(qg, cache.k, cache.v, cache.block_tables, cache.lengths, i,
                              k_scale=cache.k_scale, v_scale=cache.v_scale, scale=scale)
            store, k_cur, v_cur = _current_kv(cache, k[:, 0], v[:, 0])
            new.append(store)
            return merge_current_token(qg, k_cur, v_cur, o, m, l,
                                       scale=scale).reshape(b, 1, nh, hd)
        return attend

    x = xattn_stack(model, cfg, flamingo._embed(model, cfg, tokens[:, None]), positions, media,
                    attend_layer)
    _write_step_kv(cache, new, block_ids[:, 0], offs[:, 0])
    cache.lengths = cache.lengths + 1
    return cache, flamingo._unembed(model, cfg, x[:, 0])


@torch.inference_mode()
def xattn_paged_verify(model: flamingo.FlamingoModel, cfg: AF2Config, cache: PagedKV,
                       media: torch.Tensor, tokens: torch.Tensor, attn_impl: str = "auto"):
    """S-token speculative verify through the pages and the gated xattn blocks (JAX :195):
    tokens [B, S] at positions lengths .. lengths + S - 1. Per layer the S queries of a row
    fold into K3's group axis (one call over the past pages, g' = S g) and
    ``merge_block_tokens`` adds the block's own causal triangle; every token's K/V is
    written to its page, ``lengths`` comes back unchanged (the caller advances it by the
    accepted count). Returns (cache, logits [B, S, vocab] f32)."""
    attn_fn = _paged_attn_fn(attn_impl)
    b, s = tokens.shape
    nkv, hd, g, scale = kv_geometry(cfg)
    nh = cfg.lm.num_heads
    pos_grid = cache.lengths.long()[:, None] + torch.arange(s, device=tokens.device)[None]
    block_ids, offs = _page_slots(cache, pos_grid)
    new: list = []

    def attend_layer(i: int):
        def attend(q, k, v):
            qf = q.reshape(b, s, nkv, g, hd).transpose(1, 2).reshape(b, nkv, s * g, hd)
            o, m, l = attn_fn(qf, cache.k, cache.v, cache.block_tables, cache.lengths, i,
                              k_scale=cache.k_scale, v_scale=cache.v_scale, scale=scale)
            o = o.reshape(b, nkv, s, g, hd).transpose(1, 2)
            m = m.reshape(b, nkv, s, g).transpose(1, 2)
            l = l.reshape(b, nkv, s, g).transpose(1, 2)
            store, k_cur, v_cur = _current_kv(cache, k, v)
            new.append(tuple(t.reshape(b * s, *t.shape[2:]) for t in store))
            attn = merge_block_tokens(q.reshape(b, s, nkv, g, hd), k_cur, v_cur, o, m, l,
                                      scale=scale)
            return attn.reshape(b, s, nh, hd)
        return attend

    x = xattn_stack(model, cfg, flamingo._embed(model, cfg, tokens), pos_grid, media,
                    attend_layer)
    _write_step_kv(cache, new, block_ids.reshape(-1), offs.reshape(-1))
    return cache, flamingo._unembed(model, cfg, x)


@torch.inference_mode()
def paged_decode_spec_chunk_xattn(model: flamingo.FlamingoModel, draft, cfg: AF2Config,
                                  draft_cfg, cache: PagedKV, d_cache, tokens: torch.Tensor,
                                  done: torch.Tensor, generator: torch.Generator | None = None,
                                  *, media: torch.Tensor, k: int, rounds: int,
                                  eos_token_id: int, sampling=None,
                                  accept_sim: float | None = None, attn_impl: str = "auto"):
    """Speculation over the paged pool (JAX :324): ``engine.spec_chunk_rounds`` with a
    text-only Qwen2 draft and ``xattn_paged_verify`` as the target's verify; the greedy
    rule for sampling None or greedy, the Leviathan rule otherwise."""
    return spec_chunk_rounds(
        draft, draft_cfg, cache, d_cache, tokens, done, generator, k=k, rounds=rounds,
        eos_token_id=eos_token_id, nv=cfg.lm.vocab_size,
        verify=lambda c, seq: xattn_paged_verify(model, cfg, c, media, seq, attn_impl),
        sampling=sampling, accept_sim=accept_sim)


def _xattn_suffix_forward(model: flamingo.FlamingoModel, cfg: AF2Config, cache: PagedKV,
                          prefix_page_ids, suffix_ids: torch.Tensor, media: torch.Tensor,
                          prompt_len: int, *, n_prefix_pages: int, suffix_len: int):
    """``paged_cache.paged_prefill_suffix`` over the xattn stack (JAX :432): the prefix
    pages gathered (and dequantized) into a contiguous cache, the suffix ids at their
    offset positions through the stack against the media. Returns (suffix K, V [L, 1,
    suffix_len, nkv, hd], the last prompt token's logits [1, vocab] f32)."""
    dtype = flamingo.compute_dtype(model)
    media = media.to(dtype)
    return paged_prefill_suffix(
        model.lm, cfg.lm, cache, prefix_page_ids, flamingo._embed(model, cfg, suffix_ids),
        prompt_len, n_prefix_pages=n_prefix_pages, suffix_len=suffix_len,
        forward=lambda emb, pos, kv: flamingo._lm_forward_with_xattn(model, cfg, emb, pos, media,
                                                                   None, cache=kv),
        unembed=lambda h: flamingo._unembed(model, cfg, h))


@torch.inference_mode()
def flamingo_prefill_suffix(model: flamingo.FlamingoModel, cfg: AF2Config, cache: PagedKV,
                            prefix_page_ids, suffix_ids: torch.Tensor,
                            window_embeds: torch.Tensor, prompt_len: int, *,
                            n_prefix_pages: int, suffix_len: int):
    """Prefill only a prompt's suffix against prefix K/V already in pages (JAX :393): the
    media are transformed here (a hit shares pages only when ids and audio match) ->
    (media [1, S, d], suffix K, V, last-token logits)."""
    media = flamingo.transform_audio(model, cfg, window_embeds.to(flamingo.compute_dtype(model)))
    return (media, *_xattn_suffix_forward(model, cfg, cache, prefix_page_ids, suffix_ids, media,
                                          prompt_len, n_prefix_pages=n_prefix_pages,
                                          suffix_len=suffix_len))


@torch.inference_mode()
def flamingo_prefill_chunk(model: flamingo.FlamingoModel, cfg: AF2Config, cache: PagedKV,
                           prefix_page_ids, chunk_ids: torch.Tensor, media: torch.Tensor,
                           prompt_len: int, *, n_prefix_pages: int, chunk_len: int):
    """One chunk of a chunked xattn prefill against already filled pages (JAX :418), the
    media transformed once at its start -> (chunk K, V, logits at the chunk's last real
    token)."""
    return _xattn_suffix_forward(model, cfg, cache, prefix_page_ids, chunk_ids, media,
                                 prompt_len, n_prefix_pages=n_prefix_pages,
                                 suffix_len=chunk_len)


@dataclass
class PagedFlamingoEngine(PagedEngine):
    """``PagedEngine`` for AF1/AF2 (JAX ``PagedFlamingoEngine`` :474): ``model`` a
    ``FlamingoModel`` with its ``AF2Config``, requests ``FlamingoRequest`` (windows padded
    to ``n_media`` x ``windows_per_media``), the pool's heads the LM's (``kv_geometry``),
    ``kv_dtype=torch.int8`` an int8 pool. Every other option is ``PagedEngine``'s;
    speculation needs ``preempt=False``. ``device=None`` means CUDA (an error without a
    card)."""

    model: flamingo.FlamingoModel
    cfg: AF2Config
    num_blocks: int = 64
    block_size: int = 64
    max_blocks_per_seq: int = 8
    n_media: int = 1
    windows_per_media: int = 1
    attn_impl: str = "auto"          # "auto" | "kernel": K3; "dense": the dense reference

    def __post_init__(self):
        _paged_attn_fn(self.attn_impl)
        super().__post_init__()
        self.media = torch.zeros((self.num_rows, self.n_media * self.windows_per_media,
                                  self.cfg.audio_embed_dim),
                                 dtype=flamingo.compute_dtype(self.model), device=self.device)

    def _new_pool(self) -> PagedKV:
        nkv, hd, _, _ = kv_geometry(self.cfg)
        return init_paged(self.cfg.lm, self.num_rows, self.num_blocks, self.block_size,
                          self.max_blocks_per_seq,
                          self.kv_dtype or flamingo.compute_dtype(self.model), self.device,
                          kv_heads=(nkv, hd))

    def submit(self, req: FlamingoRequest) -> None:
        if req.ids.shape[1] > self.capacity:
            raise ValueError(f"prompt ({req.ids.shape[1]} tokens) exceeds row capacity "
                             f"({self.capacity} = max_blocks_per_seq * block_size)")
        check_xattn_spec_request(self, req)
        _start_request_metrics(req)
        self.queue.append(req)

    def submit_beam(self, req) -> None:
        """Queue an AF1/AF2 beam request, served by the xattn beam lane between paged
        decode rounds (the lane owns its K cache rows)."""
        beam_lane.attach_beam_lane(self, "xattn", self._pad_windows).submit(req)

    def _pad_windows(self, we) -> torch.Tensor:
        return pad_windows(self.cfg, self.n_media, self.windows_per_media, we, self.device)

    def _media(self, req: FlamingoRequest) -> torch.Tensor:
        wins = self._pad_windows(req.window_embeds)
        return flamingo.transform_audio(self.model, self.cfg,
                                        wins.to(flamingo.compute_dtype(self.model)))

    def _prefix_keys(self, req: FlamingoRequest):
        digest = None
        if req.window_embeds is not None:
            digest = hashlib.blake2b(np.ascontiguousarray(req.window_embeds).tobytes(),
                                     digest_size=16).digest()
        # every block folds in the media digest: xattn makes each position audio-dependent
        return (_block_keys(np.asarray(req.ids[0]), self.block_size, digest, 0),
                np.empty((0,), np.int64))

    def _prefill_pages(self, row: int, req: FlamingoRequest, bucket: int, n_hit: int,
                       prefix_pages: list[int], blocks: list[int], audio_pos) -> torch.Tensor:
        t = req.ids.shape[1]
        ids = self._padded_ids(req, bucket)
        if n_hit:
            start = n_hit * self.block_size
            media, sub_k, sub_v, logits = flamingo_prefill_suffix(
                self.model, self.cfg, self.cache, prefix_pages, ids[:, start:],
                self._pad_windows(req.window_embeds), t, n_prefix_pages=n_hit,
                suffix_len=bucket - start)
        else:
            sub, media, logits = flamingo.prefill(self.model, self.cfg, ids,
                                                  self._pad_windows(req.window_embeds), bucket,
                                                  prompt_len=t if bucket != t else None)
            sub_k, sub_v = sub.k, sub.v
        paged_install_pages(self.cache, sub_k, sub_v, blocks)
        self.media[row] = media[0].to(self.media.dtype)
        return logits

    def _chunk_inputs(self, req: FlamingoRequest, row: int, bucket: int, start0: int,
                      audio_pos) -> dict:
        # the media are transformed once; the reserved row holds them from here (a row
        # that is not live is never read)
        media = self._media(req)
        self.media[row] = media[0].to(self.media.dtype)
        return dict(ids=self._padded_ids(req, bucket), media=media)

    def _prefill_chunk(self, st: dict, start: int, end: int, prefix_pages: list[int]):
        return flamingo_prefill_chunk(self.model, self.cfg, self.cache, prefix_pages,
                                      st["ids"][:, start:end], st["media"],
                                      st["t"] if end >= st["t"] else end,
                                      n_prefix_pages=len(prefix_pages), chunk_len=end - start)

    def _preempt_row(self, row: int) -> None:
        req = self.active[row][0]
        media = self.media[row].cpu()
        super()._preempt_row(row)
        self.swapped[req.request_id]["media"] = media

    def _resume_row(self, req: FlamingoRequest, row: int) -> bool:
        media = self.swapped[req.request_id]["media"]
        if not super()._resume_row(req, row):
            return False
        self.media[row] = media.to(self.device)
        return True

    def _spec_chunk(self):
        chunk = functools.partial(paged_decode_spec_chunk_xattn, media=self.media,
                                  attn_impl=self.attn_impl)
        return spec_step(self, self.model, self.cfg, chunk, chunk)

    def _step_fn(self):
        return lambda cache, tokens: xattn_paged_step(self.model, self.cfg, cache, self.media,
                                                      tokens, self.attn_impl)
