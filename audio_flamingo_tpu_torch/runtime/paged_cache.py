"""Paged KV cache, as ``audio_flamingo_tpu/runtime/paged_cache.py``: fixed-size pages in
one shared pool, a block table per row, and decode that reads K/V through the table.

- The pool is ``[L, num_blocks, block_size, nkv, hd]`` (the compute dtype, or int8 with
  f32 per-token scales ``[L, num_blocks, block_size, nkv]``). Every write goes into it in
  place (index assignment); a decode step hands the kernel the stacked pool and a layer
  index, never a per-layer copy.
- ``block_tables`` [B, max_blocks] int32 (-1 = unmapped) and ``lengths`` [B] int32 are
  device tensors. A step replaces ``lengths`` with a new tensor rather than writing into
  it, so a captured launch input keeps the value it had.
- ``paged_decode_chunk`` is an eager loop of ``chunk`` decode steps with no host read
  inside: done flags, lengths and tokens stay on the device; the caller reads once per
  chunk.
- ``BlockAllocator`` is the host-side free list.
- ``paged_verify_step`` is the speculative verify through the pages (JAX :251): the S
  fresh queries of a row go through ONE K3 call per layer with the token axis folded into
  the group axis (g' = S g rows a KV head), ``merge_block_tokens`` folds in the block's
  own causal triangle (an int8 pool's dequantized block), every token's K/V is written to
  its page and ``lengths`` comes back unchanged: the spec chunks
  (``paged_decode_spec_chunk`` :351, ``paged_decode_spec_chunk_sampled`` :379, the slot
  engine's ``spec_chunk_rounds`` with this verify) advance it by each row's accepted
  count, and rejected slots are overwritten before they are attended.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from audio_flamingo_tpu_torch.config import Qwen2Config
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops.kernels.paged_attention import (merge_block_tokens,
                                                                  merge_current_token,
                                                                  paged_attention)
from audio_flamingo_tpu_torch.ops.rope import rope_cos_sin
from audio_flamingo_tpu_torch.ops.sampling import RowSampling, SamplingParams, engine_row_step


@dataclass
class PagedKV:
    k: torch.Tensor             # [L, NUM_BLOCKS, BLOCK, nkv, hd] (compute dtype or int8)
    v: torch.Tensor
    block_tables: torch.Tensor  # [B, MAX_BLOCKS] int32, -1 = unmapped
    lengths: torch.Tensor       # [B] int32 tokens filled per row
    k_scale: torch.Tensor | None = None   # int8 pools: [L, NUM_BLOCKS, BLOCK, nkv] f32
    v_scale: torch.Tensor | None = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_blocks(self) -> int:
        return self.block_tables.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


def init_paged(cfg: Qwen2Config, batch: int, num_blocks: int, block_size: int,
               max_blocks_per_seq: int, dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu", kv_heads: tuple | None = None) -> PagedKV:
    """dtype=torch.int8 gives an int8 pool with per-token scales: half the page bytes.
    ``kv_heads`` (nkv, hd) replaces the config's (OPT keeps every head a KV head)."""
    nkv, hd = kv_heads or (cfg.num_kv_heads, cfg.resolved_head_dim())
    shape = (cfg.num_layers, num_blocks, block_size, nkv, hd)
    scales = None
    if dtype == torch.int8:
        scales = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    return PagedKV(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((batch, max_blocks_per_seq), -1, dtype=torch.int32, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device),
                   scales, None if scales is None else scales.clone())


@dataclass
class BlockAllocator:
    """Host-side page allocator: a free list over the pool.

    reserve: leading blocks never handed out. The engine reserves block 0 as the trash
    page: a finished row's table resets to -1, which maps to block 0, so its writes can
    never reach a page handed to another row."""

    num_blocks: int
    reserve: int = 0
    free: list = field(default_factory=list)

    def __post_init__(self):
        self.free = list(range(self.num_blocks - 1, self.reserve - 1, -1))

    def alloc(self, n: int) -> list[int]:
        if len(self.free) < n:
            raise MemoryError(f"paged cache OOM: need {n} blocks, {len(self.free)} free")
        return [self.free.pop() for _ in range(n)]

    def release(self, blocks) -> None:
        for b in blocks:
            if b >= 0:
                self.free.append(int(b))


def _current_kv(cache: PagedKV, k: torch.Tensor, v: torch.Tensor):
    """This step's K/V [B, nkv, hd] -> (what the pool stores, the K and V the merge folds
    in). An int8 pool stores codes and scales, and the merge takes their dequantized
    values, so the current token contributes what it will contribute from its page."""
    if cache.quantized:
        kq, ksc = qwen2.quantize_kv(k)
        vq, vsc = qwen2.quantize_kv(v)
        return (kq, vq, ksc, vsc), kq.float() * ksc[..., None], vq.float() * vsc[..., None]
    return (k.to(cache.k.dtype), v.to(cache.v.dtype)), k, v


def _write_step_kv(cache: PagedKV, new: list, block_ids: torch.Tensor,
                   offs: torch.Tensor) -> None:
    """Every layer's new K/V (and scales) [N, nkv(, hd)] into (layer, block, offset) of
    block_ids, offs [N], in place. Rows that point at the trash page may write the same
    slot; that page is never read."""
    n_layers, b = len(new), block_ids.shape[0]
    l_idx = torch.arange(n_layers, device=block_ids.device)[:, None].expand(n_layers, b)
    index = (l_idx.flatten(), block_ids.repeat(n_layers), offs.repeat(n_layers))
    pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale] if cache.quantized else [])
    for pool, values in zip(pools, zip(*new)):
        pool.index_put_(index, torch.stack(values).flatten(0, 1))


@torch.inference_mode()
def paged_decode_step(lm, cfg: Qwen2Config, cache: PagedKV, tokens: torch.Tensor):
    """One decode step for all rows: tokens [B] at positions ``cache.lengths``.

    Each layer attends through the block tables with ``paged_attention`` (K3; per row
    only its mapped pages are read) and folds the current token in with
    ``merge_current_token``; every layer's new K/V is written to its page after the
    layer loop (``qwen2.forward_attend``: a fused w4 LM at most 8 rows runs the two
    suffix kernels per layer, as JAX does). Returns (cache with lengths + 1, logits [B, vocab]
    f32)."""
    b = tokens.shape[0]
    hd, nkv, nh = cfg.resolved_head_dim(), cfg.num_kv_heads, cfg.num_heads
    g = nh // nkv
    positions = cache.lengths.long()
    cos, sin = rope_cos_sin(positions[:, None], hd, cfg.rope_theta)
    x = qwen2.embed(lm, tokens[:, None])
    bs = cache.block_size
    page_pos = (positions // bs).clamp(max=cache.max_blocks - 1)
    block_ids = torch.gather(cache.block_tables.long(), 1, page_pos[:, None])[:, 0].clamp(min=0)
    offs = positions % bs
    new: list = []

    def attend_layer(i: int):
        def attend(q, k, v):
            qg = q[:, 0].reshape(b, nkv, g, hd)
            o, m, l = paged_attention(qg, cache.k, cache.v, cache.block_tables, cache.lengths,
                                      i, k_scale=cache.k_scale, v_scale=cache.v_scale)
            store, k_cur, v_cur = _current_kv(cache, k[:, 0], v[:, 0])
            new.append(store)
            return merge_current_token(qg, k_cur, v_cur, o, m, l).reshape(b, 1, nh, hd)
        return attend

    x = qwen2.forward_attend(lm, cfg, x, cos, sin, attend_layer)
    _write_step_kv(cache, new, block_ids, offs)
    cache.lengths = cache.lengths + 1
    return cache, qwen2.unembed(lm, x[:, 0])


@torch.inference_mode()
def paged_decode_chunk(lm, cfg: Qwen2Config, cache: PagedKV, tokens: torch.Tensor,
                       done: torch.Tensor, generator: torch.Generator | None,
                       rows: RowSampling, min_left: torch.Tensor,
                       hist: torch.Tensor | None = None, *, chunk: int, eos_token_id: int,
                       mixed_sampling: bool = False, want_logprobs: bool = False,
                       use_min_new: bool = False, use_penalty: bool = False,
                       ngram_ns: tuple = (), step=None):
    """Advance every row ``chunk`` steps through its pages, reading nothing back to the
    host. rows: per-row sampling parameters; min_left [B]: tokens still under the EOS
    floor; hist [B, H]: prompt + generated ids (-1 elsewhere) for the repetition penalty
    and the n-gram ban. A done row keeps its length and emits EOS. ``step(cache, tokens)``
    -> (cache with lengths + 1, logits) replaces ``paged_decode_step`` (the AF1/AF2 stack's,
    ``runtime/paged_flamingo_engine.py``).

    Returns (cache, tokens [B], done [B], out [B, chunk], logprobs [B, chunk] f32, hist)."""
    b = tokens.shape[0]
    device = tokens.device
    out = torch.full((b, chunk), eos_token_id, dtype=torch.long, device=device)
    lp = torch.zeros((b, chunk), dtype=torch.float32, device=device)
    if hist is None:
        hist = torch.full((b, 8), -1, dtype=torch.long, device=device)   # processors off
    for i in range(chunk):
        lengths = cache.lengths
        cache, logits = (paged_decode_step(lm, cfg, cache, tokens) if step is None
                         else step(cache, tokens))
        nxt, lp_val, hist = engine_row_step(
            generator, logits, hist, lengths + 1, rows, done, min_left, i,
            eos_token_id=eos_token_id, mixed_sampling=mixed_sampling,
            want_logprobs=want_logprobs, use_min_new=use_min_new, use_penalty=use_penalty,
            ngram_ns=ngram_ns)
        if want_logprobs:
            lp[:, i] = lp_val
        cache.lengths = torch.where(done, lengths, cache.lengths)
        out[:, i] = nxt
        done = done | (nxt == eos_token_id)
        tokens = nxt
    return cache, tokens, done, out, lp, hist


@torch.inference_mode()
def paged_verify_step(lm, cfg: Qwen2Config, cache: PagedKV, tokens: torch.Tensor):
    """Multi-token forward through the pages (the speculative verify, JAX :251): tokens
    [B, S] at positions lengths .. lengths + S - 1 of each row.

    Per layer, the S queries of a row go through ONE ``paged_attention`` call (K3) with the
    token axis folded into the group axis: kernel row (kv, i g + gg) holds query token i,
    group head gg, and every one of them attends the row's past; ``merge_block_tokens``
    adds the block's own causal triangle (an int8 pool merges the dequantized block, what
    those positions will contribute from their pages). Every token's K/V is written to its
    page after the layer loop; ``lengths`` is left as it was (the caller advances it by
    its accepted count). The engine maps pages to cover lengths + S - 1. Returns (cache,
    logits [B, S, vocab] f32)."""
    b, s = tokens.shape
    hd, nkv, nh = cfg.resolved_head_dim(), cfg.num_kv_heads, cfg.num_heads
    g = nh // nkv
    pos_grid = cache.lengths.long()[:, None] + torch.arange(s, device=tokens.device)[None]
    cos, sin = rope_cos_sin(pos_grid, hd, cfg.rope_theta)
    x = qwen2.embed(lm, tokens)
    bs = cache.block_size
    page_pos = (pos_grid // bs).clamp(max=cache.max_blocks - 1)
    block_ids = torch.gather(cache.block_tables.long(), 1, page_pos).clamp(min=0)   # [B, S]
    offs = pos_grid % bs
    new: list = []

    def attend_layer(i: int):
        def attend(q, k, v):
            qf = q.reshape(b, s, nkv, g, hd).transpose(1, 2).reshape(b, nkv, s * g, hd)
            o, m, l = paged_attention(qf, cache.k, cache.v, cache.block_tables, cache.lengths,
                                      i, k_scale=cache.k_scale, v_scale=cache.v_scale)
            o = o.reshape(b, nkv, s, g, hd).transpose(1, 2)
            m = m.reshape(b, nkv, s, g).transpose(1, 2)
            l = l.reshape(b, nkv, s, g).transpose(1, 2)
            store, k_cur, v_cur = _current_kv(cache, k, v)
            new.append(tuple(t.reshape(b * s, *t.shape[2:]) for t in store))
            attn = merge_block_tokens(q.reshape(b, s, nkv, g, hd), k_cur, v_cur, o, m, l)
            return attn.reshape(b, s, nh, hd)
        return attend

    x = qwen2.forward_attend(lm, cfg, x, cos, sin, attend_layer)
    _write_step_kv(cache, new, block_ids.reshape(-1), offs.reshape(-1))
    return cache, qwen2.unembed(lm, x)


@torch.inference_mode()
def paged_decode_spec_chunk(lm, draft, cfg: Qwen2Config, draft_cfg: Qwen2Config,
                            cache: PagedKV, d_cache, tokens: torch.Tensor, done: torch.Tensor,
                            generator: torch.Generator | None = None, *, k: int, rounds: int,
                            eos_token_id: int, accept_sim: float | None = None):
    """Batched greedy speculation over the paged pool (JAX :351): the slot engine's round
    body (``engine.spec_chunk_rounds``) with ``paged_verify_step`` as the target forward;
    the draft on its dense ``SlotCache`` ``d_cache``. Emitted tokens equal target-only
    greedy decoding. Returns (cache, d_cache, tokens, done, out, valid)."""
    from audio_flamingo_tpu_torch.runtime.engine import spec_chunk_rounds

    return spec_chunk_rounds(draft, draft_cfg, cache, d_cache, tokens, done, generator, k=k,
                             rounds=rounds, eos_token_id=eos_token_id, nv=cfg.vocab_size,
                             verify=lambda c, seq: paged_verify_step(lm, cfg, c, seq),
                             accept_sim=accept_sim)


@torch.inference_mode()
def paged_decode_spec_chunk_sampled(lm, draft, cfg: Qwen2Config, draft_cfg: Qwen2Config,
                                    cache: PagedKV, d_cache, tokens: torch.Tensor,
                                    done: torch.Tensor, generator: torch.Generator | None, *,
                                    k: int, rounds: int, eos_token_id: int,
                                    sampling: SamplingParams):
    """Sampled (Leviathan) speculation over the paged pool (JAX :379): one warp for every
    row; the emitted law is the warped target's."""
    from audio_flamingo_tpu_torch.runtime.engine import spec_chunk_rounds

    return spec_chunk_rounds(draft, draft_cfg, cache, d_cache, tokens, done, generator, k=k,
                             rounds=rounds, eos_token_id=eos_token_id, nv=cfg.vocab_size,
                             verify=lambda c, seq: paged_verify_step(lm, cfg, c, seq),
                             sampling=sampling)


def _install(cache: PagedKV, page_ids: torch.Tensor, k_pages: torch.Tensor,
             v_pages: torch.Tensor) -> None:
    """[L, n, block, nkv, hd] pages into the pool at page_ids, in place; an int8 pool
    quantizes them per token first."""
    ids = page_ids.to(device=cache.k.device, dtype=torch.long)
    if cache.quantized:
        kq, ksc = qwen2.quantize_kv(k_pages)
        vq, vsc = qwen2.quantize_kv(v_pages)
        cache.k[:, ids], cache.v[:, ids] = kq, vq
        cache.k_scale[:, ids], cache.v_scale[:, ids] = ksc, vsc
    else:
        cache.k[:, ids] = k_pages.to(cache.k.dtype)
        cache.v[:, ids] = v_pages.to(cache.v.dtype)


def _as_pages(sub: torch.Tensor, block: int) -> torch.Tensor:
    """A contiguous prefill cache [L, 1, C, nkv, hd] -> pages [L, C / block, block, nkv, hd]."""
    n_layers, _, c, nkv, hd = sub.shape
    if c % block:
        raise ValueError(f"prefill length {c} is not a multiple of the block size {block}")
    return sub[:, 0].reshape(n_layers, c // block, block, nkv, hd)


@torch.inference_mode()
def paged_install_prefill(cache: PagedKV, row: int, sub_k: torch.Tensor, sub_v: torch.Tensor,
                          table_row: torch.Tensor, length: int) -> PagedKV:
    """Install a contiguous prefill cache [L, 1, C, nkv, hd] into the row's mapped pages.
    C may be any multiple of the block size up to the row's capacity: only the C / block
    leading entries of table_row are written; the rest stay -1 until decode grows."""
    n_pages = sub_k.shape[2] // cache.block_size
    if n_pages > cache.max_blocks:
        raise ValueError(f"{n_pages} prefill pages exceed {cache.max_blocks} per row")
    table_row = torch.as_tensor(table_row, dtype=torch.int32, device=cache.k.device)
    _install(cache, table_row[:n_pages].clamp(min=0), _as_pages(sub_k, cache.block_size),
             _as_pages(sub_v, cache.block_size))
    tables, lengths = cache.block_tables.clone(), cache.lengths.clone()
    tables[row] = table_row
    lengths[row] = int(length)
    cache.block_tables, cache.lengths = tables, lengths
    return cache


@torch.inference_mode()
def paged_restore_pages(cache: PagedKV, k_pages, v_pages, ks_pages, vs_pages,
                        page_ids) -> PagedKV:
    """Write host-swapped pages [L, n, block, nkv, hd] (and scales) back into the pool at
    page_ids (preemption resume)."""
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=cache.k.device)
    cache.k[:, ids] = k_pages.to(cache.k.device, cache.k.dtype)
    cache.v[:, ids] = v_pages.to(cache.v.device, cache.v.dtype)
    if cache.quantized:
        cache.k_scale[:, ids] = ks_pages.to(cache.k.device)
        cache.v_scale[:, ids] = vs_pages.to(cache.k.device)
    return cache


@torch.inference_mode()
def paged_prefill_suffix(lm, cfg: Qwen2Config, cache: PagedKV, prefix_page_ids: torch.Tensor,
                         suffix_embeds: torch.Tensor, prompt_len: int, *, n_prefix_pages: int,
                         suffix_len: int, forward=None, unembed=None):
    """Prefill only a prompt's suffix against prefix K/V already in pages (prefix caching
    and chunked prefill). prefix_page_ids: [n_prefix_pages] pages holding tokens
    [0, n_prefix_pages * block); suffix_embeds [1, suffix_len, d] from that boundary on;
    prompt_len: the true prompt length (the logits come from position prompt_len - 1).
    ``forward(embeds, positions, kv)`` -> final-normed hidden states (advancing kv) and
    ``unembed`` replace the LM's (the AF1/AF2 stack's, ``runtime/paged_flamingo_engine``).

    Returns (suffix K, suffix V [L, 1, suffix_len, nkv, hd] in the embeddings' dtype, for
    ``paged_install_pages``, and the last prompt token's logits [1, vocab] f32)."""
    dtype = suffix_embeds.dtype
    prefix_len = n_prefix_pages * cache.block_size
    n_layers, nkv, hd = cache.k.shape[0], cache.k.shape[-2], cache.k.shape[-1]
    ids = torch.as_tensor(prefix_page_ids, dtype=torch.long, device=cache.k.device)
    k_pref, v_pref = cache.k[:, ids], cache.v[:, ids]
    if cache.quantized:
        k_pref = k_pref.float() * cache.k_scale[:, ids][..., None]
        v_pref = v_pref.float() * cache.v_scale[:, ids][..., None]
    capacity = prefix_len + suffix_len
    kv = qwen2.KVCache(
        k=torch.zeros((n_layers, 1, capacity, nkv, hd), dtype=dtype, device=cache.k.device),
        v=torch.zeros((n_layers, 1, capacity, nkv, hd), dtype=dtype, device=cache.k.device),
        index=prefix_len)
    kv.k[:, 0, :prefix_len] = k_pref.reshape(n_layers, prefix_len, nkv, hd).to(dtype)
    kv.v[:, 0, :prefix_len] = v_pref.reshape(n_layers, prefix_len, nkv, hd).to(dtype)
    pos = (prefix_len + torch.arange(suffix_len, device=cache.k.device))[None]
    if forward is None:
        # an empty prefix is a fresh prefill, which may take the flash kernel
        h, kv = qwen2.forward(lm, cfg, suffix_embeds, pos, cache=kv,
                              is_prefill=n_prefix_pages == 0)
    else:
        h = forward(suffix_embeds, pos, kv)
    logits = (unembed or (lambda x: qwen2.unembed(lm, x)))(h[:, prompt_len - 1 - prefix_len])
    return kv.k[:, :, prefix_len:], kv.v[:, :, prefix_len:], logits


@torch.inference_mode()
def paged_install_pages(cache: PagedKV, sub_k: torch.Tensor, sub_v: torch.Tensor,
                        page_ids) -> PagedKV:
    """Write a prefill's K/V [L, 1, C, nkv, hd] into pages only (the engine keeps the
    tables and lengths on the host); an int8 pool quantizes per token."""
    _install(cache, torch.as_tensor(page_ids), _as_pages(sub_k, cache.block_size),
             _as_pages(sub_v, cache.block_size))
    return cache
