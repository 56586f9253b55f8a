"""Paged continuous-batching engine, as ``audio_flamingo_tpu/runtime/paged_engine.py``.

Rows map to pages of one shared pool through ``BlockAllocator``, so long and short
requests share the pool without a worst-case reservation per row:
- admission maps ceil(prompt bucket / block) pages and prefills at the bucket (the first
  prefill through the flash kernel, K2, where the config turns it on);
- rows grow lazily: before each decode chunk every active row gets the pages the chunk
  needs (host-side table edits, shipped to the device once per chunk);
- pool exhaustion preempts a starved row: its pages go to host memory, the request goes
  back to the front of the queue and resumes into fresh pages later; a lone row in an
  exhausted pool finishes early as the last resort;
- automatic prefix caching (``PrefixStore``: full prompt blocks shared read-only, keyed
  by chained hashes of ids and audio) and chunked prefill, one chunk per engine round.

Decode runs ``runtime/paged_cache.paged_decode_chunk``: all active rows together,
``chunk`` steps, K3 once per layer per step, one host read per chunk.

The engine takes the port's model (``AF3Model``, e.g. ``AudioFlamingo.model``) where JAX
takes ``params``, and decodes in the model's dtype. ``device=None`` means CUDA (an error
without a card); the tests pass ``device="cpu"``. Randomness comes from one
``torch.Generator`` per engine seeded from ``seed``, where JAX splits a key per admission
and per chunk: greedy rows match the JAX engine token for token, sampled rows in law.
Beam requests (``submit_beam``) ride the beam lane (``runtime/beam_lane.py``), one lane
chunk per round beside the paged rows, with their own K-row caches.

Speculative decoding (``draft_params`` / ``draft_cfg``, as the slot engine's) needs
``preempt=False`` (a swapped row would have to take its draft rows along); the draft runs
on a dense ``SlotCache`` of its own and prefills over the full prompt ids when a row goes
live, however the target's pages were built (prefix hits, chunked prefill). Each chunk
runs ``paged_decode_spec_chunk`` (or ``_sampled``), whose verify reads the pages through
K3 at folded groups (``paged_cache.paged_verify_step``); rows grow pages for
``spec_rounds (spec_k + 1)`` tokens a chunk.
"""

from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config, bucket_tokens
from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams, processor_flags, row_sampling
from audio_flamingo_tpu_torch.runtime import beam_lane
from audio_flamingo_tpu_torch.runtime.engine import (Request, _emit_first_token,
                                                     _finish_request_metrics,
                                                     _postprocess_chunk_row,
                                                     _start_request_metrics,
                                                     check_spec_request,
                                                     draft_prefill_into_slot,
                                                     init_slot_cache, seed_history,
                                                     spec_step, speculating)
from audio_flamingo_tpu_torch.runtime.generate import compute_dtype, prefill
from audio_flamingo_tpu_torch.runtime.paged_cache import (BlockAllocator, init_paged,
                                                          paged_decode_chunk,
                                                          paged_decode_spec_chunk,
                                                          paged_decode_spec_chunk_sampled,
                                                          paged_install_pages,
                                                          paged_prefill_suffix,
                                                          paged_restore_pages)


def _block_keys(ids: np.ndarray, block: int, mels_digest: bytes | None,
                first_audio: int | None) -> list[bytes]:
    """Chained content hashes, one per full prompt block.

    Blocks wholly before the first audio placeholder hash token ids only, so a shared
    text system prompt is shared between audio and text requests; a block at or after it
    also folds in the mel digest (audio embeddings replace the placeholders, so equal ids
    with other audio differ from there on)."""
    keys: list[bytes] = []
    parent = b"af-prefix-v1"
    for i in range(len(ids) // block):
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(ids[i * block:(i + 1) * block].astype(np.int32).tobytes())
        if mels_digest is not None and (first_audio is None or (i + 1) * block > first_audio):
            h.update(mels_digest)
        parent = h.digest()
        keys.append(parent)
    return keys


@dataclass
class PrefixStore:
    """Host-side registry of shareable prompt pages: block hash -> physical page.

    Registered pages belong to the store until evicted; active rows hold refcounts.
    Eviction (LRU over refcount-0 entries) hands pages back only under pool pressure, so
    finished prefixes stay warm."""

    entries: dict = field(default_factory=dict)   # key -> [page, refcount, tick]
    tick: int = 0
    hits: int = 0
    misses: int = 0

    def longest_run(self, keys: list[bytes]) -> int:
        n = 0
        for k in keys:
            if k not in self.entries:
                break
            n += 1
        return n

    def acquire(self, keys: list[bytes]) -> list[int]:
        self.tick += 1
        pages = []
        for k in keys:
            e = self.entries[k]
            e[1] += 1
            e[2] = self.tick
            pages.append(e[0])
        self.hits += len(keys)
        return pages

    def register(self, key: bytes, page: int) -> bool:
        """Give ``page`` to the store with one reference held by the caller. False (the
        caller keeps the page private) if the key is already there."""
        if key in self.entries:
            return False
        self.tick += 1
        self.entries[key] = [page, 1, self.tick]
        self.misses += 1
        return True

    def release(self, keys: list[bytes]) -> None:
        for k in keys:
            self.entries[k][1] -= 1

    def evict(self, n: int) -> list[int]:
        """Free up to n refcount-0 pages, least recently used first."""
        victims = sorted((e[2], k) for k, e in self.entries.items() if e[1] == 0)[:n]
        return [self.entries.pop(k)[0] for _, k in victims]


def _suffix_embeds(model, cfg: AF3Config, ids: torch.Tensor, mels, *, start: int):
    """Input embeddings of prompt tokens [start:]. mels=None when every audio placeholder
    lies inside the reused prefix: then the encoder does not run."""
    return af3.build_input_embeds(model, cfg, ids, mels)[:, start:]


def _model_dtype(model) -> torch.dtype:
    lm = model.lm
    return lm.dtype if isinstance(lm, qwen2.QuantQwen2) else lm.norm.weight.dtype


@dataclass
class PagedEngine:
    model: af3.AF3Model                # the port's AF3 model (AudioFlamingo.model)
    cfg: AF3Config
    num_rows: int = 4                  # concurrent decode rows
    num_blocks: int = 256              # shared physical pool
    block_size: int = 128
    max_blocks_per_seq: int = 16       # logical capacity per row = blocks * block_size
    chunk: int = 16
    eos_token_id: int = -1
    sampling: SamplingParams = SamplingParams()
    seed: int = 0
    kv_dtype: torch.dtype | None = None   # torch.int8 -> int8 page pool (half the bytes)
    prefix_cache: bool = False         # share full prompt blocks across requests
    prefill_chunk: int = 0             # > 0: prefill long prompts this many tokens (a
    #                                    multiple of block_size) per round, decode between
    preempt: bool = True               # pool pressure: swap a row to the host and resume
    #                                    it later instead of truncating its output
    metrics: object = None             # optional utils.metrics.MetricsLogger sink
    # speculative decoding, as BatchEngine's: the draft proposes spec_k tokens per row a
    # round on a dense SlotCache; the target verifies each k + 1 block through its pages
    draft_params: object = None        # the draft LM (Qwen2 / QuantQwen2)
    draft_cfg: Qwen2Config | None = None
    spec_k: int = 4
    spec_rounds: int = 4
    spec_accept_sim: float | None = None   # measurement: Bernoulli(a) acceptance
    spec_guard: bool = True
    spec_guard_min_accept: float = 0.5
    spec_guard_warmup: int = 64
    spec_disabled: bool = False
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.prefill_chunk % self.block_size:
            raise ValueError("prefill_chunk must be a multiple of block_size")
        self.device = resolve_device(self.device)
        self.d_cache = None
        if self.draft_params is not None:
            if self.draft_cfg is None:
                raise ValueError("draft_params needs its draft_cfg")
            # preemption would have to swap the draft's dense rows beside the pages
            if self.preempt:
                raise ValueError("speculative paged serving requires preempt=False")
            self.d_cache = init_slot_cache(self.draft_cfg, self.num_rows, self.capacity,
                                           compute_dtype(self.draft_params), self.device)
        self.prefilling: dict | None = None   # at most one chunked prefill in flight
        self.swapped: dict[str, dict] = {}    # request_id -> host-side K/V pages
        self.preemptions = 0
        self.request_metrics: dict[str, dict] = {}
        self.cache = self._new_pool()
        self.allocator = BlockAllocator(self.num_blocks, reserve=1)   # block 0 = trash page
        self.store = PrefixStore() if self.prefix_cache else None
        # tables and lengths are host state, shipped to the device once per chunk
        self.tables_np = np.full((self.num_rows, self.max_blocks_per_seq), -1, np.int32)
        self.lengths_np = np.zeros((self.num_rows,), np.int32)
        self.tokens = torch.full((self.num_rows,), self.eos_token_id, dtype=torch.long,
                                 device=self.device)
        self.done = torch.ones((self.num_rows,), dtype=torch.bool, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.queue: deque[Request] = deque()
        # row -> (request, private pages, held prefix-store keys)
        self.active: dict[int, tuple[Request, list[int], list[bytes]]] = {}
        self.finished: dict[str, list[int]] = {}
        self.row_params: list[SamplingParams] = [self.sampling] * self.num_rows
        self.rows = row_sampling(self.row_params, self.device)
        # per-row prompt + generated ids (-1 = empty) for the history processors
        self.hist = torch.full((self.num_rows, self.capacity), -1, dtype=torch.long,
                               device=self.device)

    def _new_pool(self):
        return init_paged(self.cfg.lm, self.num_rows, self.num_blocks, self.block_size,
                          self.max_blocks_per_seq, self.kv_dtype or _model_dtype(self.model),
                          self.device)

    @property
    def capacity(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    def offload_pool(self) -> None:
        """Move the page pool to host memory between serving phases; the engine must be
        idle. Host state (allocator, tables, prefix store) stays, so restored pages serve
        prefix-cache hits as before."""
        if self.active or self.prefilling is not None or self.cache is None:
            raise RuntimeError("offload_pool: the engine has work in flight or no pool")
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(self.cache, name)
            if t is not None:
                setattr(self.cache, name, t.cpu())
        self._host_pool, self.cache = self.cache, None

    def restore_pool(self) -> None:
        """Move a pool offloaded by ``offload_pool`` back to the device."""
        host = getattr(self, "_host_pool", None)
        if self.cache is not None or host is None:
            raise RuntimeError("restore_pool: no offloaded pool")
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(host, name)
            if t is not None:
                setattr(host, name, t.to(self.device))
        self.cache, self._host_pool = host, None

    def submit(self, req: Request) -> None:
        if req.ids.shape[1] > self.capacity:
            raise ValueError(f"prompt ({req.ids.shape[1]} tokens) exceeds row capacity "
                             f"({self.capacity} = max_blocks_per_seq * block_size)")
        check_spec_request(self, req)
        _start_request_metrics(req)
        self.queue.append(req)

    def submit_beam(self, req) -> None:
        """Queue a beam-search request (``beam_lane.BeamRequest``), served by the beam lane
        between paged decode rounds. The lane owns its K cache rows (the per-step reorder
        by parent cannot share the page pool); results appear in ``finished_beams`` as
        (sequences [R, max_new], scores [R])."""
        beam_lane.attach_beam_lane(self).submit(req)

    @property
    def finished_beams(self) -> dict:
        return beam_lane.finished_beams(self)

    def _set_row_params(self, row: int, params: SamplingParams) -> None:
        self.row_params[row] = params
        self.rows = row_sampling(self.row_params, self.device)

    def _seed_hist(self, row: int, req: Request) -> None:
        self.hist = seed_history(self.hist, row, self.capacity, req,
                                 req.sampling or self.sampling)

    def _free_pages(self) -> int:
        n = len(self.allocator.free)
        if self.store is not None:
            n += sum(1 for e in self.store.entries.values() if e[1] == 0)
        return n

    def _alloc(self, n: int) -> list[int]:
        short = n - len(self.allocator.free)
        if short > 0 and self.store is not None:
            self.allocator.release(self.store.evict(short))
        return self.allocator.alloc(n)

    def _padded_ids(self, req: Request, bucket: int) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(req.ids), dtype=torch.long, device=self.device)
        t = ids.shape[1]
        if bucket != t:
            pad = torch.full((1, bucket - t), self.eos_token_id, dtype=torch.long,
                             device=self.device)
            ids = torch.cat([ids, pad], dim=1)
        return ids

    def _mels(self, req: Request):
        return None if req.mels is None else torch.as_tensor(req.mels, device=self.device)

    def _activate(self, row: int, req: Request, table_pages: list[int], blocks: list[int],
                  held: list[bytes], logits: torch.Tensor, bucket: int) -> None:
        """After a prompt's pages are in: map them, sample the first token and make the
        row live (or release it at once if that token is EOS). A speculating engine
        prefills the draft's dense row over the full prompt ids (JAX ``_draft_prefill``
        :304), however the target's pages were built: the draft shares no pages."""
        t = req.ids.shape[1]
        self.tables_np[row] = -1
        self.tables_np[row, :len(table_pages)] = table_pages
        self.lengths_np[row] = t
        first, finished, req_sampling = _emit_first_token(self, req, logits[0])
        if finished:
            self.allocator.release(blocks)
            if self.store is not None and held:
                self.store.release(held)
            self.tables_np[row] = -1
            return
        self._set_row_params(row, req_sampling)
        self._seed_hist(row, req)
        if speculating(self):
            draft_prefill_into_slot(self.draft_params, self.draft_cfg, self.d_cache, row,
                                    self._padded_ids(req, bucket))
        self.tokens[row] = first
        self.done[row] = False
        self.active[row] = (req, blocks, held)

    def _register_prompt_blocks(self, keys, n_hit: int, t: int, table_pages: list[int],
                                blocks: list[int], held: list[bytes]) -> None:
        """Hand this prompt's own full blocks to the prefix store (decode writes only at
        positions >= t, so they never change)."""
        if self.store is None:
            return
        for i in range(n_hit, t // self.block_size):
            if self.store.register(keys[i], table_pages[i]):
                blocks.remove(table_pages[i])
                held.append(keys[i])

    def _admit(self) -> None:
        for row in range(self.num_rows):
            if row in self.active or not self.queue:
                continue
            if self.prefilling is not None and self.prefilling["row"] == row:
                continue
            req = self.queue[0]
            if req.request_id in self.swapped:
                if not self._resume_row(req, row):
                    return   # not enough pages yet to bring its K/V back
                continue
            t = req.ids.shape[1]
            bs = self.block_size
            bucket = min(max(bucket_tokens(t), bs), self.capacity)
            bucket = -(-bucket // bs) * bs
            n_prompt = bucket // bs

            # prefix-cache lookup: the longest run of known full prompt blocks, rounded
            # down to a power of two; at least one real token must still prefill
            keys: list[bytes] = []
            audio_pos = np.empty((0,), np.int64)
            n_hit = 0
            if self.store is not None:
                keys, audio_pos = self._prefix_keys(req)
                run = min(self.store.longest_run(keys), (t - 1) // bs)
                n_hit = 1 << (run.bit_length() - 1) if run > 0 else 0

            start0 = n_hit * bs
            if self.prefill_chunk and bucket - start0 > self.prefill_chunk:
                # one chunked prefill at a time; a start that fails (pool short) also
                # stops admission, so FIFO order holds
                if (self.prefilling is not None
                        or not self._start_chunked_prefill(req, row, t, bucket, n_hit, keys,
                                                           audio_pos)):
                    return
                continue

            # one page of headroom so the first decode chunk can start at once
            headroom = 1 if n_prompt < self.max_blocks_per_seq else 0
            if self._free_pages() < n_prompt - n_hit + headroom:
                return   # pool exhausted; wait for releases
            self.queue.popleft()
            held: list[bytes] = list(keys[:n_hit])
            prefix_pages = self.store.acquire(held) if n_hit else []
            blocks = self._alloc(n_prompt - n_hit)
            logits = self._prefill_pages(row, req, bucket, n_hit, prefix_pages, blocks,
                                         audio_pos)
            table_pages = prefix_pages + blocks
            self._register_prompt_blocks(keys, n_hit, t, table_pages, blocks, held)
            self._activate(row, req, table_pages, blocks, held, logits, bucket)

    def _prefix_keys(self, req: Request) -> tuple[list[bytes], np.ndarray]:
        """The prompt's block keys (ids, and the mel digest from the first audio
        placeholder's block on) and its audio placeholders' positions."""
        ids_np = np.asarray(req.ids[0])
        audio_pos = np.nonzero(ids_np == self.cfg.audio_token_id)[0]
        mels_digest = first_audio = None
        if req.mels is not None:
            raw = torch.as_tensor(req.mels).detach().cpu().contiguous()
            mels_digest = hashlib.blake2b(raw.view(torch.uint8).numpy().tobytes(),
                                          digest_size=16).digest()
            first_audio = int(audio_pos[0]) if audio_pos.size else None
        return _block_keys(ids_np, self.block_size, mels_digest, first_audio), audio_pos

    def _prefill_pages(self, row: int, req: Request, bucket: int, n_hit: int,
                       prefix_pages: list[int], blocks: list[int],
                       audio_pos: np.ndarray) -> torch.Tensor:
        """Prefill a prompt into its own pages ``blocks`` (after ``n_hit`` shared prefix
        pages) at its bucket -> the last prompt token's logits [1, V]."""
        t = req.ids.shape[1]
        start0 = n_hit * self.block_size
        mels = self._mels(req)
        ids = self._padded_ids(req, bucket)
        if n_hit:
            # skip the encoder when every audio token lies inside the reused prefix
            mels_arg = mels if audio_pos.size and int(audio_pos[-1]) >= start0 else None
            emb = _suffix_embeds(self.model, self.cfg, ids, mels_arg, start=start0)
            sub_k, sub_v, logits = paged_prefill_suffix(
                self.model.lm, self.cfg.lm, self.cache, prefix_pages, emb, t,
                n_prefix_pages=n_hit, suffix_len=bucket - start0)
            paged_install_pages(self.cache, sub_k, sub_v, blocks)
        else:
            # prefill at the bucket: pages past the prompt stay unmapped
            sub_cache, logits = prefill(self.model, self.cfg, ids, mels, bucket,
                                        prompt_len=t if bucket != t else None)
            paged_install_pages(self.cache, sub_cache.k, sub_cache.v, blocks)
        return logits

    def _preempt_row(self, row: int) -> None:
        """Swap a starved row's pages to the host and requeue it at the front: pool
        pressure defers a request, never truncates it."""
        req, blocks, held = self.active.pop(row)
        n_tok = int(self.lengths_np[row])
        n_pages = -(-n_tok // self.block_size)
        ids = torch.as_tensor(self.tables_np[row, :n_pages].astype(np.int64),
                              device=self.device)
        c = self.cache
        self.swapped[req.request_id] = dict(
            n_tok=n_tok, last=int(self.tokens[row]), k=c.k[:, ids].cpu(), v=c.v[:, ids].cpu(),
            ks=None if not c.quantized else c.k_scale[:, ids].cpu(),
            vs=None if not c.quantized else c.v_scale[:, ids].cpu())
        self.preemptions += 1
        self.allocator.release(blocks)
        if self.store is not None and held:
            self.store.release(held)
        self.done[row] = True
        self.tables_np[row] = -1
        self.lengths_np[row] = 0
        self.queue.appendleft(req)

    def _resume_row(self, req: Request, row: int) -> bool:
        """Put a swapped request's K/V into fresh pages and make its row live again."""
        sw = self.swapped[req.request_id]
        n_pages = -(-sw["n_tok"] // self.block_size)
        if self._free_pages() < n_pages + 1:
            return False
        self.queue.popleft()
        del self.swapped[req.request_id]
        blocks = self._alloc(n_pages)
        paged_restore_pages(self.cache, sw["k"], sw["v"], sw["ks"], sw["vs"], blocks)
        self.tables_np[row] = -1
        self.tables_np[row, :n_pages] = blocks
        self.lengths_np[row] = sw["n_tok"]
        self._set_row_params(row, req.sampling or self.sampling)
        self._seed_hist(row, req)
        self.tokens[row] = sw["last"]
        self.done[row] = False
        self.active[row] = (req, blocks, [])
        return True

    def _start_chunked_prefill(self, req: Request, row: int, t: int, bucket: int, n_hit: int,
                               keys: list[bytes], audio_pos: np.ndarray) -> bool:
        """Reserve a row and pages and compute the embeddings (the encoder runs once,
        here); ``_prefill_step`` then feeds the LM one chunk per engine round. False when
        the pool cannot hold the prompt's pages yet."""
        bs = self.block_size
        start0 = n_hit * bs
        # cover the true prompt only (chunks of pure padding are never prefilled)
        n_chunks = -(-(t - start0) // self.prefill_chunk)
        ce = min(start0 + n_chunks * self.prefill_chunk, bucket)
        headroom = 1 if ce // bs < self.max_blocks_per_seq else 0
        if self._free_pages() < (ce - start0) // bs + headroom:
            return False
        self.queue.popleft()
        held = list(keys[:n_hit])
        prefix_pages = self.store.acquire(held) if n_hit else []
        own = self._alloc((ce - start0) // bs)
        self.prefilling = dict(req=req, row=row, t=t, n_hit=n_hit, keys=keys, held=held,
                               prefix_pages=prefix_pages, own=own, done=start0, ce=ce,
                               bucket=bucket,
                               **self._chunk_inputs(req, row, bucket, start0, audio_pos))
        return True

    def _chunk_inputs(self, req: Request, row: int, bucket: int, start0: int,
                      audio_pos: np.ndarray) -> dict:
        """What a chunked prefill keeps for its chunks: the prompt's input embeddings (the
        encoder runs once, here, unless every audio token lies in the reused prefix)."""
        ids = self._padded_ids(req, bucket)
        mels_arg = (self._mels(req) if req.mels is not None
                    and (start0 == 0 or (audio_pos.size and int(audio_pos[-1]) >= start0))
                    else None)
        return dict(emb=_suffix_embeds(self.model, self.cfg, ids, mels_arg, start=0))

    def _prefill_step(self) -> None:
        """Advance the chunked prefill in flight by one chunk, as a suffix prefill
        against the request's already filled pages (and any shared prefix pages)."""
        st = self.prefilling
        if st is None:
            return
        bs = self.block_size
        start, ce = st["done"], st["ce"]
        end = min(start + self.prefill_chunk, ce)
        table_pages = st["prefix_pages"] + st["own"]
        n_pref = start // bs
        sub_k, sub_v, logits = self._prefill_chunk(st, start, end, table_pages[:n_pref])
        paged_install_pages(self.cache, sub_k, sub_v, table_pages[n_pref: end // bs])
        st["done"] = end
        if end < st["t"]:
            return
        # the last chunk: register shareable blocks, sample the first token, activate
        self.prefilling = None
        row, req, t = st["row"], st["req"], st["t"]
        blocks, held = st["own"], st["held"]
        self._register_prompt_blocks(st["keys"], st["n_hit"], t, table_pages, blocks, held)
        self._activate(row, req, table_pages, blocks, held, logits, st["bucket"])

    def _prefill_chunk(self, st: dict, start: int, end: int, prefix_pages: list[int]):
        """Chunk [start, end) of the chunked prefill in flight against its pages before
        ``start`` -> (chunk K, V, logits at the chunk's last real token)."""
        return paged_prefill_suffix(
            self.model.lm, self.cfg.lm, self.cache, prefix_pages, st["emb"][:, start:end],
            st["t"] if end >= st["t"] else end, n_prefix_pages=len(prefix_pages),
            suffix_len=end - start)

    def _step_budget(self) -> int:
        """The most tokens a row can emit (and write K/V for) in one decode chunk."""
        if speculating(self):
            return self.spec_rounds * (self.spec_k + 1)
        return self.chunk

    def _grow_pages(self) -> list[int]:
        """Top up every active row with the pages the next chunk needs (host table edits
        only). Returns the rows that could not grow (pool exhausted)."""
        starved: list[int] = []
        budget = self._step_budget()
        for row, (_, blocks, _) in self.active.items():
            needed = -(-(int(self.lengths_np[row]) + budget + 1) // self.block_size)
            needed = min(needed, self.max_blocks_per_seq)
            mapped = int((self.tables_np[row] >= 0).sum())
            while mapped < needed:
                if not self.allocator.free and self.store is not None:
                    self.allocator.release(self.store.evict(1))
                if not self.allocator.free:
                    break
                nb = self.allocator.alloc(1)[0]
                self.tables_np[row, mapped] = nb
                blocks.append(nb)
                mapped += 1
            if mapped < needed:
                starved.append(row)
        return starved

    def _finish_row(self, row: int) -> None:
        req, blocks, held = self.active.pop(row)
        req.done = True
        self.finished[req.request_id] = req.tokens
        _finish_request_metrics(self, req)
        self.allocator.release(blocks)
        if self.store is not None and held:
            self.store.release(held)
        self.done[row] = True
        # point the dead row at the trash page: its in-chunk writes cannot reach
        # re-allocated pages
        self.tables_np[row] = -1
        self.lengths_np[row] = 0

    @torch.inference_mode()
    def step(self) -> None:
        """One engine round: admit, advance a chunked prefill, grow (or preempt), decode
        every active row ``chunk`` steps and retire the finished ones, then advance the
        beam lane one chunk."""
        self._admit()
        self._prefill_step()            # one chunk, then back to decoding
        starved = self._grow_pages()
        while starved and self.preempt and len(self.active) > 1:
            # swap one starved row out; its pages may unblock the rest
            self._preempt_row(starved[-1])
            starved = self._grow_pages()
        for row in starved:             # a lone row in an exhausted pool
            self._finish_row(row)
        if not self.active:
            beam_lane.step_beam_lane(self)
            return
        self.cache.block_tables = torch.as_tensor(self.tables_np, device=self.device)
        self.cache.lengths = torch.as_tensor(self.lengths_np, device=self.device)
        budget = self._step_budget()
        if speculating(self):
            out, valid = self._spec_chunk()
            row_tokens = [out[r][valid[r]].tolist() for r in range(self.num_rows)]
            lp = None
        else:
            row_tokens, lp = self._decode_chunk()
        done = self.done.cpu().numpy().copy()
        self.lengths_np = self.cache.lengths.cpu().numpy().astype(np.int32)
        for row, (req, _, _) in list(self.active.items()):
            if _postprocess_chunk_row(self, req, row_tokens[row],
                                      lp[row] if req.logprobs and lp is not None else None):
                done[row] = True
            full = self.lengths_np[row] >= self.capacity - budget - 1
            if done[row] or full or len(req.tokens) >= req.max_new_tokens:
                self._finish_row(row)
        beam_lane.step_beam_lane(self)

    def _spec_chunk(self):
        """One speculative chunk over every row -> (out, valid), read once."""
        return spec_step(self, self.model.lm, self.cfg.lm, paged_decode_spec_chunk,
                         paged_decode_spec_chunk_sampled)

    def _step_fn(self):
        """The decode step the plain chunk runs: None for ``paged_decode_step``."""
        return None

    def _decode_chunk(self):
        """The plain chunk over every row -> (row tokens, logprobs), read once."""
        min_left = np.zeros((self.num_rows,), np.int64)
        for row, (req, _, _) in self.active.items():
            want = max(req.min_new_tokens, (req.sampling or self.sampling).min_new_tokens)
            min_left[row] = max(want - len(req.tokens), 0)
        reqs = [req for req, _, _ in self.active.values()]
        use_pen, ngram_ns = processor_flags(r.sampling or self.sampling for r in reqs)
        self.cache, self.tokens, self.done, out, lp, self.hist = paged_decode_chunk(
            self.model.lm, self.cfg.lm, self.cache, self.tokens, self.done, self.generator,
            self.rows, torch.as_tensor(min_left, device=self.device), self.hist,
            chunk=self.chunk, eos_token_id=self.eos_token_id,
            mixed_sampling=any(not (r.sampling or self.sampling).greedy for r in reqs),
            want_logprobs=any(r.logprobs for r in reqs), use_min_new=bool(min_left.any()),
            use_penalty=use_pen, ngram_ns=ngram_ns, step=self._step_fn())
        out = out.cpu().numpy()   # the chunk's one host read
        return [out[r].tolist() for r in range(self.num_rows)], lp.cpu().numpy()

    def run_until_done(self, max_rounds: int = 1000) -> dict[str, list[int]]:
        rounds = 0
        while ((self.queue or self.active or self.prefilling is not None
                or beam_lane.beam_lane_busy(self)) and rounds < max_rounds):
            self.step()
            rounds += 1
        return self.finished
