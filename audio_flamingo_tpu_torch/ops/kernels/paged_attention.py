"""Paged-attention decode (K3): the hand-written Hopper kernel, its plain PyTorch version,
the dense reference and the merges of the tokens not yet in the pool.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/paged_attention.py``
(``paged_attention`` :116, kernel ``_paged_kernel`` :45); ``merge_current_token`` (:215),
``merge_block_tokens`` (:236) and ``paged_attention_reference`` (:266) are ported as they
are. One query token per row, GQA-grouped, attends the row's context through its block
table; the kernel returns the unnormalized triple (o, m, l) and ``merge_current_token``
folds in the token being decoded, whose K/V is not in the pool yet. A speculative verify
folds its S fresh query tokens into the group axis (g' = S g rows a KV head, up to
``KERNEL_MAX_GROUP``), one call a layer, and ``merge_block_tokens`` folds in the block's
own causal triangle. The CUDA source is ``csrc/paged_attention.cu``;
its header states the design (a score pass that reads K once, then a pass over V in
parts of each row's pages whose last part merges them: two launches, counted here as one
launch of K3), the bound and what the design leaves. ``plan`` lays out the kernel's f32
scratch and ``kernel_parts`` picks its parts; ``paged_attention_parts_plain`` and
``merge_parts`` are the split's arithmetic in plain torch (the kernel's model in tests).

Dispatch is by the tensors' device: a CPU tensor goes to ``paged_attention_plain``, a
CUDA tensor launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from audio_flamingo_tpu_torch.device import sm_count
from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIMS = (64, 128)   # csrc kHDMin, kHDMax: OPT's and Qwen2's head dims
KERNEL_MAX_GROUP = 64     # query rows a KV head: decode heads, or a verify's tokens x heads
KEYS_PER_STEP = 64         # csrc kC: keys a ring step, the scores' page padding unit
TICKETS = 4096             # (row, kv head) pairs a launch may have (one int ticket each)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_TICKETS: dict = {}

# key: (B, nkv, g, hd, pool dtype, max pages); inputs: the call's arguments
LAUNCHES = LaunchCounter()


def _check(q, k_pool, v_pool, block_tables, lengths, layer_idx, k_scale, v_scale) -> None:
    if q.ndim != 4:
        raise ValueError(f"q must be [B, nkv, g, hd], got {tuple(q.shape)}")
    if k_pool.ndim not in (4, 5) or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be [NB, BS, nkv, hd] or [L, NB, BS, nkv, hd] alike, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    b, nkv, _, hd = q.shape
    if k_pool.shape[-2:] != (nkv, hd):
        raise ValueError(f"pool heads {tuple(k_pool.shape[-2:])} do not match q {(nkv, hd)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in (q.dtype, torch.bfloat16, torch.int8):
        raise TypeError(f"pools must be {q.dtype}, bfloat16 or int8, got {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if k_pool.dtype == torch.int8 and (k_scale is None or v_scale is None
                                       or k_scale.shape != k_pool.shape[:-1]
                                       or v_scale.shape != k_scale.shape):
        raise ValueError("int8 pools need k_scale and v_scale shaped like the pool without "
                         "its head dim")
    if k_pool.ndim == 5 and layer_idx is None:
        raise ValueError("a stacked [L, ...] pool needs layer_idx")
    if block_tables.ndim != 2 or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"block_tables [B, MP] and lengths [B] for B = {b}, got "
                         f"{tuple(block_tables.shape)} and {tuple(lengths.shape)}")
    devices = {t.device for t in (q, k_pool, v_pool, block_tables, lengths)}
    if len(devices) != 1:
        raise ValueError(f"paged_attention operands on different devices: {devices}")


def check_kernel_shape(hd: int, g: int) -> None:
    """The CUDA kernel's shapes: hd in ``KERNEL_HEAD_DIMS`` (a template instantiation
    each) and at most ``KERNEL_MAX_GROUP`` query rows a KV head; anything else raises."""
    if hd not in KERNEL_HEAD_DIMS or not 1 <= g <= KERNEL_MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes hd in {KERNEL_HEAD_DIMS} and 1 .. "
                         f"KERNEL_MAX_GROUP = {KERNEL_MAX_GROUP} query rows a KV head, got "
                         f"hd = {hd}, g = {g}")


def parts_for(b: int, nkv: int, max_pages: int, sms: int, blocks_per_sm: int) -> int:
    """The parts a row's table is split into for the V pass: whole entries each, as few
    per part as keep the B nkv MP entries of a full table at about ``blocks_per_sm``
    blocks on each of ``sms`` SMs (one part when B x nkv already fills them)."""
    per_part = min(max_pages, max(1, -(-(b * nkv * max_pages) // (sms * blocks_per_sm))))
    return -(-max_pages // per_part)


@functools.lru_cache(maxsize=None)
def _attend_blocks_per_sm(index: int, q_code: int, kv_code: int, g: int, hd: int,
                         max_pages: int) -> int:
    lib = _build.load_library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.af_paged_attention_occupancy(q_code, kv_code, g, hd, max_pages,
                                               ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"paged_attention occupancy query failed with CUDA error {err} "
                           f"({blocks.value} blocks an SM)")
    return blocks.value


def kernel_parts(b: int, nkv: int, max_pages: int, device: torch.device,
                 q_dtype: torch.dtype, kv_dtype: torch.dtype, g: int = 1,
                 hd: int = 128) -> int:
    """``parts_for`` on this card, at the V pass's occupancy for the dtype pair, the
    group's head tiles (g <= 8: one; up to 64: eight) and the head dim as the CUDA side
    reports it (threads, registers, shared memory)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    bps = _attend_blocks_per_sm(index, _DTYPE_CODES[q_dtype], _DTYPE_CODES[kv_dtype],
                                min(g, 9), hd, max_pages)
    return parts_for(b, nkv, max_pages, sm_count(device), bps)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's split and the f32 scratch the kernel reads and writes, in floats, in
    this order: the scores [B, nkv, MP, steps_per_page, 64, g], the page maxima
    [B, nkv, MP, g] (rounded up to 4 floats, so that the parts' o start 16-byte aligned),
    the parts' o [B, nkv, parts, g, hd], m and l [B, nkv, parts, g]."""
    parts: int
    pages_per_part: int
    steps_per_page: int
    scores: int
    pmax: int
    part_o: int
    part_ml: int

    @property
    def floats(self) -> int:
        return self.scores + self.pmax + self.part_o + 2 * self.part_ml


def plan(b: int, nkv: int, g: int, hd: int, block_size: int, max_pages: int,
         parts: int) -> Plan:
    """The kernel's split of MP table entries into ``parts`` (rounded to whole entries
    a part, as the C side does) and its scratch layout (csrc ``Scratch``)."""
    if not 1 <= parts <= max_pages:
        raise ValueError(f"parts {parts} not in 1..{max_pages}")
    per_part = -(-max_pages // parts)
    parts = -(-max_pages // per_part)
    steps = -(-block_size // KEYS_PER_STEP)
    bkg = b * nkv * g
    return Plan(parts=parts, pages_per_part=per_part, steps_per_page=steps,
                scores=bkg * max_pages * steps * KEYS_PER_STEP, pmax=-(-bkg * max_pages // 4) * 4,
                part_o=bkg * parts * hd, part_ml=bkg * parts)


def _tickets(device: torch.device) -> torch.Tensor:
    """The device's merge tickets: zero, and left zero by every launch (the last part of
    a (row, kv head) resets its ticket). Launches use them in stream order, so two
    launches must not run at once on two streams."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros((TICKETS,), dtype=torch.int32, device=device)
    return t


def _layer(pools: tuple, layer_idx) -> tuple:
    """The layer's view of each stacked pool (no copy)."""
    return tuple(None if p is None else p[int(layer_idx)] for p in pools)


def _page_scores(qf, k_pool, k_scale, page, j, bs, lengths, scale, quantized, dtype):
    """Page j's scores [B, nkv, g, BS] (pool rows ``page`` [B]); keys at or past each
    row's length score NEG_INF."""
    kj = k_pool[page].to(dtype).float()                                # [B, BS, nkv, hd]
    s = torch.einsum("bkgd,btkd->bkgt", qf, kj) * scale
    if quantized:
        s = s * k_scale[page].float().permute(0, 2, 1)[:, :, None, :]
    visible = (j * bs + torch.arange(bs, device=qf.device))[None, :] < lengths[:, None]
    return torch.where(visible[:, None, None, :], s, torch.full_like(s, NEG_INF))


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          block_tables: torch.Tensor, lengths: torch.Tensor,
                          layer_idx=None, *, k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None, scale: float | None = None):
    """Plain PyTorch version of the kernel: the JAX kernel's online softmax, one page of
    every row per step, in plain torch ops -> (o [B, nkv, g, hd], m, l [B, nkv, g]) f32.

    Row b takes pages j < ceil(len / BS) (pages past that leave its triple as it is);
    keys at or past len score NEG_INF; for int8 pools the score is multiplied by the key's
    scale after the dot and p by the value's scale before P.V. p = exp(s - m_new) against
    the running max after the page, rounded to q's dtype before P.V while l adds it
    unrounded. A row with len = 0 keeps o = 0, l = 0, m = NEG_INF."""
    if k_pool.ndim == 5:
        k_pool, v_pool, k_scale, v_scale = _layer((k_pool, v_pool, k_scale, v_scale), layer_idx)
    quantized = k_pool.dtype == torch.int8
    b, nkv, g, hd = q.shape
    bs = k_pool.shape[1]
    if scale is None:
        scale = hd ** -0.5
    qf = q.float()
    lengths = lengths.long()
    num_pages = (lengths + bs - 1) // bs
    o = torch.zeros((b, nkv, g, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, nkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nkv, g), dtype=torch.float32, device=q.device)
    for j in range(block_tables.shape[1]):
        live = (j < num_pages)[:, None, None]                          # [B, 1, 1]
        page = torch.where(j < num_pages, block_tables[:, j].long(),
                           torch.zeros_like(lengths)).clamp(min=0)
        vj = v_pool[page].to(q.dtype).float()
        s = _page_scores(qf, k_pool, k_scale, page, j, bs, lengths, scale, quantized, q.dtype)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        pv = p * v_scale[page].float().permute(0, 2, 1)[:, :, None, :] if quantized else p
        upd = torch.einsum("bkgt,btkd->bkgd", pv.to(q.dtype).float(), vj)
        o = torch.where(live[..., None], o * alpha[..., None] + upd, o)
        l = torch.where(live, l * alpha + p.sum(dim=-1), l)
        m = torch.where(live, m_new, m)
    return o, m, l


def paged_attention_parts_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                block_tables: torch.Tensor, lengths: torch.Tensor,
                                layer_idx=None, *, pages_per_part: int,
                                k_scale: torch.Tensor | None = None,
                                v_scale: torch.Tensor | None = None,
                                scale: float | None = None):
    """The kernel's split in plain torch: the table's entries in parts of
    ``pages_per_part``; part s starts from the running max of every page before it (the
    page maxima of the whole row, as the score pass gives them) and runs the online
    softmax over its own pages -> (o [B, nkv, parts, g, hd], m, l [B, nkv, parts, g]). A
    part with no live page is (0, NEG_INF, 0). ``merge_parts`` of the result is the call's
    triple; with one part it is ``paged_attention_plain``'s."""
    if k_pool.ndim == 5:
        k_pool, v_pool, k_scale, v_scale = _layer((k_pool, v_pool, k_scale, v_scale), layer_idx)
    quantized = k_pool.dtype == torch.int8
    b, nkv, g, hd = q.shape
    bs, mp = k_pool.shape[1], block_tables.shape[1]
    if scale is None:
        scale = hd ** -0.5
    qf = q.float()
    lengths = lengths.long()
    num_pages = (lengths + bs - 1) // bs
    pages, scores, pmax = [], [], []
    for j in range(mp):
        live = (j < num_pages)[:, None, None]
        page = torch.where(j < num_pages, block_tables[:, j].long(),
                           torch.zeros_like(lengths)).clamp(min=0)
        s = _page_scores(qf, k_pool, k_scale, page, j, bs, lengths, scale, quantized, q.dtype)
        pages.append(page)
        scores.append(s)
        pmax.append(torch.where(live, s.amax(dim=-1), torch.full_like(s[..., 0], NEG_INF)))
    parts = -(-mp // pages_per_part)
    o_s = torch.zeros((b, nkv, parts, g, hd), dtype=torch.float32, device=q.device)
    m_s = torch.full((b, nkv, parts, g), NEG_INF, dtype=torch.float32, device=q.device)
    l_s = torch.zeros((b, nkv, parts, g), dtype=torch.float32, device=q.device)
    prefix = torch.full((b, nkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    for p in range(parts):
        j0 = p * pages_per_part
        o = torch.zeros((b, nkv, g, hd), dtype=torch.float32, device=q.device)
        m, l = prefix.clone(), torch.zeros_like(prefix)
        for j in range(j0, min(j0 + pages_per_part, mp)):
            live = (j < num_pages)[:, None, None]
            s, page = scores[j], pages[j]
            m_new = torch.maximum(m, pmax[j])
            prob = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            pv = (prob * v_scale[page].float().permute(0, 2, 1)[:, :, None, :] if quantized
                  else prob)
            upd = torch.einsum("bkgt,btkd->bkgd", pv.to(q.dtype).float(),
                               v_pool[page].to(q.dtype).float())
            o = torch.where(live[..., None], o * alpha[..., None] + upd, o)
            l = torch.where(live, l * alpha + prob.sum(dim=-1), l)
            m = torch.where(live, m_new, m)
        any_live = (j0 < num_pages)[:, None, None]
        o_s[:, :, p] = o
        m_s[:, :, p] = torch.where(any_live, m, torch.full_like(m, NEG_INF))
        l_s[:, :, p] = l
        prefix = torch.where(any_live, m, prefix)
    return o_s, m_s, l_s


def merge_parts(o_s: torch.Tensor, m_s: torch.Tensor, l_s: torch.Tensor):
    """The parts' triples into one, in part order, as the last part's block does: m =
    max_s m_s, o = sum_s o_s exp(m_s - m), l likewise -> (o [B, nkv, g, hd], m, l)."""
    m = m_s.amax(dim=2)
    o, l = torch.zeros_like(o_s[:, :, 0]), torch.zeros_like(l_s[:, :, 0])
    for s in range(o_s.shape[2]):
        w = torch.exp(m_s[:, :, s] - m)
        o = o + o_s[:, :, s] * w[..., None]
        l = l + l_s[:, :, s] * w
    return o, m, l


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths, layer_idx=None, *,
                              k_scale=None, v_scale=None, scale: float | None = None):
    """The JAX dense-gather reference (:266): every mapped page gathered at once, masked,
    one softmax over the row; int8 pools dequantized up front. Same (o, m, l) contract,
    but a row with len = 0 gets p = 1 on every masked key (its merged result is the same)."""
    b, nkv, g, hd = q.shape
    if k_pool.ndim == 5:
        k_pool, v_pool, k_scale, v_scale = _layer((k_pool, v_pool, k_scale, v_scale), layer_idx)
    if k_pool.dtype == torch.int8:
        k_pool = k_pool.float() * k_scale[..., None]
        v_pool = v_pool.float() * v_scale[..., None]
    bs = k_pool.shape[1]
    mp = block_tables.shape[1]
    if scale is None:
        scale = hd ** -0.5
    idx = block_tables.long().clamp(min=0)
    k_seq = k_pool[idx].reshape(b, mp * bs, nkv, hd).float()
    v_seq = v_pool[idx].reshape(b, mp * bs, nkv, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k_seq) * scale
    valid = torch.arange(mp * bs, device=q.device)[None] < lengths.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bkgt,btkd->bkgd", p, v_seq), m, p.sum(dim=-1)


def merge_current_token(q, k_cur, v_cur, o, m, l, *, scale: float | None = None):
    """One more online-softmax step folding the current token's (k, v) into the paged
    triple. q [B, nkv, g, hd], k_cur / v_cur [B, nkv, hd] -> normalized attention
    [B, nkv, g, hd] f32."""
    hd = q.shape[-1]
    if scale is None:
        scale = hd ** -0.5
    s_c = torch.einsum("bkgd,bkd->bkg", q.float(), k_cur.float()) * scale
    m2 = torch.maximum(m, s_c)
    alpha = torch.exp(m - m2)
    w_c = torch.exp(s_c - m2)
    l2 = l * alpha + w_c
    acc = o * alpha[..., None] + w_c[..., None] * v_cur[:, :, None, :].float()
    return acc / l2.clamp(min=1e-30)[..., None]


def merge_block_tokens(q, k_blk, v_blk, o, m, l, *, scale: float | None = None):
    """Online-softmax merge of a verify's S-token block (JAX :236): the S fresh queries all
    attend the same past pages (their triples from ONE ``paged_attention`` call with the
    token axis folded into the group axis) plus the block's causal triangle (query i sees
    block keys 0..i), none of whose K/V is in the pool yet. S == 1 is
    ``merge_current_token``.

    q [B, S, nkv, g, hd]; k_blk, v_blk [B, S, nkv, hd]; o [B, S, nkv, g, hd], m, l [B, S,
    nkv, g] -> normalized attention [B, S, nkv, g, hd] f32."""
    hd = q.shape[-1]
    s = q.shape[1]
    if scale is None:
        scale = hd ** -0.5
    s_c = torch.einsum("bikgd,bjkd->bikgj", q.float(), k_blk.float()) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()   # [S_q, S_k]
    s_c = torch.where(causal[:, None, None, :], s_c, torch.full_like(s_c, NEG_INF))
    m2 = torch.maximum(m, s_c.amax(dim=-1))
    alpha = torch.exp(m - m2)
    w = torch.exp(s_c - m2[..., None])
    l2 = l * alpha + w.sum(dim=-1)
    acc = o * alpha[..., None] + torch.einsum("bikgj,bjkd->bikgd", w, v_blk.float())
    return acc / l2.clamp(min=1e-30)[..., None]


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor, layer_idx=None, *,
                    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
                    scale: float | None = None):
    """Decode attention over paged K/V for one layer -> (o, m, l), f32.

    q [B, nkv, g, hd] (head h of the flat layout is (h // g, h % g)); pools either one
    layer's [NB, BS, nkv, hd] or the stacked [L, NB, BS, nkv, hd] with ``layer_idx`` (an
    int), in q's dtype, bf16 (values read as they are), or int8 with ``k_scale`` /
    ``v_scale`` [(L,) NB, BS, nkv] f32;
    block_tables [B, MP] int (-1 = unmapped); lengths [B] tokens already in pages (the
    current token excluded). o is unnormalized: merge with ``merge_current_token`` (or a
    verify's folded tokens with ``merge_block_tokens``) or divide by l. The kernel takes
    hd = 64 or 128 and g <= ``KERNEL_MAX_GROUP`` query rows a KV head, each live page's K and V
    read once for all g rows; the stacked pool is read in place at the layer's offset,
    never sliced into a copy."""
    _check(q, k_pool, v_pool, block_tables, lengths, layer_idx, k_scale, v_scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables, lengths, layer_idx,
                                     k_scale=k_scale, v_scale=v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda (kernel) or cpu (plain), not {q.device}")
    b, nkv, g, hd = q.shape
    check_kernel_shape(hd, g)
    quantized = k_pool.dtype == torch.int8
    pools = [k_pool, v_pool] + ([k_scale, v_scale] if quantized else [])
    if not all(p.is_contiguous() for p in pools):
        raise ValueError("the pools (and scales) must be contiguous: they are read in place")
    layer = int(layer_idx) if k_pool.ndim == 5 else 0
    n_layers, nb, bs = (k_pool.shape[:3] if k_pool.ndim == 5 else (1, *k_pool.shape[:2]))
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} of a pool of {n_layers} layers")
    if b * nkv > TICKETS:
        raise ValueError(f"{b} x {nkv} (row, kv head) pairs exceed the {TICKETS} tickets")
    lib = _build.load_library()   # builds csrc/*.cu on first use
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    mp = tables.shape[1]
    pl = plan(b, nkv, g, hd, bs, mp,
              kernel_parts(b, nkv, mp, q.device, q.dtype, k_pool.dtype, g, hd))
    o = torch.empty((b, nkv, g, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, nkv, g), dtype=torch.float32, device=q.device)
    l = torch.empty((b, nkv, g), dtype=torch.float32, device=q.device)
    scratch = torch.empty(pl.floats, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        start = LAUNCHES.start(q.device)
        err = lib.af_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
            tables.data_ptr(), lens.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            scratch.data_ptr(), _tickets(q.device).data_ptr(), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_pool.dtype], b, nkv, g, hd, nb, bs, mp, layer, pl.parts, pl.floats,
            float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed with CUDA error {err}")
    LAUNCHES.record((b, nkv, g, hd, k_pool.dtype, mp), q.device, start,
                    (q, k_pool, v_pool, tables, lens, layer, k_scale, v_scale, float(scale)))
    return o, m, l
