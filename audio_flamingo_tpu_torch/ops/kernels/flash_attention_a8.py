"""Int8-QK flash attention (K8): the hand-written Hopper kernels (the prelude and the
body), and their plain PyTorch versions.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/flash_attention_a8.py``
(``flash_attention_a8`` :133, kernel body ``_a8_kernel`` :45) and the XLA prelude JAX runs
before it. The CUDA source is ``csrc/flash_attention_a8.cu``; its header states the
design and the bound.

The function, as JAX computes it (forward only, a serving prefill path):

- **Prelude**: q and k/v padded to ``bq = min(block_q, ceil(Tq/128)*128)`` and ``bk =
  min(block_k, ceil(Tk/128)*128)`` multiples; heads moved before time; the per-head K
  mean over the valid keys subtracted (padded keys kept at 0); q quantized per row and k
  with one scale per KV head (``max(amax, 1e-6) / 127``, round half to even, clip
  +-127); V cast to bf16; and ``rowc = (qs * ks) * scale`` per row. ``prelude`` is the
  plain version (torch ops, in JAX's order); on the card ``prelude_kernel`` runs it as
  three CUDA launches that read q, k and v in place through their strides (no f32
  copies, transposes or pads), with fixed-order sums for the K mean, and leaves a bf16 v
  where it is (an f32 v gets a bf16 copy from the third launch). ``plan`` is its
  host-side geometry, a pure function.
- **Body** (K8 on the card, ``flash_attention_a8_reference`` anywhere): s = int32(q_i8 .
  k_i8^T) * rowc; keys past Tk, and under causal masking keys past row + q_offset, are
  masked; an online softmax whose running max advances once per ``bk``-key tile; p =
  exp(s - m) rounded to bf16 for P.V (f32 accumulation) while l sums the unrounded p;
  o = acc / max(l, 1e-30) in q's dtype. The tile matters: p is rounded against the
  running max of the tiles so far, so each call site passes JAX's ``block_k``. The tile
  maximum is taken on the exact integer scores (``tile_max``): rounding is monotone, so
  it equals the maximum of the rounded scores, and the kernel uses the same rule.

A row with no visible key (a negative q_offset) gives o = 0, the port's convention
(ROADMAP Queue 3 item 5); the JAX kernel's value for such a row depends on its tiling.
GQA maps head i to KV head i // (H / Hkv). Dispatch is by device: a CUDA tensor goes to
the CUDA prelude and K8 or raises, a CPU tensor to the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter
from audio_flamingo_tpu_torch.ops.quant import div127

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
TILE = 128              # JAX's padding unit for bq and bk
BLOCK_ROWS = 64         # query rows per body block (csrc kRows)
CHUNK_KEYS = 64         # keys per body chunk (kKeys)
RING_STAGES = 4         # K and V ring slots (kStages)
PRELUDE_KEYS = 256      # keys per partial-sum block of the prelude (kPreKeys)
CODE_ROWS = 64          # k rows per code block (kCodeRows)
Q_ROWS = 8              # q rows per code block (kQRows)

LAUNCHES = LaunchCounter()           # K8's body; key: (q shape, k shape, causal); inputs:
                                     # (Prelude,)
PRELUDE_LAUNCHES = LaunchCounter()   # the CUDA prelude (three kernels a call); key: (q shape,
                                     # k shape); inputs: (q, k, v, keyword arguments)


@dataclass
class Prelude:
    """What the prelude hands the kernel body: int8 q [B*H, tq_pad, D] and k [B*Hkv,
    tk_pad, D], bf16 v, f32 rowc [B*H, tq_pad], the scales qs [B*H, tq_pad] and ks
    [B*Hkv], and the call's geometry. ``kv_len`` is the unpadded Tk, ``tq`` the unpadded
    Tq. v is [B*Hkv, tk_pad, D] from ``prelude`` and [B, Tk, Hkv, D] (the caller's own
    tensor, or a bf16 copy of an f32 one) from ``prelude_kernel``; ``v_bthd`` views either
    as [B, T, Hkv, D]. Keys at or past kv_len are never used."""

    q_i8: torch.Tensor
    k_i8: torch.Tensor
    v: torch.Tensor
    rowc: torch.Tensor
    batch: int
    heads: int
    kv_heads: int
    tq: int
    kv_len: int
    bk: int
    causal: bool
    q_offset: int
    out_dtype: torch.dtype
    qs: torch.Tensor | None = None
    ks: torch.Tensor | None = None

    def v_bthd(self) -> torch.Tensor:
        if self.v.ndim == 4:
            return self.v
        d = self.v.shape[-1]
        return self.v.reshape(self.batch, self.kv_heads, -1, d).transpose(1, 2)


@dataclass(frozen=True)
class Plan:
    """The CUDA prelude's and the body's host-side geometry for one call: JAX's padded
    sizes, the partial-sum chunks, each launch's grid, the strides (elements) at which the
    kernels read q, k and v, and the body's dynamic shared memory."""

    bq: int
    bk: int
    tq_pad: int
    tk_pad: int
    nchunk: int
    q_strides: tuple
    k_strides: tuple
    v_strides: tuple
    stats_grid: tuple       # launches 1 and 2: (nchunk, B*Hkv)
    codes_blocks: tuple     # launch 3: (q blocks, k blocks)
    body_grid: tuple        # (H / Hkv, B*Hkv, ceil(Tq / 64))
    body_smem: int


def body_smem_bytes(d: int) -> int:
    """The body's dynamic shared memory: the V ring (rows padded by 16 bytes) and the K
    ring (int8 rows padded by 16 bytes)."""
    return RING_STAGES * CHUNK_KEYS * ((d + 8) * 2 + d + 16)


def padded_blocks(tq: int, tk: int, block_q: int, block_k: int) -> tuple:
    """JAX's (bq, bk, tq_pad, tk_pad)."""
    bq = min(block_q, -(-tq // TILE) * TILE)
    bk = min(block_k, -(-tk // TILE) * TILE)
    return bq, bk, -(-tq // bq) * bq, -(-tk // bk) * bk


def plan(q_shape, q_strides, k_shape, k_strides, v_shape, v_strides, *, block_q: int = 512,
         block_k: int = 1024) -> Plan:
    """The geometry of one call on the card from the shapes and strides (elements) of q
    [B, Tq, H, D] and k, v [B, Tk, Hkv, D]; raises ValueError on what the kernels do not
    take (a head dim other than 64 or 128, a last dim that is not contiguous)."""
    b, tq, h, d = q_shape
    tk, hkv = k_shape[1], k_shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims {KERNEL_HEAD_DIMS}, got {d}")
    if q_strides[3] != 1 or k_strides[3] != 1 or v_strides[3] != 1:
        raise ValueError(f"q, k and v need a contiguous last dim; strides {q_strides}, "
                         f"{k_strides}, {v_strides}")
    bq, bk, tq_pad, tk_pad = padded_blocks(tq, tk, block_q, block_k)
    if b * hkv > 65535 or -(-tq // BLOCK_ROWS) > 65535:
        raise ValueError(f"grid too large for q {tuple(q_shape)}, k {tuple(k_shape)}")
    nchunk = -(-tk // PRELUDE_KEYS)
    return Plan(bq=bq, bk=bk, tq_pad=tq_pad, tk_pad=tk_pad, nchunk=nchunk,
                q_strides=tuple(q_strides[:3]), k_strides=tuple(k_strides[:3]),
                v_strides=tuple(v_strides[:3]), stats_grid=(nchunk, b * hkv),
                codes_blocks=(-(-b * h * tq_pad // Q_ROWS), b * hkv * (tk_pad // CODE_ROWS)),
                body_grid=(h // hkv, b * hkv, -(-tq // BLOCK_ROWS)),
                body_smem=body_smem_bytes(d))


def _rows_in_16_bytes(v: torch.Tensor) -> bool:
    """A [B, T, Hkv, D] bf16 tensor whose rows the body can copy 16 bytes at a time."""
    return (v.stride(3) == 1 and v.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in v.stride()[:3]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected q [B,Tq,H,D], k/v [B,Tk,Hkv,D]; got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {k.shape}, {v.shape} do not match q {q.shape}")
    if tq == 0 or k.shape[1] == 0 or k.shape[2] == 0 or h % k.shape[2] != 0:
        raise ValueError(f"need Tq, Tk > 0 and H ({h}) a multiple of Hkv ({k.shape[2]})")
    if q.dtype not in _OUT_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")


def prelude(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
            scale: float | None = None, q_offset: int = 0, block_q: int = 512,
            block_k: int = 1024) -> Prelude:
    """JAX ``flash_attention_a8`` :139-189 in torch ops, in its order of operations."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    _, bk, tq_pad, tk_pad = padded_blocks(tq, tk, block_q, block_k)
    qh = F.pad(q.float().transpose(1, 2), (0, 0, 0, tq_pad - tq)).reshape(b * h, tq_pad, d)
    kh = F.pad(k.float().transpose(1, 2), (0, 0, 0, tk_pad - tk)).reshape(b * hkv, tk_pad, d)
    vh = F.pad(v.transpose(1, 2), (0, 0, 0, tk_pad - tk)).reshape(b * hkv, tk_pad, d)
    vh = vh.to(torch.bfloat16).contiguous()
    # K smoothing: the per-head mean over the valid keys is a per-row constant of q . k,
    # so the softmax does not see it; padded keys stay at zero
    kh = kh - kh[:, :tk].mean(dim=1, keepdim=True)
    if tk_pad != tk:
        kh[:, tk:] = 0.0
    qs = div127(torch.clamp(qh.abs().amax(dim=-1), min=1e-6))                 # [B*H, tq_pad]
    q_i8 = torch.clamp(torch.round(qh / qs[..., None]), -127, 127).to(torch.int8)
    ks = div127(torch.clamp(kh.abs().amax(dim=(1, 2)), min=1e-6))             # [B*Hkv]
    k_i8 = torch.clamp(torch.round(kh / ks[:, None, None]), -127, 127).to(torch.int8)
    ks_h = ks.reshape(b, hkv, 1).repeat_interleave(g, dim=1)                  # [B, H, 1]
    rowc = (qs.reshape(b, h, tq_pad) * ks_h * scale).reshape(b * h, tq_pad)
    return Prelude(q_i8=q_i8.contiguous(), k_i8=k_i8.contiguous(), v=vh,
                   rowc=rowc.contiguous(), batch=b, heads=h, kv_heads=hkv, tq=tq,
                   kv_len=tk, bk=bk, causal=bool(causal), q_offset=int(q_offset),
                   out_dtype=q.dtype, qs=qs, ks=ks)


def prelude_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: float | None = None, q_offset: int = 0,
                   block_q: int = 512, block_k: int = 1024) -> Prelude:
    """The prelude on the card: three CUDA launches (``csrc/flash_attention_a8.cu``,
    ``af_fa8_prelude``) that read q, k and v in place. Same outputs as ``prelude`` up to
    the K mean's order of summation: q's codes, qs and rowc's q factor equal; ks within
    an ulp or two, k's codes at most 1 apart where the mean moves a value across a
    rounding edge. A bf16 v is handed to the body as it is; an f32 v as a bf16 copy."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_a8's prelude kernel runs on cuda, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"the CUDA prelude takes q, k and v of one dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if v.dtype == torch.bfloat16 and not _rows_in_16_bytes(v):
        v = v.contiguous()   # the body reads bf16 rows 16 bytes at a time
    pl = plan(q.shape, q.stride(), k.shape, k.stride(), v.shape, v.stride(),
              block_q=block_q, block_k=block_k)
    dev = q.device
    q_i8 = torch.empty((b * h, pl.tq_pad, d), dtype=torch.int8, device=dev)
    k_i8 = torch.empty((b * hkv, pl.tk_pad, d), dtype=torch.int8, device=dev)
    rowc = torch.empty((b * h, pl.tq_pad), dtype=torch.float32, device=dev)
    qs = torch.empty_like(rowc)
    ks = torch.empty((b * hkv,), dtype=torch.float32, device=dev)
    n_sum = b * hkv * pl.nchunk * d
    scratch = torch.empty((n_sum + b * hkv * (pl.nchunk + d),), dtype=torch.float32,
                          device=dev)
    ksum, kmax, kmean = (scratch[:n_sum], scratch[n_sum: n_sum + b * hkv * pl.nchunk],
                         scratch[n_sum + b * hkv * pl.nchunk:])
    # an f32 v gets its bf16 copy from the third launch; a bf16 v is read in place
    v16 = (None if v.dtype == torch.bfloat16
           else torch.empty((b, tk, hkv, d), dtype=torch.bfloat16, device=dev))
    lib = _build.load_library()   # builds csrc/*.cu on first use
    with torch.cuda.device(dev):
        start = PRELUDE_LAUNCHES.start(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.af_fa8_prelude(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_i8.data_ptr(), k_i8.data_ptr(),
            0 if v16 is None else v16.data_ptr(),
            rowc.data_ptr(), qs.data_ptr(), ks.data_ptr(), ksum.data_ptr(), kmax.data_ptr(),
            kmean.data_ptr(), _OUT_CODES[q.dtype], b, tq, h, hkv, d, tk, pl.tq_pad,
            pl.tk_pad, pl.nchunk, *pl.q_strides, *pl.k_strides, *pl.v_strides, float(scale),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_a8 prelude launch failed with CUDA error {err}")
    PRELUDE_LAUNCHES.record(((b, tq, h, d), (b, tk, hkv, d)), dev, start,
                            (q, k, v, dict(causal=causal, scale=scale, q_offset=q_offset,
                                           block_q=block_q, block_k=block_k)))
    return Prelude(q_i8=q_i8, k_i8=k_i8, v=v if v16 is None else v16, rowc=rowc,
                   batch=b, heads=h, kv_heads=hkv, tq=tq, kv_len=tk, bk=pl.bk,
                   causal=bool(causal), q_offset=int(q_offset), out_dtype=q.dtype, qs=qs,
                   ks=ks)


def tile_max(s_int: torch.Tensor, rowc: torch.Tensor, visible: torch.Tensor,
             n_tiles: int) -> torch.Tensor:
    """Each row's maximum of the scores float(s) * rowc over the visible keys of each
    bk-key tile, taken on the exact integer scores ``s_int`` (f32 holding integers, |s| <
    2^24): rounding is monotone, so it is float(max s) * rowc for rowc >= 0 and float(min
    s) * rowc for rowc < 0, the maximum of the rounded scores bit for bit; -inf for a tile
    with no visible key. s_int [..., rows, keys], rowc [..., rows] -> [..., rows, n_tiles]."""
    neg = (rowc < 0)[..., None]
    t = torch.where(neg, -s_int, s_int).masked_fill(~visible, float("-inf"))
    ext = t.reshape(*t.shape[:-1], n_tiles, -1).amax(dim=-1)
    ext = torch.where(neg, -ext, ext)
    return torch.where(torch.isinf(ext), torch.full_like(ext, float("-inf")),
                       ext * rowc[..., None])


def _body_rows(pre: Prelude, r0: int, r1: int) -> torch.Tensor:
    """The body for padded query rows [r0, r1) of every head -> [B, H, r1 - r0, D] f32."""
    b, h, hkv = pre.batch, pre.heads, pre.kv_heads
    g = h // hkv
    d = pre.q_i8.shape[-1]
    bk = pre.bk
    n_tiles = -(-pre.kv_len // bk)
    nk = n_tiles * bk
    q = pre.q_i8.reshape(b, hkv, g, -1, d)[:, :, :, r0:r1].float()
    k = pre.k_i8.reshape(b, hkv, -1, d)[:, :, :nk].float()
    v = pre.v_bthd()[:, : pre.kv_len].transpose(1, 2).float()
    v = F.pad(v, (0, 0, 0, nk - pre.kv_len))      # keys past kv_len are never visible
    # |q_i8 . k_i8| <= 127^2 * D < 2^24: the f32 product is the exact int32 one
    s_int = torch.einsum("bkgqd,bksd->bkgqs", q, k)
    rowc = pre.rowc.reshape(b, hkv, g, -1)[:, :, :, r0:r1]
    keys = torch.arange(nk, device=s_int.device)
    visible = (keys < pre.kv_len)[None, :]
    if pre.causal:
        rows = torch.arange(r0, r1, device=s_int.device)[:, None] + pre.q_offset
        visible = visible & (keys[None, :] <= rows)
    m_run = torch.cummax(tile_max(s_int, rowc, visible, n_tiles), dim=-1).values
    s = (s_int * rowc[..., None]).masked_fill(~visible, float("-inf"))
    s = s.reshape(*s.shape[:-1], n_tiles, bk)
    m = m_run[..., -1:]
    rescale = torch.exp(m_run - torch.where(torch.isneginf(m), torch.zeros_like(m), m))
    m_run = torch.where(torch.isneginf(m_run), torch.zeros_like(m_run), m_run)
    p = torch.exp(s - m_run[..., None])                            # against the running max
    l = (p.sum(dim=-1) * rescale).sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqts,bktsd->bkgqtd", p.to(torch.bfloat16).float(),
                      v.reshape(b, hkv, n_tiles, bk, d))
    acc = (pv * rescale[..., None]).sum(dim=-2)
    o = acc / torch.clamp(l, min=1e-30)
    return o.reshape(b, h, r1 - r0, d)


def flash_attention_a8_reference(pre: Prelude, max_elems: int = 1 << 27) -> torch.Tensor:
    """Plain PyTorch version of the kernel body on the prelude's outputs -> o [B, Tq, H,
    D] in the input dtype. Evaluated over blocks of query rows so that the scores of one
    block hold about ``max_elems`` elements (rows are independent)."""
    b, h = pre.batch, pre.heads
    nk = -(-pre.kv_len // pre.bk) * pre.bk
    rows = max(1, min(pre.tq, max_elems // max(1, b * h * nk)))
    parts = [_body_rows(pre, r0, min(r0 + rows, pre.tq)) for r0 in range(0, pre.tq, rows)]
    return torch.cat(parts, dim=2).transpose(1, 2).to(pre.out_dtype)


def flash_attention_a8_kernel(pre: Prelude) -> torch.Tensor:
    """K8 on the prelude's CUDA tensors (from either prelude) -> o [B, Tq, H, D] in the
    input dtype."""
    q_i8 = pre.q_i8
    if q_i8.device.type != "cuda":
        raise ValueError(f"flash_attention_a8's kernel runs on cuda, not {q_i8.device}")
    d = q_i8.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    v = pre.v_bthd()
    if v.dtype != torch.bfloat16 or not _rows_in_16_bytes(v):
        raise ValueError("the kernel reads a bf16 v whose rows start 16-byte aligned")
    lib = _build.load_library()   # builds csrc/*.cu on first use
    b, h, tq = pre.batch, pre.heads, pre.tq
    o = torch.empty((b, tq, h, d), dtype=pre.out_dtype, device=q_i8.device)
    with torch.cuda.device(q_i8.device):
        start = LAUNCHES.start(q_i8.device)
        stream = torch.cuda.current_stream(q_i8.device).cuda_stream
        err = lib.af_flash_attention_a8(
            q_i8.data_ptr(), pre.k_i8.data_ptr(), v.data_ptr(), pre.rowc.data_ptr(),
            o.data_ptr(), _OUT_CODES[pre.out_dtype], b, h, pre.kv_heads, d, tq,
            q_i8.shape[1], pre.k_i8.shape[1], pre.kv_len, pre.bk, int(pre.causal),
            pre.q_offset, o.stride(0), o.stride(1), o.stride(2), v.stride(0), v.stride(1),
            v.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_a8 kernel launch failed with CUDA error {err}")
    LAUNCHES.record(((b, tq, h, d), (b, pre.kv_len, pre.kv_heads, d), pre.causal),
                    q_i8.device, start, (pre,))
    return o


def flash_attention_a8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False, scale: float | None = None, q_offset: int = 0,
                       block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D] float -> [B,Tq,H,D] in q.dtype (JAX's defaults for
    block_q and block_k; each call site passes what JAX's does). Forward only."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, block_q=block_q,
              block_k=block_k)
    if q.device.type == "cpu":
        return flash_attention_a8_reference(prelude(q, k, v, **kw))
    return flash_attention_a8_kernel(prelude_kernel(q, k, v, **kw))
