"""Int8-QK flash attention (K8): the hand-written Hopper kernel, its prelude and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/flash_attention_a8.py``
(``flash_attention_a8`` :133, kernel body ``_a8_kernel`` :45). The CUDA source is
``csrc/flash_attention_a8.cu``; its header states the design and the bound.

The function, as JAX computes it (forward only, a serving prefill path):

- **Prelude** (``prelude``, torch ops, where JAX runs XLA): q and k/v padded to
  ``bq = min(block_q, ceil(Tq/128)*128)`` and ``bk = min(block_k, ceil(Tk/128)*128)``
  multiples; heads moved before time; the per-head K mean over the valid keys
  subtracted (padded keys kept at 0); q quantized per row and k with one scale per KV
  head (``max(amax, 1e-6) / 127``, round half to even, clip +-127); V cast to bf16; and
  ``rowc = (qs * ks) * scale`` per row.
- **Body** (K8 on the card, ``flash_attention_a8_reference`` anywhere): s = int32(q_i8 .
  k_i8^T) * rowc; keys past Tk, and under causal masking keys past row + q_offset, are
  masked; an online softmax whose running max advances once per ``bk``-key tile; p =
  exp(s - m) rounded to bf16 for P.V (f32 accumulation) while l sums the unrounded p;
  o = acc / max(l, 1e-30) in q's dtype. The tile matters: p is rounded against the
  running max of the tiles so far, so each call site passes JAX's ``block_k``.

A row with no visible key (a negative q_offset) gives o = 0, the port's convention
(ROADMAP Queue 3 item 5); the JAX kernel's value for such a row depends on its tiling.
GQA maps head i to KV head i // (H / Hkv). Dispatch is by device: a CUDA tensor goes to
K8 or raises, a CPU tensor to the plain version.
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

LAUNCHES = LaunchCounter()   # K8; key: (q shape, k shape, causal); inputs: (Prelude,)


@dataclass
class Prelude:
    """What the prelude hands the kernel body: int8 q [B*H, tq_pad, D] and k [B*Hkv,
    tk_pad, D], bf16 v [B*Hkv, tk_pad, D], f32 rowc [B*H, tq_pad], and the call's
    geometry. ``kv_len`` is the unpadded Tk, ``tq`` the unpadded Tq."""

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
    bq = min(block_q, -(-tq // TILE) * TILE)
    bk = min(block_k, -(-tk // TILE) * TILE)
    tq_pad = -(-tq // bq) * bq
    tk_pad = -(-tk // bk) * bk
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
                   out_dtype=q.dtype)


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
    v = pre.v.reshape(b, hkv, -1, d)[:, :, :nk].float()
    # |q_i8 . k_i8| <= 127^2 * D < 2^24: the f32 product is the exact int32 one
    s = torch.einsum("bkgqd,bksd->bkgqs", q, k)
    s = s * pre.rowc.reshape(b, hkv, g, -1)[:, :, :, r0:r1, None]
    keys = torch.arange(nk, device=s.device)
    visible = (keys < pre.kv_len)[None, :]
    if pre.causal:
        rows = torch.arange(r0, r1, device=s.device)[:, None] + pre.q_offset
        visible = visible & (keys[None, :] <= rows)
    s = s.masked_fill(~visible, float("-inf")).reshape(*s.shape[:-1], n_tiles, bk)
    m_run = torch.cummax(s.amax(dim=-1), dim=-1).values           # running max per tile
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
    """K8 on the prelude's CUDA tensors -> o [B, Tq, H, D] in the input dtype."""
    q_i8 = pre.q_i8
    if q_i8.device.type != "cuda":
        raise ValueError(f"flash_attention_a8's kernel runs on cuda, not {q_i8.device}")
    d = q_i8.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    lib = _build.load_library()   # builds csrc/*.cu on first use
    b, h, tq = pre.batch, pre.heads, pre.tq
    o = torch.empty((b, tq, h, d), dtype=pre.out_dtype, device=q_i8.device)
    with torch.cuda.device(q_i8.device):
        start = LAUNCHES.start(q_i8.device)
        stream = torch.cuda.current_stream(q_i8.device).cuda_stream
        err = lib.af_flash_attention_a8(
            q_i8.data_ptr(), pre.k_i8.data_ptr(), pre.v.data_ptr(), pre.rowc.data_ptr(),
            o.data_ptr(), _OUT_CODES[pre.out_dtype], b, h, pre.kv_heads, d, tq,
            q_i8.shape[1], pre.k_i8.shape[1], pre.kv_len, pre.bk, int(pre.causal),
            pre.q_offset, o.stride(0), o.stride(1), o.stride(2), stream)
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
    pre = prelude(q, k, v, causal=causal, scale=scale, q_offset=q_offset, block_q=block_q,
                  block_k=block_k)
    if q.device.type == "cpu":
        return flash_attention_a8_reference(pre)
    return flash_attention_a8_kernel(pre)

