"""Flash-attention forward: the hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/flash_attention.py``
(``_flash_forward`` :258, kernel ``_flash_kernel`` :63, reached from ``flash_attention``
and ``flash_attention_lse``). The CUDA source is ``csrc/flash_attention.cu``; its header
states the kernel's design, what bounds it on the H100 (bf16 tensor-core FLOPs at the
main-path shapes) and what the simple design leaves on the table.

Dispatch is by the tensors' device: a CPU tensor goes to ``flash_attention_reference``;
a CUDA tensor launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
KV_TILE = 64   # keys per K/V tile of the online softmax (csrc/flash_attention.cu kBK)


LAUNCHES = LaunchCounter()   # key: (q shape, k shape, causal); inputs: (q, k, v, kwargs)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected q [B,Tq,H,D], k/v [B,Tk,Hkv,D]; got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {k.shape}, {v.shape} do not match q {q.shape}")
    if tq == 0 or k.shape[2] == 0 or h % k.shape[2] != 0:
        raise ValueError(f"need Tq > 0 and H ({h}) a multiple of Hkv ({k.shape[2]})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v must share dtype float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, scale: float | None = None,
                              q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (o [B,Tq,H,D] in q.dtype, lse [B,Tq,H] f32).

    Scores and softmax statistics in f32. KV head of q head h is h // (H/Hkv); key j is
    visible to row i iff j <= i + q_offset under causal masking.

    The probabilities are rounded to q.dtype before P.V (exact for f32), as the JAX
    kernel's ``p.astype(q.dtype)``, while the row sum l adds the unrounded ones. Both
    kernels round p = exp(s - m) against the running max m of the online softmax, which
    grows tile by tile, so this version does too: p of a key in tile t (keys
    [64 t, 64 t + 64), the CUDA kernel's K/V tile) is rounded against the max over tiles
    0..t and then scaled by exp(m_t - m). The JAX kernel run with block_k=64 tiles its
    keys the same way.

    A row with no visible key (a negative q_offset, or Tk = 0) gives o = 0 and
    lse = -inf. The JAX kernel has no such fixed value: it masks with a finite NEG_INF,
    skips super-tiles past the causal frontier and pads Tk to tile multiples, so its
    output for such a row depends on its tiling. Code that merges or differentiates by
    the LSE (ring attention, the backward kernel) must treat -inf as "no keys".
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, tq, hkv, h // hkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + q_offset
        s = s.masked_fill(torch.arange(tk, device=q.device)[None, :] > rows, float("-inf"))
    n_tiles = -(-tk // KV_TILE)
    s = F.pad(s, (0, n_tiles * KV_TILE - tk), value=float("-inf"))
    s = s.reshape(*s.shape[:-1], n_tiles, KV_TILE)
    m_run = torch.cummax(s.amax(dim=-1), dim=-1).values      # [b, kv, g, q, tiles]
    m = m_run[..., -1:]
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    rescale = torch.exp(m_run - m)[..., None]                 # 0 before the first key
    m_run = torch.where(torch.isneginf(m_run), torch.zeros_like(m_run), m_run)
    p = torch.exp(s - m_run[..., None])                       # against the running max
    l = (p * rescale).sum(dim=(-2, -1))[..., None]            # [b, kv, g, q, 1]
    p = (p.to(q.dtype).float() * rescale).flatten(-2)[..., :tk]
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    l_q = l.permute(0, 3, 1, 2, 4)                            # [b, q, kv, g, 1]
    o = torch.where(l_q > 0, o / l_q, torch.zeros_like(o))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
    lse = lse[..., 0].permute(0, 3, 1, 2).reshape(b, tq, h)
    return o.reshape(b, tq, h, d).to(q.dtype), lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: float | None = None,
                        q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D] -> (o [B,Tq,H,D], lse [B,Tq,H] f32).

    f32 or bf16 inputs; the kernel takes head dims 64 and 128. The numerics, including
    the convention for a row with no visible key (o = 0, lse = -inf), are those of
    ``flash_attention_reference``."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu (reference), "
                         f"not {q.device}")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q/k/v must be contiguous in the head dim")
    lib = _build.load_library()   # builds csrc/*.cu on first use
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        start = LAUNCHES.start(q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.af_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, tq, tk, h, hkv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), int(bool(causal)), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    kw = dict(causal=bool(causal), scale=float(scale), q_offset=int(q_offset))
    LAUNCHES.record((tuple(q.shape), tuple(k.shape), kw["causal"]), q.device, start,
                    (q, k, v, kw))
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D] -> o [B,Tq,H,D]; see flash_attention_lse."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale, q_offset=q_offset)[0]
