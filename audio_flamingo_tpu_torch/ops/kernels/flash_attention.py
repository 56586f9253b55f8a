"""Flash attention: the hand-written Hopper kernels (forward K2, backward K7) and their
plain PyTorch versions.

Replaces the Pallas TPU kernels of ``audio_flamingo_tpu/ops/pallas/flash_attention.py``:
the forward ``_flash_forward`` :258 (kernel ``_flash_kernel`` :63) and the backward
``_flash_backward`` :431 (kernels ``_flash_bwd_dkv_kernel`` :343, ``_flash_bwd_dq_kernel``
:390), reached from ``flash_attention`` and ``flash_attention_lse``. The CUDA sources are
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` (building blocks shared in
``csrc/flash_mma.cuh``); their headers state each kernel's design, what bounds it on the
H100 and what the design leaves for later.

Each source has two routes, chosen by dtype: bf16 runs on the tensor cores (mma.sync
m16n8k16 with f32 accumulation, K/V or Q/dO tiles through a cp.async ring), f32 on the
CUDA cores (f32 FMAs). f32 stays off the tensor cores because TF32 would round q, k and p
to 10 mantissa bits, and the 2e-5 agreement of every f32 card-vs-CPU check rests on full
f32 products.

Both public functions are differentiable (a ``torch.autograd.Function``, as JAX's
``custom_vjp``): ``flash_attention`` in o, ``flash_attention_lse`` in o and the LSE.
Dispatch is by the tensors' device: a CPU tensor goes to the plain versions
(``flash_attention_reference``, ``flash_attention_backward_reference``); a CUDA tensor
launches the kernel of its dtype or raises. There is no fallback between them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
KV_TILE = 64   # keys per K/V tile of the online softmax (csrc/flash_attention.cu
               # kMmaKeys in bf16, kBK in f32)


LAUNCHES = LaunchCounter()       # K2; key: (q shape, k shape, causal); inputs: (q, k, v, kwargs)
BWD_LAUNCHES = LaunchCounter()   # K7; key and inputs: as LAUNCHES, inputs (q, k, v, o, lse, do, g_lse, kwargs)


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
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return reference_from_scores(reference_scores(q, k) * scale, v, causal=causal,
                                 q_offset=q_offset, dtype=q.dtype)


def reference_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The plain version's f32 scores q . k before the scale, [B, Hkv, H/Hkv, Tq, Tk]
    (q head h = Hkv index * H/Hkv + group index)."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, tq, hkv, h // hkv, d)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())


def reference_from_scores(s: torch.Tensor, v: torch.Tensor, *, causal: bool, q_offset: int,
                          dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_reference``'s steps after its score product, on the scaled f32
    scores s [B, Hkv, H/Hkv, Tq, Tk]: (o [B,Tq,H,D] in ``dtype``, lse [B,Tq,H] f32)."""
    b, hkv, g, tq, tk = s.shape
    d = v.shape[-1]
    h = hkv * g
    if causal:
        rows = torch.arange(tq, device=s.device)[:, None] + q_offset
        s = s.masked_fill(torch.arange(tk, device=s.device)[None, :] > rows, float("-inf"))
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
    p = (p.to(dtype).float() * rescale).flatten(-2)[..., :tk]
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    l_q = l.permute(0, 3, 1, 2, 4)                            # [b, q, kv, g, 1]
    o = torch.where(l_q > 0, o / l_q, torch.zeros_like(o))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
    lse = lse[..., 0].permute(0, 3, 1, 2).reshape(b, tq, h)
    return o.reshape(b, tq, h, d).to(dtype), lse


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
        do: torch.Tensor, g_lse: torch.Tensor | None = None, *, causal: bool, scale: float,
        q_offset: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in the input dtype.

    The JAX ``_flash_backward`` (flash_attention.py:431-527) step for step: dO rounded
    to the input dtype; delta = sum(dO * O) in f32, shifted by the LSE cotangent
    (delta - g_lse); p = exp(s * scale - lse) with p = 0 for causal pairs past the
    frontier; pc = p in the input dtype feeds dV, ds = p (dp - delta) in the input dtype
    feeds dK and dQ (times scale); products accumulate in f32, and dK and dV are summed
    over each KV head's group of query heads in f32 before the cast. A row with no
    visible key (lse = -inf, the forward's convention) gets p = 0, so zero gradient:
    exp(s - lse) is never formed for it."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dtype = q.dtype
    do = do.to(dtype)
    delta = (do.float() * o.float()).sum(dim=-1)                  # [b, q, h]
    if g_lse is not None:
        delta = delta - g_lse.float()
    qg = q.float().reshape(b, tq, hkv, g, d)
    dog = do.float().reshape(b, tq, hkv, g, d)
    s = reference_scores(q, k) * scale
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + q_offset
        s = s.masked_fill(torch.arange(tk, device=q.device)[None, :] > rows, float("-inf"))
    lse_g = lse.float().reshape(b, tq, hkv, g).permute(0, 2, 3, 1)[..., None]
    lse_g = torch.where(torch.isneginf(lse_g), torch.full_like(lse_g, float("inf")), lse_g)
    p = torch.exp(s - lse_g)                                      # [b, kv, g, q, s]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(dtype).float(), dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    delta_g = delta.reshape(b, tq, hkv, g).permute(0, 2, 3, 1)[..., None]
    ds = (p * (dp - delta_g)).to(dtype).float()
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    return dq.reshape(b, tq, h, d).to(dtype), dk.to(dtype), dv.to(dtype)


def _device_check(q: torch.Tensor, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda (kernel) or cpu (reference), not {q.device}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")


def _rows_aligned(x: torch.Tensor) -> bool:
    """Every row starts 16-byte aligned, as the bf16 kernels' cp.async copies need."""
    return x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])


def score_sums(q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward's two score sums of every (q row, key) pair, before the scale:
    (s_mma, s_seq), [B, H, Tq, Tk] f32 each, laid out as ``reference_scores``' [B, Hkv,
    H/Hkv, Tq, Tk]. s_mma is the tensor-core product K2 forms for every score; s_seq the
    sum by one fmaf per element in order d = 0 .. D - 1 by which it recomputes the scores
    that set the running max or sit near a rounding edge of p. Not on any path: K2's bf16
    tolerance rests on s_seq equal to the plain version's scores and s_mma within its
    err_bound of them, and this lets a check on the card hold both. bf16 q [B,Tq,H,D] and
    k [B,Tk,Hkv,D] with rows 16-byte aligned, on the card; on a CPU tensor both are the
    plain sequential sum (a bf16 product is exact in f32, so it is the fmaf chain)."""
    _check(q, k, k)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"score_sums takes bfloat16 q/k, got {q.dtype}")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        qh = q.float().permute(0, 2, 1, 3)                                    # [B, H, Tq, D]
        kh = k.float().repeat_interleave(h // hkv, dim=2).permute(0, 2, 1, 3)
        s = torch.zeros((b, h, tq, tk))
        for i in range(d):
            s = s + qh[..., i:i + 1] * kh[..., None, :, i]
        return s, s.clone()
    _device_check(q, "score_sums")
    if not (_rows_aligned(q) and _rows_aligned(k)) or q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("q/k rows must be contiguous and start 16-byte aligned")
    lib = _build.load_library()
    s_mma = torch.empty((b, h, tq, tk), dtype=torch.float32, device=q.device)
    s_seq = torch.empty_like(s_mma)
    with torch.cuda.device(q.device):
        err = lib.af_flash_scores(q.data_ptr(), k.data_ptr(), s_mma.data_ptr(),
                                  s_seq.data_ptr(), b, tq, tk, h, hkv, d,
                                  *q.stride()[:3], *k.stride()[:3],
                                  torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash score-sums kernel launch failed with CUDA error {err}")
    return s_mma, s_seq


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
             q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 on a CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         q_offset=q_offset)
    _device_check(q, "flash_attention")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q/k/v must be contiguous in the head dim")
    if q.dtype == torch.bfloat16 and not all(map(_rows_aligned, (q, k, v))):
        raise ValueError("bf16 q/k/v rows must start 16-byte aligned")
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


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             g_lse: torch.Tensor | None = None, *, causal: bool,
                             scale: float, q_offset: int
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the forward's (o, lse) under the cotangents do (and g_lse, the
    LSE's, or None): K7 on a CUDA tensor, ``flash_attention_backward_reference`` on a
    CPU one. delta = sum(dO * O) - g_lse is formed here with torch ops in f32, as JAX
    forms it in XLA outside its kernels; K7 does the rest in two launches."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, g_lse, causal=causal,
                                                  scale=scale, q_offset=q_offset)
    _device_check(q, "flash_attention backward")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    do = do.to(q.dtype)
    # an expanded cotangent (the grad of a sum) has stride 0
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not _rows_aligned(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q/k/v must be contiguous in the head dim")
    if q.dtype == torch.bfloat16 and not all(map(_rows_aligned, (q, k, v))):
        raise ValueError("bf16 q/k/v rows must start 16-byte aligned")
    delta = (do.float() * o.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    lse = lse.contiguous()
    lib = _build.load_library()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, tk, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, hkv, d), dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        start = BWD_LAUNCHES.start(q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.af_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], b, tq, tk, h, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(scale), int(bool(causal)), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed with CUDA "
                           f"error {err}")
    kw = dict(causal=bool(causal), scale=float(scale), q_offset=int(q_offset))
    BWD_LAUNCHES.record((tuple(q.shape), tuple(k.shape), kw["causal"]), q.device, start,
                        (q, k, v, o, lse, do, g_lse, kw))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(o, lse) = flash(q, k, v); the backward takes the cotangents of both outputs
    (either may be None: a caller that uses only o passes no LSE cotangent)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        o, lse = _forward(q, k, v, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, g_lse, **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: float | None = None,
                        q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D] -> (o [B,Tq,H,D], lse [B,Tq,H] f32).

    f32 or bf16 inputs; the kernels take head dims 64 and 128. The numerics, including
    the convention for a row with no visible key (o = 0, lse = -inf, zero gradient), are
    those of the plain versions. Differentiable in both outputs."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale), int(q_offset))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D] -> o [B,Tq,H,D]; see flash_attention_lse."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale, q_offset=q_offset)[0]
