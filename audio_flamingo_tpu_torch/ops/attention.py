"""Plain grouped-query attention and its masks.

The same function as ``audio_flamingo_tpu/ops/attention.gqa_attention``, in its order of
operations: scores and P.V accumulate in f32 with f32 output from operands in q's dtype
(JAX's ``preferred_element_type=f32``), the softmax runs in f32 and the probabilities are
rounded to q.dtype before P.V; KV heads are grouped by reshaping q, never repeated. Both
products are batched over (batch, KV head) (``bmm_f32``): bf16 on the card is multiplied
as it is, so a decode step reads the bf16 cache without an f32 copy (a batch of one row
reads it in place; more rows copy K and V once, head-major, in bf16); anything else, and
any product autograd must differentiate, is widened to f32 first, which is exact. Decode
attention and every non-flash path use it.

``gqa_attention_q8`` is JAX's attention over the dense int8 KV cache, in JAX's order of
operations: the codes are widened to q's dtype (exact for bf16) and multiplied with f32
accumulation and output (no f32 copy of a bf16 step's cache), each score column is scaled
by its token's k scale and then by the softmax scale, masked, softmaxed in f32, each
probability multiplied by its token's v scale and rounded to q's dtype before P.V.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _grouped_queries(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """q [b, q_len, nh, hd] -> [b * nkv, group * q_len, hd], each KV head's queries."""
    b, q_len, nh, hd = q.shape
    return q.reshape(b, q_len, nkv, nh // nkv, hd).permute(0, 2, 3, 1, 4).reshape(
        b * nkv, (nh // nkv) * q_len, hd)


def _grouped_output(out: torch.Tensor, b: int, nkv: int, q_len: int) -> torch.Tensor:
    """[b * nkv, group * q_len, hd] -> [b, q_len, nh, hd]."""
    hd = out.shape[-1]
    out = out.view(b, nkv, -1, q_len, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, q_len, -1, hd)


def _mask_scores(scores: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """scores [b, nkv, group, q_len, kv_len]; mask bool [b, 1|nh, q_len, kv_len]."""
    if mask is None:
        return scores
    if mask.ndim != 4:
        raise ValueError(f"mask must be rank-4, got {tuple(mask.shape)}")
    b, nkv, group, q_len, kv_len = scores.shape
    m = mask[:, :, None] if mask.shape[1] == 1 else mask.reshape(b, nkv, group, q_len, kv_len)
    return scores.masked_fill(~m, NEG_INF)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    """q [b, q_len, nh, hd], k/v [b, kv_len, nkv, hd]; mask bool [b, 1|nh, q_len, kv_len]
    (True = attend). Returns [b, q_len, nh, hd] in q.dtype."""
    b, q_len, nh, hd = q.shape
    kv_len, nkv = k.shape[1], k.shape[2]
    if nh % nkv:
        raise ValueError(f"num_heads {nh} is not a multiple of num_kv_heads {nkv}")
    if scale is None:
        scale = hd ** -0.5
    # [b * nkv, kv_len, hd] views of the cache's [b, kv_len, nkv, hd] (a copy if b > 1)
    kh, vh = (t.permute(0, 2, 1, 3).reshape(b * nkv, kv_len, hd) for t in (k, v))
    scores = bmm_f32(_grouped_queries(q, nkv), kh.transpose(1, 2))
    scores = _mask_scores(scores.view(b, nkv, nh // nkv, q_len, kv_len) * scale, mask)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = bmm_f32(probs.view(b * nkv, -1, kv_len), vh)
    return _grouped_output(out, b, nkv, q_len).to(q.dtype)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b -> f32 with f32 accumulation: bf16 operands on the card as they are
    (f32 output), anything else in f32. A product autograd must differentiate is widened
    too: the card's torch has no derivative for ``bmm(..., out_dtype=)``."""
    if (a.is_cuda and a.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad))):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def gqa_attention_q8(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                     mask: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    """q [b, q_len, nh, hd] over int8 k_q / v_q [b, kv_len, nkv, hd] with f32 per-token
    scales k_scale / v_scale [b, kv_len, nkv]; mask as ``gqa_attention``. Returns
    [b, q_len, nh, hd] in q.dtype."""
    b, q_len, nh, hd = q.shape
    kv_len, nkv = k_q.shape[1], k_q.shape[2]
    if nh % nkv:
        raise ValueError(f"num_heads {nh} is not a multiple of num_kv_heads {nkv}")
    if scale is None:
        scale = hd ** -0.5
    # [b * nkv, group * q_len, hd] queries against [b * nkv, kv_len, hd] widened codes
    k, v = (c.permute(0, 2, 1, 3).to(q.dtype, memory_format=torch.contiguous_format)
            .view(b * nkv, kv_len, hd) for c in (k_q, v_q))
    scores = bmm_f32(_grouped_queries(q, nkv), k.transpose(1, 2))
    scores = scores.view(b, nkv, nh // nkv, q_len, kv_len)
    scores = _mask_scores(scores * k_scale.transpose(1, 2)[:, :, None, None, :] * scale, mask)
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * v_scale.transpose(1, 2)[:, :, None, None, :]).to(q.dtype)
    out = bmm_f32(probs.view(b * nkv, -1, kv_len), v)
    return _grouped_output(out, b, nkv, q_len).to(q.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Bool [1, 1, q_len, kv_len]: query i (global index q_offset + i) sees keys <= it."""
    q_ids = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_ids = torch.arange(kv_len, device=device)[None, :]
    return (kv_ids <= q_ids)[None, None]
